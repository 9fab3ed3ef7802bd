"""Numerically clamped sigmoid / logit (gaussianformer_tpu/ops/safe_ops.py):
sigmoid input clamped to +-9.21, logit input to [1e-4, 0.9999]."""
import torch

SIGMOID_CLAMP = 9.21
LOGIT_MAX = 0.9999


def safe_sigmoid(x):
    return torch.sigmoid(x.clamp(-SIGMOID_CLAMP, SIGMOID_CLAMP))


def safe_inverse_sigmoid(x):
    x = x.clamp(1.0 - LOGIT_MAX, LOGIT_MAX)
    return torch.log(x / (1.0 - x))
