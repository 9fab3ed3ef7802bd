"""Lovász-softmax loss over present classes with masked ignore
(gaussianformer_tpu/losses/lovasz.py, the Berman formulation of the
reference's loss/utils/lovasz_softmax.py).

Ignored voxels are masked, not removed: they get fg = 0 and error = 0, so
they sort behind every positive error and add nothing. The gradient is
plain autograd through the sort: the Jaccard-gradient vector depends on
the labels only, so autograd of ``dot(sorted errors, grad)`` gives
``-sign(fg - p) grad[rank] / #present``, the JAX package's analytic VJP.
"""
from __future__ import annotations

import torch


def lovasz_softmax(probas, labels, valid=None):
    """probas [N, C] probabilities; labels [N] int; valid [N] bool.
    Returns the mean over present classes of the per-class Lovász loss."""
    n, c = probas.shape
    validf = (torch.ones(n, dtype=probas.dtype, device=probas.device)
              if valid is None else valid.to(probas.dtype))
    cls = torch.arange(c, device=probas.device)
    fgs = (labels[None, :] == cls[:, None]).to(probas.dtype) \
        * validf[None, :]                                    # [C, N]
    errors = (fgs - probas.T).abs() * validf[None, :]
    order = torch.sort(-errors.detach(), dim=1, stable=True).indices
    err_s = torch.gather(errors, 1, order)
    fg_s = torch.gather(fgs, 1, order)
    valid_s = torch.gather(validf[None, :].expand(c, n), 1, order)
    gts = fg_s.sum(1, keepdim=True)
    intersection = gts - fg_s.cumsum(1)
    union = gts + (valid_s - fg_s).cumsum(1)
    jaccard = 1.0 - intersection / union.clamp_min(1e-12)
    grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], 1)
    losses = (err_s * grad).sum(1)
    present = gts[:, 0] > 0
    num_present = present.sum().clamp_min(1)
    return torch.where(present, losses, torch.zeros_like(losses)).sum() \
        / num_present
