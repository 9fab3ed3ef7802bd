"""Stable compaction (gaussianformer_tpu/ops/compaction.py)."""
import torch


def valid_first_order(mask):
    """Indices of a 1-D bool ``mask`` with its True entries first, in
    stable order: the first ``mask.sum()`` entries are what
    ``compact_indices`` returns in the JAX package."""
    return torch.argsort((~mask).to(torch.uint8), stable=True)
