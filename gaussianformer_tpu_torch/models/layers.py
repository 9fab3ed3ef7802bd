"""Shared small layers (reference linear_relu_ln, mmcv Scale)."""
from __future__ import annotations

import torch
from torch import nn


def linear_relu_ln(embed_dims: int, in_loops: int, out_loops: int,
                   input_dims: int | None = None) -> nn.Sequential:
    """[Linear -> ReLU] * in_loops then LayerNorm, out_loops times; module
    indices match the reference Sequential."""
    input_dims = input_dims or embed_dims
    layers = []
    for _ in range(out_loops):
        for _ in range(in_loops):
            layers += [nn.Linear(input_dims, embed_dims), nn.ReLU()]
            input_dims = embed_dims
        layers.append(nn.LayerNorm(embed_dims))
    return nn.Sequential(*layers)


class Scale(nn.Module):
    """Learnable per-channel scale, init 1.0 (mmcv.cnn.Scale)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.scale
