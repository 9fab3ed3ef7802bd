"""Loss composition (gaussianformer_tpu/losses/multi_loss.py): each term
reads its inputs from the model's output dict by key and is weighted; the
total and the per-term values are returned."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LossTerm:
    name: str
    weight: float
    fn: Callable[..., torch.Tensor]
    input_keys: Tuple[str, ...]


class MultiLoss:
    def __init__(self, terms: Sequence[LossTerm]):
        self.terms = list(terms)

    def __call__(self, inputs: Dict) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
        tot = 0.0
        log = {}
        for term in self.terms:
            val = term.weight * term.fn(*[inputs[k] for k in
                                          term.input_keys])
            tot = tot + val
            log[term.name] = val
        return tot, log
