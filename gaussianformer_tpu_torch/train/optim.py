"""Optimizer and schedule (gaussianformer_tpu/train/optim.py): AdamW
(b1 0.9, b2 0.999, eps 1e-8, weight decay on every trained parameter) in
two lr groups, the image backbone at ``backbone_lr_mult`` and the rest;
``optax.warmup_cosine_decay_schedule`` reproduced, or the step decay of
:func:`multistep_schedule`; frozen parameters left out of the optimizer;
gradient accumulation with ``optax.MultiSteps``' semantics
(:class:`GradientAccumulation`).

Frozen parameters keep ``requires_grad``: the JAX train step computes
gradients for every parameter, and its ``clip_by_global_norm`` and logged
``grad_norm`` read all of them (train/step.py applies both).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

# frozen_stages=1 (reference backbone config): stem + stage 1
FROZEN_BACKBONE = ("img_backbone.conv1", "img_backbone.bn1",
                   "img_backbone.layer1")
# freeze_lifter (the prob configs) keeps random_anchors trainable
# (reference bev_segmentor.py:40-46); the v1 configs do not set it, so
# their lifter's anchor bank and instance features train
FROZEN_LIFTER = ("lifter.initialize_backbone", "lifter.projection",
                 "lifter.anchor", "lifter.instance_feature")
BACKBONE = "img_backbone"
# the schedule's first lr (the JAX package's warm-up start)
WARMUP_INIT = 1e-6


def cosine_warmup_schedule(base_lr: float, total_steps: int,
                           warmup_steps: int = 500,
                           min_lr_ratio: float = 0.1) -> Callable[[int],
                                                                  float]:
    """``optax.warmup_cosine_decay_schedule(WARMUP_INIT, base_lr,
    warmup_steps, max(total_steps, warmup_steps + 1), base_lr *
    min_lr_ratio)``: linear from ``WARMUP_INIT`` to ``base_lr`` over
    ``warmup_steps``, then cosine down to ``base_lr * min_lr_ratio``.
    Step t (from 0) of the optimizer uses schedule(t)."""
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    end = base_lr * min_lr_ratio
    alpha = end / base_lr if base_lr else 0.0

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return (WARMUP_INIT - base_lr) * frac + base_lr
        count = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def multistep_schedule(base_lr: float, milestones: Sequence[int],
                       gamma: float = 0.1, warmup_steps: int = 500
                       ) -> Callable[[int], float]:
    """Step decay with linear warm-up (reference MultiStepLRScheduler
    option, train.py:111-115): from ``WARMUP_INIT`` to ``base_lr`` over
    ``warmup_steps``, then ``base_lr`` times ``gamma`` for each milestone
    reached."""
    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = min(step / max(warmup_steps, 1), 1.0)
            return WARMUP_INIT + (base_lr - WARMUP_INIT) * frac
        return base_lr * gamma ** sum(step >= m for m in milestones)

    return schedule


def _matches(name: str, prefix: str) -> bool:
    """``param_labels``' rule on dotted names: the prefix starts the name,
    or appears after a module boundary."""
    return (name == prefix or name.startswith(prefix + ".")
            or f".{prefix}." in name)


def param_labels(model: nn.Module,
                 frozen_prefixes: Sequence[str] = ()) -> Dict[str, str]:
    """'frozen' / 'backbone' / 'default' per parameter name; a frozen
    prefix wins over a backbone one."""
    labels = {}
    for name, _ in model.named_parameters():
        if any(_matches(name, p) for p in frozen_prefixes):
            labels[name] = "frozen"
        elif _matches(name, BACKBONE):
            labels[name] = "backbone"
        else:
            labels[name] = "default"
    return labels


def frozen_prefixes(cfg) -> Tuple[str, ...]:
    return FROZEN_BACKBONE + (FROZEN_LIFTER if cfg.freeze_lifter else ())


def build_optimizer(model: nn.Module, cfg, total_steps: int,
                    milestones: Optional[Sequence[int]] = None
                    ) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """(AdamW over the trained parameters in two groups, the default
    group's schedule: the warm-up cosine one, or with ``milestones`` the
    step decay). Each group carries ``lr_mult``: the backbone schedule is
    ``lr_mult`` times the default one (warm-up start, peak and floor all
    scale by it), and :func:`train.step.apply_gradients` sets each group's
    lr to ``schedule(t) * lr_mult`` before optimizer step t."""
    o = cfg.optim
    if milestones:
        schedule = multistep_schedule(o.lr, milestones,
                                      warmup_steps=o.warmup_iters)
    else:
        schedule = cosine_warmup_schedule(o.lr, total_steps, o.warmup_iters,
                                          min_lr_ratio=o.min_lr_ratio)
    labels = param_labels(model, frozen_prefixes(cfg))
    groups: Dict[str, List[torch.Tensor]] = {"default": [], "backbone": []}
    for name, prm in model.named_parameters():
        if labels[name] != "frozen":
            groups[labels[name]].append(prm)
    param_groups = [
        {"params": groups["default"], "lr_mult": 1.0, "name": "default"},
        {"params": groups["backbone"], "lr_mult": o.backbone_lr_mult,
         "name": "backbone"}]
    opt = torch.optim.AdamW([g for g in param_groups if g["params"]],
                            lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=o.weight_decay)
    opt.grad_max_norm = o.grad_max_norm
    return opt, schedule


class GradientAccumulation:
    """``optax.MultiSteps(every_k_schedule=every_k)`` in front of the
    update: micro-step n folds its gradients into a running mean (acc +=
    (g - acc) / (n + 1), a missing gradient counting as 0); on the k-th,
    the mean goes to ``.grad`` for the clipping and AdamW, and the mean
    starts again from 0. Between those calls the parameters and the
    optimizer do not change, so the schedule counts optimizer steps."""

    def __init__(self, every_k: int):
        self.every_k = every_k
        self.mini_step = 0
        self.acc: Dict[str, torch.Tensor] = {}

    def add(self, model: nn.Module) -> bool:
        """Fold this micro-step's ``.grad`` in; True when the mean is in
        ``.grad`` and the optimizer is to step."""
        n = self.mini_step
        for name, prm in model.named_parameters():
            acc = self.acc.get(name)
            if acc is None:
                acc = self.acc[name] = torch.zeros_like(prm)
            grad = prm.grad if prm.grad is not None else torch.zeros_like(prm)
            acc.add_((grad - acc) / (n + 1))
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step:
            return False
        for name, prm in model.named_parameters():
            prm.grad = self.acc.pop(name)
        return True

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "acc": dict(self.acc)}

    def load_state_dict(self, state: dict):
        self.mini_step = state["mini_step"]
        self.acc = dict(state["acc"])
