"""The train step (gaussianformer_tpu/train/step.py, ``make_train_step``):
forward with ``training=True``, the loss stack, backward, the global
gradient norm over every parameter (frozen ones included), clipping to
``grad_max_norm`` and the AdamW update at the schedule's lr, every step or,
with gradient accumulation, on the mean of every k steps' gradients; in a
process group, on the gradients averaged over the ranks."""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Sequence

import torch

from ..configs.nuscenes import MANUAL_CLASS_WEIGHT
from ..losses.bce import pixel_distribution_loss
from ..losses.multi_loss import LossTerm, MultiLoss
from ..losses.occupancy import OccupancyLossCfg, occupancy_loss
from ..utils.profiling import span
from .optim import GradientAccumulation


def build_loss(cfg) -> MultiLoss:
    """The config's loss stack, as the JAX package's ``build_loss``:
    OccupancyLoss (CE + Lovász on probabilities, or on logits with
    ``lovasz_use_softmax``, with the manual class weights) and, where the
    config asks for it, PixelDistributionLoss. The other terms and
    switches (``losses/``) go into a :class:`MultiLoss` built by hand."""
    occ_cfg = OccupancyLossCfg(
        num_classes=cfg.num_classes, empty_label=cfg.empty_label,
        ce_weight=cfg.ce_weight, lovasz_weight=cfg.lovasz_weight,
        lovasz_ignore=17, lovasz_use_softmax=cfg.lovasz_use_softmax,
        manual_class_weight=MANUAL_CLASS_WEIGHT, balance_cls_weight=True)
    terms = [LossTerm("OccupancyLoss", 1.0,
                      functools.partial(occupancy_loss, occ_cfg),
                      ("pred_occ", "sampled_label", "occ_mask"))]
    if cfg.use_pixel_distribution_loss:
        terms.append(LossTerm("PixelDistributionLoss", 1.0,
                              pixel_distribution_loss,
                              ("pixel_logits", "pixel_gt")))
    return MultiLoss(terms)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (one norm per
    tensor, in a few batched launches)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def _steps_taken(optimizer: torch.optim.Optimizer) -> int:
    first = optimizer.param_groups[0]["params"][0]
    state = optimizer.state.get(first, {})
    return int(state["step"]) if "step" in state else 0


def apply_gradients(model, optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float]) -> torch.Tensor:
    """The update of ``make_train_step`` on the gradients in ``.grad``:
    their global norm over every parameter (missing gradients count as
    0), ``optax.clip_by_global_norm`` (g * max_norm / norm when norm >=
    max_norm), then AdamW at ``schedule(t) * lr_mult`` for step t of the
    optimizer. Returns the norm before clipping."""
    with span("step/clip"):
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        norm = global_norm(grads)
        max_norm = optimizer.grad_max_norm
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        torch._foreach_mul_(grads, scale)
        lr = schedule(_steps_taken(optimizer))
        for group in optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
    with span("step/update"):
        optimizer.step()
    return norm


def average_gradients(model):
    """Average every ``.grad`` over the process group: one all-reduce of
    the flattened gradients, divided by the world size."""
    import torch.distributed as dist
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [p.view_as(g) for p, g in zip(parts, grads)])


def train_step(model, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], loss_fn: MultiLoss,
               batch: Dict[str, torch.Tensor], generator: torch.Generator,
               apply_loss_layers: Optional[Sequence[int]] = None,
               accumulation: Optional[GradientAccumulation] = None
               ) -> Dict[str, torch.Tensor]:
    """One step on ``batch`` (the keys of ``data.synthetic``, and
    ``anchor_points`` for a ``pts_init`` lifter): forward
    (``apply_loss_layers``: the supervised refine layers a ``random_k``
    config drew on the host), loss, backward, :func:`apply_gradients`;
    with ``accumulation``, the update only on its every k-th call. Returns
    ``{loss, <term>..., grad_norm}`` as detached tensors, ``grad_norm`` of
    this call's gradients before clipping.

    ``model`` may be a DistributedDataParallel wrapper: its backward then
    averages the gradients over the ranks before the clipping. With
    ``accumulation`` every micro-step runs under ``no_sync`` and the
    accumulated mean is averaged over the ranks once, before the update,
    so that a world of one gives a plain run's bits."""
    with span("step"):
        ddp = isinstance(model, torch.nn.parallel.DistributedDataParallel)
        module = model.module if ddp else model
        module.zero_grad(set_to_none=True)
        sync = (model.no_sync() if ddp and accumulation is not None
                else contextlib.nullcontext())
        with sync:
            with span("step/forward"):
                out = model(batch["imgs"], batch["projection_mat"],
                            batch["image_wh"], batch["occ_xyz"],
                            batch["occ_label"], batch["occ_cam_mask"],
                            batch.get("anchor_points"), training=True,
                            generator=generator,
                            apply_loss_layers=apply_loss_layers)
            with span("step/losses"):
                loss, logs = loss_fn(out)
            with span("step/backward"):
                loss.backward()
        if accumulation is None:
            norm = apply_gradients(module, optimizer, schedule)
        else:
            with span("step/clip"):
                norm = global_norm([p.grad for p in module.parameters()
                                    if p.grad is not None])
            if accumulation.add(module):
                if ddp:
                    average_gradients(module)
                apply_gradients(module, optimizer, schedule)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in logs.items()}}
        metrics["grad_norm"] = norm.detach()
        return metrics
