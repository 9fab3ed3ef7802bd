"""The port's losses, lr schedule, clipped AdamW update and dropout, on the
CPU at fp32. The losses, the schedule and the update are held against the
JAX package (inputs made with numpy from a seed); dropout against its
definition, on the port alone (torch and JAX draw different numbers)."""
import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from gaussianformer_tpu.configs.nuscenes import \
    MANUAL_CLASS_WEIGHT as JAX_CLASS_WEIGHT
from gaussianformer_tpu.losses.bce import \
    pixel_distribution_loss as jax_pixel_loss
from gaussianformer_tpu.losses.occupancy import \
    OccupancyLossCfg as JaxOccCfg
from gaussianformer_tpu.losses.occupancy import \
    occupancy_loss as jax_occupancy_loss
from gaussianformer_tpu.train.optim import build_optimizer as jax_optimizer
from gaussianformer_tpu.train.optim import cosine_warmup_schedule

from gaussianformer_tpu_torch.configs import (MANUAL_CLASS_WEIGHT,
                                              OptimConfig, get_config)
from gaussianformer_tpu_torch.losses.bce import pixel_distribution_loss
from gaussianformer_tpu_torch.losses.occupancy import (OccupancyLossCfg,
                                                       occupancy_loss)
from gaussianformer_tpu_torch.models.encoder.modules import (
    AsymmetricFFN, DeformableFeatureAggregation)
from gaussianformer_tpu_torch.models.layers import dropout
from gaussianformer_tpu_torch.train.optim import (build_optimizer,
                                                  param_labels)
from gaussianformer_tpu_torch.train.step import apply_gradients

TINY = get_config("prob_gs6400_tiny")


def test_class_weights_copied():
    assert MANUAL_CLASS_WEIGHT == JAX_CLASS_WEIGHT


@pytest.mark.parametrize("layers", [1, 2])
def test_occupancy_loss_matches_jax(layers):
    """CE on probabilities + Lovász with ignored (label 17) and masked
    voxels, averaged over the supervised layers: value and gradient with
    respect to the probabilities, to 1e-5 relative (fp32 sums, logs)."""
    rng = np.random.RandomState(21)
    n, c = 600, 18
    probs = [jax.nn.softmax(jnp.asarray(rng.randn(1, n, c) * 2.0,
                                        jnp.float32), -1)
             for _ in range(layers)]
    labels = rng.randint(0, c, (1, n)).astype(np.int32)
    labels[rng.rand(1, n) < 0.4] = 17
    mask = rng.rand(1, n) > 0.2
    jcfg = JaxOccCfg(manual_class_weight=JAX_CLASS_WEIGHT)
    ref, ref_g = jax.value_and_grad(
        lambda p: jax_occupancy_loss(jcfg, list(p), labels, mask))(
        tuple(probs))
    leaves = [torch.from_numpy(np.array(p)).requires_grad_()
              for p in probs]
    cfg = OccupancyLossCfg(manual_class_weight=MANUAL_CLASS_WEIGHT)
    got = occupancy_loss(cfg, leaves, torch.from_numpy(labels),
                         torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    grads = torch.autograd.grad(got, leaves)
    for g, r in zip(grads, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_pixel_distribution_loss_matches_jax():
    rng = np.random.RandomState(22)
    logits = rng.randn(1, 6, 4, 5, 9).astype(np.float32) * 3
    gt = rng.rand(1, 6, 4, 5, 9) > 0.7
    ref, ref_g = jax.value_and_grad(
        lambda x: jax_pixel_loss(x, gt, use_sigmoid=False))(logits)
    x = torch.from_numpy(logits).requires_grad_()
    got = pixel_distribution_loss(x, torch.from_numpy(gt))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    (g,) = torch.autograd.grad(got, [x])
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-5 * np.abs(ref_g).max())


@pytest.mark.parametrize("step", [0, 1, 250, 499, 500, 501, 2999, 3000])
def test_schedule_matches_optax(step):
    """The port's schedule (python floats) against optax's fp32 one, for
    the default group and the backbone group (lr_mult times it): to 1e-6
    relative, and 1e-10 absolute, two fp32 ulps of the 4e-4 peak, which
    the warm-up's fp32 interpolation loses near its start."""
    o = TINY.optim
    total = 3000
    model = _ToyModel()
    _, schedule = build_optimizer(model, TINY, total)
    ref = cosine_warmup_schedule(o.lr, total, o.warmup_iters,
                                 min_lr_ratio=o.min_lr_ratio)
    ref_bb = cosine_warmup_schedule(
        o.lr * o.backbone_lr_mult, total, o.warmup_iters,
        warmup_init=1e-6 * o.backbone_lr_mult, min_lr_ratio=o.min_lr_ratio)
    np.testing.assert_allclose(schedule(step), float(ref(step)), rtol=1e-6,
                               atol=1e-10)
    np.testing.assert_allclose(schedule(step) * o.backbone_lr_mult,
                               float(ref_bb(step)), rtol=1e-6, atol=1e-11)


class _ToyModel(nn.Module):
    """One leaf per optimizer label: frozen (stage 1 of the backbone),
    backbone (stage 2), default (head)."""

    def __init__(self):
        super().__init__()
        rng = np.random.RandomState(23)
        self.img_backbone = nn.Module()
        for stage in ("layer1", "layer2"):
            mod = nn.Module()
            mod.weight = nn.Parameter(torch.from_numpy(
                rng.randn(4, 3).astype(np.float32)))
            setattr(self.img_backbone, stage, mod)
        self.head = nn.Linear(3, 5)
        with torch.no_grad():
            self.head.weight.copy_(torch.from_numpy(
                rng.randn(5, 3).astype(np.float32)))
            self.head.bias.copy_(torch.from_numpy(
                rng.randn(5).astype(np.float32)))

    JAX_PATH = {"img_backbone.layer1.weight": ("img_backbone", "stage1",
                                               "weight"),
                "img_backbone.layer2.weight": ("img_backbone", "stage2",
                                               "weight"),
                "head.weight": ("head", "kernel"),
                "head.bias": ("head", "bias")}


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


@pytest.mark.parametrize("grad_scale", [0.5, 30.0])
def test_clipped_adamw_update_matches_optax(grad_scale):
    """One update from fresh state at the peak lr (no warm-up) against
    build_optimizer's optax chain: gradients below the clip norm of 35
    (scale 0.5, norm about 3) and above it (scale 30, norm about 180).
    The frozen leaf must not move; parameters to 1e-6 absolute (their
    size is about 1, the update about 4e-4)."""
    cfg = dataclasses.replace(TINY, optim=OptimConfig(warmup_iters=0))
    model = _ToyModel()
    rng = np.random.RandomState(24)
    grads = {n: (rng.randn(*p.shape) * grad_scale).astype(np.float32)
             for n, p in model.named_parameters()}
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    labels = param_labels(model, ("img_backbone.layer1",))
    assert labels == {"img_backbone.layer1.weight": "frozen",
                      "img_backbone.layer2.weight": "backbone",
                      "head.weight": "default", "head.bias": "default"}

    jparams = _nest({model.JAX_PATH[n]: jnp.asarray(v) for n, v in
                     params.items()})
    jgrads = _nest({model.JAX_PATH[n]: jnp.asarray(v) for n, v in
                    grads.items()})
    tx, _ = jax_optimizer(jparams, cfg.optim.lr, 100, warmup_steps=0,
                          frozen_prefixes=("img_backbone/stage1",))
    upd, _ = tx.update(jgrads, tx.init(jparams), jparams)
    import optax
    jnew = optax.apply_updates(jparams, upd)
    jnorm = optax.global_norm(jgrads)

    # the toy model freezes stage 1 as the segmentor does
    opt, schedule = build_optimizer(
        model, dataclasses.replace(cfg, freeze_lifter=False), 100)
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[n])
    norm = apply_gradients(model, opt, schedule)
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    for n, p in model.named_parameters():
        ref = jnew
        for k in model.JAX_PATH[n]:
            ref = ref[k]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-6, err_msg=n)
    assert np.array_equal(model.img_backbone.layer1.weight.detach().numpy(),
                          params["img_backbone.layer1.weight"])


def test_ffn_dropout_scales_kept_values():
    """FFN dropout keeps each value with probability 1 - p and scales it
    by 1 / (1 - p); the same generator seed gives the same mask."""
    p = 0.1
    x = torch.ones(200, 500)
    y = dropout(x, p, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    y2 = dropout(x, p, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    ffn = AsymmetricFFN(8, 32, ffn_drop=p)
    z = torch.randn(4, 10, 8)
    assert torch.equal(ffn(z), ffn(z, training=False))
    assert not torch.equal(ffn(z), ffn(z, True, torch.Generator()))


def test_attention_dropout_before_softmax():
    """About attn_drop of the (key point, camera, level) lanes drop out of
    the masked softmax, which renormalises over the kept ones: each
    anchor's weights of a group still sum to 1 (no 1 / (1 - p) rescale)."""
    torch.manual_seed(0)
    e, cams, k = 16, 2, 3
    dfa = DeformableFeatureAggregation(
        embed_dims=e, num_cams=cams, num_learnable_pts=k - 1,
        attn_drop=0.15, pc_range=(-5.0, -5.0, -2.0, 5.0, 5.0, 2.0))
    p = 400
    inst = torch.randn(1, p, e)
    anchor = torch.zeros(1, p, 28)
    anchor[..., :3] = torch.randn(1, p, 3) * 0.3
    anchor[..., 6] = 1.0
    # two cameras 10 m behind the scene, looking along +z, that see most
    # key points
    proj = torch.tensor([[10.0, 0.0, 10.0, 100.0], [0.0, 10.0, 10.0, 100.0],
                         [0.0, 0.0, 1.0, 10.0], [0.0, 0.0, 0.0, 1.0]]
                        ).repeat(1, cams, 1, 1)
    wh = torch.full((1, cams, 2), 20.0)
    with torch.no_grad():
        loc, w_eval = dfa.attention_inputs(inst, anchor, inst, proj, wh)
        loc, w_train = dfa.attention_inputs(
            inst, anchor, inst, proj, wh, training=True,
            generator=torch.Generator().manual_seed(1))
    vis = (w_eval > 0)
    dropped = vis & (w_train == 0)
    share = dropped.sum().item() / vis.sum().item()
    assert 0.13 < share < 0.17, share
    sums = w_train.reshape(1, p, k * cams * 4, 4).sum(2)
    live = w_eval.reshape(1, p, k * cams * 4, 4).sum(2) > 0
    assert torch.allclose(sums[live], torch.ones_like(sums[live]),
                          atol=1e-5)
