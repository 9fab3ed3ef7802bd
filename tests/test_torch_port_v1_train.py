"""Two whole ``gs25600_solid`` train steps of the PyTorch port against the
JAX package, on the CPU at fp32, at the tiny config.

Both packages start from one set of converted weights (the helpers of
test_torch_port_v1_model.py) and take two steps on the same synthetic
batch: forward with ``training=True`` (``random_1``: the last layer is
splatted, with the empty Gaussian), OccupancyLoss as CE on logits plus
Lovasz-softmax and no pixel loss, backward through the additive splat's
hand-derived VJP (K7's plain version), the global norm over every
parameter, clipping to 35 and AdamW. Only the stem and stage 1 are frozen:
the lifter's anchors and instance features and the head's ``empty_scalar``
train. The tiny config has DCN in stage 4, dropout off (torch and JAX draw
different numbers) and a schedule that warms up over one step, so step 0
runs at 1e-6 and step 1 at the 2e-4 peak. The JAX side runs its CPU paths
under one jit of the step.
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax

from gaussianformer_tpu.configs import get_config as jax_get_config
from gaussianformer_tpu.train.optim import build_optimizer as jax_optimizer
from gaussianformer_tpu.train.optim import param_labels as jax_labels
from gaussianformer_tpu.train.step import build_loss as jax_build_loss
from gaussianformer_tpu.train.step import optax_global_norm

from gaussianformer_tpu_torch.configs import OptimConfig, get_config
from gaussianformer_tpu_torch.train.optim import (build_optimizer,
                                                  frozen_prefixes,
                                                  param_labels)
from gaussianformer_tpu_torch.train.step import build_loss, train_step
from gaussianformer_tpu_torch.utils.convert import (jax_paths,
                                                    jax_to_state_dict)

from test_torch_port_v1_model import jax_batch, v1_pair

CFG = dataclasses.replace(
    get_config("gs25600_solid_tiny"), attn_drop=0.0, ffn_drop=0.0,
    optim=OptimConfig(lr=2e-4, warmup_iters=1))
TOTAL_STEPS = 10
STEPS = 2
# Trainer.init_state's frozen prefixes for a config without freeze_lifter
JAX_FROZEN = ("img_backbone/conv1", "img_backbone/bn1",
              "img_backbone/stage1")
# Tolerances as in test_torch_port_train.py. Losses and the gradient norm:
# fp32 sums in another order through the whole model. Gradients: by leaf,
# |g_port - g_jax| / |g_jax|.
LOSS_RTOL = 1e-4
GRAD_REL = 2e-3


def _jax_run(jmodel, variables, batch):
    loss_fn = jax_build_loss(jax_get_config("gs25600_solid"))
    jb = jax_batch(batch)
    key = jax.random.PRNGKey(0)
    stats = variables["batch_stats"]

    def compute_loss(params):
        out = jmodel.apply(
            {"params": params, "batch_stats": stats}, jb["imgs"],
            jb["projection_mat"], jb["image_wh"], occ_xyz=jb["occ_xyz"],
            occ_label=jb["occ_label"], occ_cam_mask=jb["occ_cam_mask"],
            training=True, rng=key, rngs={"dropout": key})
        return loss_fn(out)

    grad_fn = jax.jit(jax.value_and_grad(compute_loss, has_aux=True))
    params = variables["params"]
    tx, _ = jax_optimizer(params, CFG.optim.lr, TOTAL_STEPS,
                          warmup_steps=CFG.optim.warmup_iters,
                          frozen_prefixes=JAX_FROZEN)
    opt_state = tx.init(params)
    steps = []
    for _ in range(STEPS):
        (loss, logs), grads = grad_fn(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        steps.append(dict(
            metrics={"loss": float(loss), "grad_norm":
                     float(optax_global_norm(grads)),
                     **{k: float(v) for k, v in logs.items()}},
            grads=jax_to_state_dict({"params": grads}),
            params=jax_to_state_dict({"params": params})))
    return steps


def _port_run(port, batch):
    opt, schedule = build_optimizer(port, CFG, TOTAL_STEPS)
    loss_fn = build_loss(CFG)
    gen = torch.Generator().manual_seed(0)
    steps = []
    for _ in range(STEPS):
        metrics = train_step(port, opt, schedule, loss_fn, batch, gen)
        steps.append(dict(
            metrics={k: v.item() for k, v in metrics.items()},
            grads={n: p.grad.detach().clone()
                   for n, p in port.named_parameters()},
            params={n: p.detach().clone()
                    for n, p in port.named_parameters()}))
    return steps


@pytest.fixture(scope="module")
def runs():
    jmodel, variables, port, batch = v1_pair(CFG)
    start = {n: p.detach().clone() for n, p in port.named_parameters()}
    return dict(jax=_jax_run(jmodel, variables, batch),
                port=_port_run(port, batch), start=start,
                variables=variables, port_model=port)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("key", ["loss", "OccupancyLoss", "grad_norm"])
def test_v1_metrics_match_jax(runs, step, key):
    got = runs["port"][step]["metrics"][key]
    ref = runs["jax"][step]["metrics"][key]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert set(runs["port"][step]["metrics"]) == {"loss", "OccupancyLoss",
                                                  "grad_norm"}


@pytest.mark.parametrize("step", range(STEPS))
def test_v1_gradients_match_jax(runs, step):
    """Every gradient leaf by relative norm, the lifter's bank and
    ``head.empty_scalar`` among them. The port's ``.grad`` is clipped in
    place, so it is held against the JAX gradient times the same clip
    factor min(1, 35 / grad_norm)."""
    jstep, pstep = runs["jax"][step], runs["port"][step]
    scale = min(1.0, CFG.optim.grad_max_norm
                / jstep["metrics"]["grad_norm"])
    assert set(pstep["grads"]) == set(jstep["grads"])
    assert {"lifter.anchor", "lifter.instance_feature",
            "head.empty_scalar"} <= set(pstep["grads"])
    bad = {}
    for name, ref in jstep["grads"].items():
        ref = ref * scale
        got = pstep["grads"][name]
        rel = ((got - ref).norm() / ref.norm().clamp_min(1e-12)).item()
        if not (rel <= GRAD_REL or (got - ref).abs().max() <= 1e-9):
            bad[name] = rel
    assert not bad, bad
    assert pstep["grads"]["head.empty_scalar"].abs().item() > 0


@pytest.mark.parametrize("step", range(STEPS))
def test_v1_updated_parameters_match_jax(runs, step):
    """Parameters after each step, with the bounds of
    test_torch_port_train.py: every element within two steps' largest
    move, and the elements whose JAX gradient is well above the leaf's
    noise, with one sign at every step, within 1% of the step's lr."""
    lrs = [1e-6, CFG.optim.lr][:step + 1]
    bound = 2.0 * sum(lrs)
    for name, ref in runs["jax"][step]["params"].items():
        got = runs["port"][step]["params"][name]
        diff = (got - ref).abs()
        ulp = 2.0 ** -22 * ref.abs()
        assert (diff <= bound * (1 + 0.01 * ref.abs()) + ulp).all(), name
        strong = torch.ones_like(ref, dtype=torch.bool)
        sign = torch.sign(runs["jax"][0]["grads"][name])
        for s in range(step + 1):
            g = runs["jax"][s]["grads"][name]
            rms = g.square().mean().sqrt()
            strong &= (g.abs() > 0.1 * rms) & (torch.sign(g) == sign)
        assert (diff[strong] <= 0.01 * lrs[-1] + ulp[strong]).all(), name


def test_v1_frozen_parameters_unchanged(runs):
    """Only the stem and stage 1 are frozen (bit for bit); every other
    leaf moves, the lifter's among them. Labels follow the JAX package's
    param_labels on the same leaves."""
    port = runs["port_model"]
    assert frozen_prefixes(CFG) == ("img_backbone.conv1", "img_backbone.bn1",
                                    "img_backbone.layer1")
    labels = param_labels(port, frozen_prefixes(CFG))
    paths = jax_paths(runs["variables"])
    flat = {}
    for path, lab in jax.tree_util.tree_leaves_with_path(jax_labels(
            runs["variables"]["params"], frozen_prefixes=JAX_FROZEN)):
        flat["/".join(getattr(k, "key", str(k)) for k in path)] = lab
    for name in labels:
        assert labels[name] == flat[paths[name]], name
    assert labels["lifter.anchor"] == labels["head.empty_scalar"] == "default"
    final = runs["port"][-1]["params"]
    frozen = [n for n, lab in labels.items() if lab == "frozen"]
    assert frozen and all(n.startswith("img_backbone.") for n in frozen)
    for name, start in runs["start"].items():
        if labels[name] == "frozen":
            assert torch.equal(final[name], start), name
        else:
            assert not torch.equal(final[name], start), name
