"""The JAX modules' options that no shipped config sets, in the PyTorch
port against the JAX package on the CPU at fp32: the focal and dice
losses, every switch of the occupancy loss (sem/geo scal among them), the
BCE / density / depth losses, ``pixel_distribution_loss``'s sigmoid, polar
anchors (``spherical_to_cartesian``, the key-point generator and the v1
refinement), the FFN's ``pre_norm``, the head's KITTI column order, the v1
lifter's ``pts_init``; then two whole tiny train steps with the options
on, one v1 and one prob.

Inputs come from numpy seeds; module weights are a JAX init tree filled
from a numpy seed and carried over by ``utils/convert.py``. Each test
states its tolerance; gradients come from autograd against ``jax.grad``.
"""
import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussianformer_tpu.configs import get_config as jax_get_config
from gaussianformer_tpu.configs.nuscenes import \
    MANUAL_CLASS_WEIGHT as JAX_CLASS_WEIGHT
from gaussianformer_tpu.losses import bce as jbce
from gaussianformer_tpu.losses import focal as jfocal
from gaussianformer_tpu.losses import multi_loss as jmulti
from gaussianformer_tpu.losses import occupancy as jocc
from gaussianformer_tpu.models import BEVSegmentor as JaxSegmentor
from gaussianformer_tpu.models.encoder.modules import (
    AsymmetricFFN as JaxFFN, GaussianPrediction as JaxPrediction,
    SparseGaussian3DKeyPointsGenerator as JaxKps,
    SparseGaussian3DRefinementModule as JaxRefine)
from gaussianformer_tpu.models.head.gaussian_head import \
    GaussianHead as JaxHead
from gaussianformer_tpu.models.lifter.gaussian_lifter import \
    GaussianLifter as JaxLifter
from gaussianformer_tpu.ops.coords import \
    spherical_to_cartesian as jax_spherical
from gaussianformer_tpu.ops.splat import SplatGridSpec as JaxGrid
from gaussianformer_tpu.train.optim import build_optimizer as jax_optimizer
from gaussianformer_tpu.train.step import optax_global_norm

from gaussianformer_tpu_torch.configs import (MANUAL_CLASS_WEIGHT,
                                              OptimConfig, get_config)
from gaussianformer_tpu_torch.data.transforms import _prepare_anchor_points
from gaussianformer_tpu_torch.losses import bce, focal, occupancy
from gaussianformer_tpu_torch.losses.multi_loss import LossTerm, MultiLoss
from gaussianformer_tpu_torch.models.encoder.modules import (
    AsymmetricFFN, GaussianPrediction, SparseGaussian3DKeyPointsGenerator,
    SparseGaussian3DRefinementModule)
from gaussianformer_tpu_torch.models.head.gaussian_head import GaussianHead
from gaussianformer_tpu_torch.models.lifter.gaussian_lifter import \
    GaussianLifter
from gaussianformer_tpu_torch.models.segmentor import (BEVSegmentor,
                                                       build_segmentor)
from gaussianformer_tpu_torch.ops.coords import spherical_to_cartesian
from gaussianformer_tpu_torch.ops.splat import SplatGridSpec
from gaussianformer_tpu_torch.train.optim import build_optimizer
from gaussianformer_tpu_torch.train.step import train_step
from gaussianformer_tpu_torch.utils.convert import (jax_paths,
                                                    jax_to_state_dict)

from test_torch_port_encoder import _load
from test_torch_port_model import (DEPTH_MIN, DEPTH_MAX, random_variables,
                                   tiny_batch)
from test_torch_port_v1_model import jax_batch

PC_RANGE = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
E, P = 32, 40
# losses and their gradients: fp32 sums and logs in another order
LOSS_RTOL = 1e-5
# modules: fp32 matmuls and transcendental functions
MOD_TOL = 1e-4


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _check_value_and_grads(jfn, tfn, inputs, diff, rtol=LOSS_RTOL):
    """``jfn`` / ``tfn`` on the numpy ``inputs``; the value to ``rtol``
    and the gradient of each input named in ``diff`` to ``rtol`` of its
    largest |element|."""
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    ref, ref_g = jax.value_and_grad(
        lambda d: jfn(**{**jin, **d}))({k: jin[k] for k in diff})
    tin = {k: _t(v, k in diff) for k, v in inputs.items()}
    got = tfn(**tin)
    np.testing.assert_allclose(got.item(), float(ref), rtol=rtol, atol=1e-7)
    grads = torch.autograd.grad(got, [tin[k] for k in diff])
    for k, g in zip(diff, grads):
        r = np.asarray(ref_g[k])
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=rtol * np.abs(r).max() + 1e-12,
                                   err_msg=k)
    return got.item()


# ------------------------------------------------------------- the losses
def _focal_inputs(kind, rng):
    n, c = 300, 18
    inputs = dict(logits=rng.randn(n, c).astype(np.float32) * 2.0,
                  labels=rng.randint(0, c + (kind == "sigmoid"), n))
    if kind == "distance":
        inputs = dict(logits=inputs["logits"].reshape(1, n, c),
                      labels=rng.randint(0, c, (1, n)),
                      sampled_xyz=rng.uniform(-50, 50, (1, n, 3)).astype(
                          np.float32))
    return inputs


@pytest.mark.parametrize("kind,weighted", [
    ("sigmoid", False), ("sigmoid", True), ("softmax", False),
    ("softmax", True), ("distance", False), ("distance-softmax", True),
    ("dice", False), ("dice", True)])
def test_focal_and_dice_losses_match_jax(kind, weighted):
    """The four functions of losses/focal.py, with and without class (and
    sample) weights; the sigmoid focal loss with the background label C;
    dice with a validity mask. Value and gradient to 1e-5 relative."""
    rng = np.random.RandomState(31)
    cw = np.array(jocc.balanced_class_weights(18, JAX_CLASS_WEIGHT))
    extra_j = dict(class_weights=jnp.asarray(cw)) if weighted else {}
    extra_t = dict(class_weights=torch.from_numpy(cw)) if weighted else {}
    if kind in ("sigmoid", "softmax"):
        inputs = _focal_inputs(kind, rng)
        sw = rng.rand(300).astype(np.float32) + 0.5
        if weighted:
            extra_j["sample_weights"] = jnp.asarray(sw)
            extra_t["sample_weights"] = torch.from_numpy(sw)
        jfn = getattr(jfocal, f"{kind}_focal_loss")
        tfn = getattr(focal, f"{kind}_focal_loss")
        val = _check_value_and_grads(
            lambda **a: jfn(a["logits"], a["labels"], **extra_j),
            lambda **a: tfn(a["logits"], a["labels"].long(), **extra_t),
            inputs, ["logits"])
    elif kind.startswith("distance"):
        inputs = _focal_inputs("distance", rng)
        sig = kind == "distance"
        val = _check_value_and_grads(
            lambda **a: jfocal.distance_weighted_focal_loss(
                a["logits"], a["labels"], a["sampled_xyz"],
                use_sigmoid=sig, **extra_j),
            lambda **a: focal.distance_weighted_focal_loss(
                a["logits"], a["labels"], a["sampled_xyz"],
                use_sigmoid=sig, **extra_t),
            inputs, ["logits"])
    else:
        logits = rng.randn(300, 18).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        inputs = dict(probs=probs.astype(np.float32),
                      labels=rng.randint(0, 18, 300),
                      valid=rng.rand(300) > 0.3)
        val = _check_value_and_grads(
            lambda **a: jfocal.dice_loss(a["probs"], a["labels"],
                                         valid=a["valid"], **extra_j),
            lambda **a: focal.dice_loss(a["probs"], a["labels"].long(),
                                        valid=a["valid"], **extra_t),
            inputs, ["probs"])
    assert val > 0


# every switch of OccupancyLossCfg, each case a set of them on
OCC_CASES = {
    "plain": {},
    "no_lovasz_ignore_empty": dict(use_lovasz=False, ignore_empty=True),
    "frequency_weights": dict(manual_class_weight=None),
    "unbalanced": dict(balance_cls_weight=False),
    "scal": dict(use_sem_geo_scal=True, sem_scal_weight=0.7,
                 geo_scal_weight=1.3),
    "focal_sigmoid": dict(use_focal=True),
    "focal_softmax": dict(use_focal=True, focal_use_sigmoid=False),
    "dice": dict(use_dice=True, dice_weight=1.5),
    "all": dict(ignore_empty=True, use_sem_geo_scal=True, use_focal=True,
                use_dice=True, manual_class_weight=None),
}


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("case", sorted(OCC_CASES))
def test_occupancy_loss_switches_match_jax(case, logits):
    """``occupancy_loss`` over two layers with masked and empty (label 17)
    voxels, on probabilities and on logits (``lovasz_use_softmax``), with
    the switches of the case on: value and gradient with respect to the
    predictions, to 1e-5 relative."""
    rng = np.random.RandomState(32)
    n, c = 500, 18
    raw = rng.randn(2, 1, n, c).astype(np.float32) * 2.0
    preds = raw if logits else (np.exp(raw) / np.exp(raw).sum(
        -1, keepdims=True)).astype(np.float32)
    labels = rng.randint(0, c, (1, n)).astype(np.int32)
    labels[rng.rand(1, n) < 0.4] = 17
    mask = rng.rand(1, n) > 0.2
    xyz = rng.uniform(-50, 50, (1, n, 3)).astype(np.float32)
    kw = {"manual_class_weight": JAX_CLASS_WEIGHT,
          "lovasz_use_softmax": logits, **OCC_CASES[case]}
    jcfg = jocc.OccupancyLossCfg(**kw)
    tcfg = occupancy.OccupancyLossCfg(**{
        **kw, "manual_class_weight": None if kw["manual_class_weight"]
        is None else MANUAL_CLASS_WEIGHT})
    val = _check_value_and_grads(
        lambda **a: jocc.occupancy_loss(jcfg, [a["p0"], a["p1"]],
                                        a["labels"], a["mask"], a["xyz"]),
        lambda **a: occupancy.occupancy_loss(tcfg, [a["p0"], a["p1"]],
                                             a["labels"], a["mask"],
                                             a["xyz"]),
        dict(p0=preds[0], p1=preds[1], labels=labels, mask=mask, xyz=xyz),
        ["p0", "p1"])
    assert np.isfinite(val)


def test_balanced_class_weights_match_jax():
    """Manual, frequency (no manual weight) and all-ones weights, exactly
    as the JAX package computes them."""
    for manual in (JAX_CLASS_WEIGHT, None, [1.0] * 18):
        for n in (18, 17):
            ref = np.asarray(jocc.balanced_class_weights(
                n, None if manual is None else manual[:n]))
            got = occupancy.balanced_class_weights(
                n, None if manual is None else manual[:n]).numpy()
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fn", ["sem", "geo"])
def test_scal_losses_with_absent_classes_match_jax(fn):
    """sem_scal over 17 classes of which five are absent from the labels
    (and one present only in masked voxels), geo_scal with the empty
    label 0: value and gradient to 1e-5 relative."""
    rng = np.random.RandomState(33)
    n, c = 400, 18
    logits = rng.randn(n, c)
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
             ).astype(np.float32)
    labels = rng.choice([0, 1, 2, 4, 6, 8, 9, 10, 11, 13, 15, 17], n)
    valid = rng.rand(n) > 0.2
    labels[~valid & (rng.rand(n) < 0.5)] = 3    # only where masked
    present = set(labels[valid].tolist())
    assert 3 not in present and len(set(range(17)) - present) >= 5
    if fn == "sem":
        jf = lambda **a: jocc.sem_scal_loss(a["p"], a["l"], a["v"], c)  # noqa
        tf = lambda **a: occupancy.sem_scal_loss(  # noqa: E731
            a["p"], a["l"].long(), a["v"], c)
    else:
        jf = lambda **a: jocc.geo_scal_loss(a["p"], a["l"], a["v"], 0)  # noqa
        tf = lambda **a: occupancy.geo_scal_loss(  # noqa: E731
            a["p"], a["l"].long(), a["v"], 0)
    val = _check_value_and_grads(jf, tf, dict(p=probs, l=labels, v=valid),
                                 ["p"])
    assert val > 0


@pytest.mark.parametrize("loss", ["bce", "bce_weighted", "depth", "density",
                                  "pixel", "pixel_sigmoid"])
def test_bce_family_matches_jax(loss):
    """The three BCE-family losses and ``pixel_distribution_loss`` with and
    without its sigmoid: value and gradient to 1e-5 relative."""
    rng = np.random.RandomState(34)
    n = 600
    labels = rng.randint(0, 18, (1, n)).astype(np.int32)
    labels[rng.rand(1, n) < 0.5] = 17
    mask = rng.rand(1, n) > 0.2
    if loss.startswith("bce"):
        w = (0.3, 1.7) if loss == "bce_weighted" else (1.0, 1.0)
        probs = rng.uniform(0, 1, (2, 1, n)).astype(np.float32)
        probs[0, 0, :5] = (0.0, 1.0, 1e-8, 1 - 1e-9, 0.5)
        val = _check_value_and_grads(
            lambda **a: jbce.binary_cross_entropy_loss(
                [a["b0"], a["b1"]], a["l"], a["m"], class_weights=w),
            lambda **a: bce.binary_cross_entropy_loss(
                [a["b0"], a["b1"]], a["l"], a["m"], class_weights=w),
            dict(b0=probs[0], b1=probs[1], l=labels, m=mask), ["b0", "b1"])
    elif loss == "density":
        dens = (rng.rand(2, 1, n) * 2.0 - 0.5).astype(np.float32)
        dens[:, :, :20] = 0.0          # voxels no Gaussian reaches
        val = _check_value_and_grads(
            lambda **a: jbce.density_loss([a["d0"], a["d1"]], a["l"],
                                          a["m"], thresh=0.3),
            lambda **a: bce.density_loss([a["d0"], a["d1"]], a["l"],
                                         a["m"], thresh=0.3),
            dict(d0=dens[0], d1=dens[1], l=labels, m=mask), ["d0", "d1"])
        val0 = bce.density_loss([_t(dens[0])], _t(labels), _t(mask))
        np.testing.assert_allclose(val0.item(), float(jbce.density_loss(
            [dens[0]], labels, mask)), rtol=LOSS_RTOL)
    else:
        logits = rng.randn(1, 6, 4, 5, 9).astype(np.float32) * 3
        gt = rng.rand(1, 6, 4, 5, 9) > 0.7
        gt[0, 0, 0, 0] = False          # a ray with no occupied bin
        if loss == "depth":
            jf, tf = jbce.occ_depth_loss, bce.occ_depth_loss
        else:
            sig = loss == "pixel_sigmoid"
            jf = functools.partial(jbce.pixel_distribution_loss,
                                   use_sigmoid=sig)
            tf = functools.partial(bce.pixel_distribution_loss,
                                   use_sigmoid=sig)
        val = _check_value_and_grads(
            lambda **a: jf(a["x"], a["gt"]), lambda **a: tf(a["x"], a["gt"]),
            dict(x=logits, gt=gt), ["x"])
    assert val > 0


# ------------------------------------------------------------ polar anchors
@pytest.mark.parametrize("act", ["sigmoid", "loop"])
def test_spherical_to_cartesian_matches_jax(act):
    """Both phi activations on anchors whose phi logit crosses whole
    numbers (the loop's wrap), to 1e-4 of the 50 m range; any other
    activation raises, as in JAX."""
    rng = np.random.RandomState(35)
    anchor = (rng.randn(2, 300, 11) * 3.0).astype(np.float32)
    anchor[0, :4, 2] = (-1.0, 0.0, 2.0, -0.5)
    ref = np.asarray(jax_spherical(anchor, PC_RANGE, act))
    got = spherical_to_cartesian(torch.from_numpy(anchor), PC_RANGE, act)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=MOD_TOL * 50.0)
    if act == "loop":
        np.testing.assert_allclose(
            spherical_to_cartesian(torch.from_numpy(anchor), PC_RANGE)
            .numpy(), ref, rtol=0, atol=MOD_TOL * 50.0)
    with pytest.raises(NotImplementedError):
        spherical_to_cartesian(torch.from_numpy(anchor), PC_RANGE, "tanh")
    with pytest.raises(NotImplementedError):
        jax_spherical(anchor, PC_RANGE, "tanh")


def _init(jmod, seed, *args, **kw):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args,
                                              **kw))
    return random_variables(dict(shapes), seed)


def _param_grads_match(port, jgrads, scope, prefix, tol=MOD_TOL):
    """The port module's ``.grad`` of every parameter against the JAX
    gradient tree (converted under the module's full-model scope), to
    ``tol`` of each leaf's largest |element|."""
    tree = jgrads
    for name in reversed(scope.split("/")):
        tree = {name: tree}
    ref = jax_to_state_dict({"params": tree})
    names = dict(port.named_parameters())
    assert {prefix + n for n in names} == set(ref)
    for n, prm in names.items():
        r = ref[prefix + n].numpy()
        np.testing.assert_allclose(prm.grad.numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max() + 1e-12,
                                   err_msg=n)


@pytest.mark.parametrize("act", ["sigmoid", "loop"])
def test_polar_key_points_match_jax(act):
    """The key-point generator with ``xyz_coordinate="polar"`` (a module
    field only: the deformable op never sets it): key points and the
    learnable offsets' parameter gradients of sum(key points * w)."""
    rng = np.random.RandomState(36)
    anchor = (rng.randn(1, P, 28) * 0.8).astype(np.float32)
    inst = rng.randn(1, P, E).astype(np.float32)
    w = rng.randn(1, P, 3, 3).astype(np.float32)
    kw = dict(embed_dims=E, num_learnable_pts=2, learnable_fixed_scale=6.0,
              pc_range=PC_RANGE, xyz_coordinate="polar",
              phi_activation=act)
    jmod = JaxKps(**kw)
    v = _init(jmod, 37, anchor, inst)
    ref, ref_g = jax.value_and_grad(
        lambda p: jnp.sum(jmod.apply({"params": p}, anchor, inst) * w))(
        v["params"])
    ref_kp = np.asarray(jmod.apply(v, anchor, inst))
    port = _load(SparseGaussian3DKeyPointsGenerator(**kw), v["params"],
                 "encoder/op0_deformable/kps_generator",
                 "encoder.layers.0.kps_generator.")
    got = port(torch.from_numpy(anchor), torch.from_numpy(inst))
    np.testing.assert_allclose(got.detach().numpy(), ref_kp, rtol=MOD_TOL,
                               atol=MOD_TOL * 50.0)
    cart = SparseGaussian3DKeyPointsGenerator(**{
        **kw, "xyz_coordinate": "cartesian"})
    cart.load_state_dict(port.state_dict())
    assert (cart(torch.from_numpy(anchor), torch.from_numpy(inst))
            - got).abs().max() > 1.0
    (got * torch.from_numpy(w)).sum().backward()
    _param_grads_match(port, ref_g, "encoder/op0_deformable/kps_generator",
                       "encoder.layers.0.kps_generator.")


@pytest.mark.parametrize("act", ["sigmoid", "loop"])
def test_polar_v1_refinement_matches_jax(act):
    """The v1 refinement with ``xyz_coordinate="polar"`` at
    gs25600_solid's switches: the new anchor, the decoded Gaussian (its
    means from the polar anchor) and every parameter's gradient of a
    weighted sum of the means, scales and semantics."""
    rng = np.random.RandomState(38)
    anchor = (rng.randn(1, P, 28) * 0.8).astype(np.float32)
    inst = rng.randn(1, P, E).astype(np.float32)
    embed = rng.randn(1, P, E).astype(np.float32)
    wm = rng.randn(1, P, 3).astype(np.float32)
    ws = rng.randn(1, P, 17).astype(np.float32)
    kw = dict(embed_dims=E, pc_range=PC_RANGE, scale_range=(0.08, 0.64),
              unit_xyz=(4.0, 4.0, 1.0), semantic_dim=17, include_opa=True,
              semantics_activation="softplus", restrict_xyz=True,
              refine_manual=(0, 1, 2), xyz_coordinate="polar",
              phi_activation=act)
    jmod = JaxRefine(**kw)
    v = _init(jmod, 39, inst, anchor, embed)

    def objective(out, g, lib, conv):
        return (lib.sum(g.means * conv(wm)) + lib.sum(g.scales)
                + lib.sum(g.semantics * conv(ws)) + lib.sum(out))
    ref_anchor, ref_g = jmod.apply(v, inst, anchor, embed)
    jgrads = jax.grad(lambda p: objective(*jmod.apply(
        {"params": p}, inst, anchor, embed), jnp, jnp.asarray))(v["params"])
    port = _load(SparseGaussian3DRefinementModule(**kw), v["params"],
                 "encoder/op3_refine", "encoder.layers.3.")
    got_anchor, got_g = port(torch.from_numpy(inst), torch.from_numpy(anchor),
                             torch.from_numpy(embed))
    np.testing.assert_allclose(got_anchor.detach().numpy(), ref_anchor,
                               rtol=MOD_TOL, atol=MOD_TOL)
    for field in GaussianPrediction._fields:
        np.testing.assert_allclose(
            getattr(got_g, field).detach().numpy(),
            np.asarray(getattr(ref_g, field)), rtol=MOD_TOL,
            atol=MOD_TOL * (50.0 if field == "means" else 1.0),
            err_msg=field)
    objective(got_anchor, got_g, torch, torch.from_numpy).backward()
    _param_grads_match(port, jgrads, "encoder/op3_refine",
                       "encoder.layers.3.")


def test_ffn_pre_norm_matches_jax():
    """``pre_norm`` at the v1 FFN's widths (in_channels 256, embed_dims
    128, ``identity_fc``): the LayerNorm over the 256 input channels, its
    carried-over weights, the output and every parameter's gradient."""
    rng = np.random.RandomState(40)
    x = rng.randn(1, P, 256).astype(np.float32)
    w = rng.randn(1, P, 128).astype(np.float32)
    kw = dict(embed_dims=128, feedforward_channels=512, ffn_drop=0.1,
              add_identity=True, in_channels=256, pre_norm=True)
    jmod = JaxFFN(**kw)
    v = _init(jmod, 41, x)
    assert v["params"]["pre_norm"]["scale"].shape == (256,)
    ref = np.asarray(jmod.apply(v, x, deterministic=True))
    jgrads = jax.grad(lambda p: jnp.sum(jmod.apply(
        {"params": p}, x, deterministic=True) * w))(v["params"])
    port = _load(AsymmetricFFN(**kw), v["params"], "encoder/op1_ffn",
                 "encoder.layers.1.")
    np.testing.assert_array_equal(port.pre_norm.weight.detach().numpy(),
                                  v["params"]["pre_norm"]["scale"])
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=MOD_TOL,
                               atol=MOD_TOL)
    (got * torch.from_numpy(w)).sum().backward()
    _param_grads_match(port, jgrads, "encoder/op1_ffn", "encoder.layers.1.")


def _prediction(rng, p, sem_dim, include_opa, cls):
    means = rng.uniform(-1, 1, (1, p, 3)) * [45.0, 45.0, 3.5] + [0, 0, -1.0]
    fields = dict(
        means=means, scales=rng.uniform(1.0, 4.0, (1, p, 3)),
        rotations=rng.randn(1, p, 4),
        opacities=rng.rand(1, p, int(include_opa)),
        semantics=rng.randn(1, p, sem_dim))
    conv = (lambda a: torch.from_numpy(np.asarray(a, np.float32))) \
        if cls is GaussianPrediction else \
        (lambda a: jnp.asarray(a, jnp.float32))
    return cls(**{k: conv(v) for k, v in fields.items()})


@pytest.mark.parametrize("branch", ["prob", "with_empty"])
def test_kitti_head_order_matches_jax(branch):
    """``dataset_type="kitti"`` puts the learnt Gaussians' zero empty
    column first: the prob head (softmax semantics, combine_geosem) and
    the additive head with the empty Gaussian (empty label 0), in training
    (the supervised layer's splat): ``pred_occ`` (and ``bin_logits`` /
    ``density``) to 1e-4 and the gradient of the semantics and means
    through the splat's backward to 1e-4 of their largest."""
    grid = dict(H=20, W=20, D=8, pc_min=(-50.0, -50.0, -5.0), grid_size=5.0,
                scale_multiplier=3.0 if branch == "with_empty" else 4.0)
    axes = [np.arange(n, dtype=np.float32) * 5.0 + 2.5 + lo
            for n, lo in zip((20, 20, 8), grid["pc_min"])]
    occ_xyz = np.stack(np.meshgrid(*axes, indexing="ij"), -1)[None]
    occ_label = np.zeros((1, 20, 20, 8), np.int32)
    occ_mask = np.ones((1, 20, 20, 8), bool)
    prob = branch == "prob"
    kw = dict(apply_loss_type="random_1", num_classes=18,
              empty_label=17 if prob else 0, with_empty=not prob,
              use_localaggprob=prob, combine_geosem=prob,
              dataset_type="kitti")
    sem_dim = 17
    jmod = JaxHead(grid=JaxGrid(**grid), **kw)
    jrep = [_prediction(np.random.RandomState(42 + i), 200, sem_dim, True,
                        JaxPrediction) for i in range(2)]
    v = jmod.init(jax.random.PRNGKey(0), jrep, occ_xyz, occ_label, occ_mask)
    if not prob:
        v = {"params": {"empty_scalar": np.asarray([0.8], np.float32)}}
    keys = ["pred_occ"] + (["bin_logits", "density"] if prob else [])
    rng = np.random.RandomState(44)
    wts = {k: rng.randn(*np.asarray(jmod.apply(
        v, jrep, occ_xyz, occ_label, occ_mask, training=True)[k][0]).shape)
        for k in keys}

    def jobj(rep):
        out = jmod.apply(v, rep, occ_xyz, occ_label, occ_mask, training=True)
        return sum(jnp.sum(out[k][0] * wts[k]) for k in keys), out
    (_, ref), jg = jax.value_and_grad(jobj, has_aux=True)(jrep)
    port = GaussianHead(SplatGridSpec(**grid), **kw)
    if not prob:
        port.load_state_dict({"empty_scalar": torch.tensor([0.8])})
    trep = [_prediction(np.random.RandomState(42 + i), 200, sem_dim, True,
                        GaussianPrediction) for i in range(2)]
    leaves = [trep[-1].means.requires_grad_(),
              trep[-1].semantics.requires_grad_()]
    got = port(trep, torch.from_numpy(occ_xyz), torch.from_numpy(occ_label),
               torch.from_numpy(occ_mask), training=True)
    for k in keys:
        np.testing.assert_allclose(got[k][0].detach().numpy(),
                                   np.asarray(ref[k][0]), rtol=MOD_TOL,
                                   atol=MOD_TOL, err_msg=k)
    np.testing.assert_array_equal(got["sampled_xyz"].numpy(),
                                  np.asarray(ref["sampled_xyz"]))
    # the zero column is first: the empty label's column of pred_occ is
    # the empty Gaussian's (with_empty) or holds no learnt semantics
    col = got["pred_occ"][0][0].detach()
    if prob:
        # combine_geosem keeps the first 17 of the 18 normalised columns:
        # the first, the zero one, holds only the uniform fallback's 1/17
        # of the occupancy where the probability sum is below 1e-9
        bins = got["bin_logits"][0][0].detach()
        assert (col[:, 0] <= bins / 17 + 1e-7).all()
        assert (col[:, 0] == 0).float().mean() > 0.5
        assert (col[:, 1:17] > 0).any()
    else:
        assert (col[:, 0] > 0).float().mean() > 0.9
    sum(torch.sum(got[k][0] * torch.from_numpy(wts[k]).float())
        for k in keys).backward()
    for name, leaf, r in (("means", leaves[0], jg[-1].means),
                          ("semantics", leaves[1], jg[-1].semantics)):
        r = np.asarray(r)
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=0,
                                   atol=MOD_TOL * np.abs(r).max(),
                                   err_msg=name)


def test_v1_lifter_pts_init_matches_jax():
    """``pts_init``: each sample's anchor xyz from its anchor points
    (``_prepare_anchor_points`` on a seeded scan with fewer points than
    anchors, so the jittered padding runs) through the inverse sigmoid,
    the rest from the bank; the bank's gradient has zeros in its xyz
    columns; without anchor points the lifter raises."""
    rng = np.random.RandomState(45)
    pts = np.stack([_prepare_anchor_points(
        rng.uniform(-60, 60, (30, 3)).astype(np.float32), PC_RANGE, P,
        np.random.RandomState(46 + b), 0.2) for b in range(2)])
    assert pts.shape == (2, P, 3) and pts.min() >= 0 and pts.max() <= 1
    kw = dict(num_anchor=P, embed_dims=E, semantic_dim=17, include_opa=True,
              pts_init=True)
    jmod = JaxLifter(**kw)
    v = _init(jmod, 47, batch_size=2, anchor_points=pts)
    ref = jmod.apply(v, batch_size=2, anchor_points=pts)
    w = rng.randn(2, P, 28).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jmod.apply(
        {"params": p}, batch_size=2, anchor_points=pts)["representation"]
        * w))(v["params"])
    port = GaussianLifter(**kw)
    port.load_state_dict({k[len("lifter."):]: t for k, t in
                          jax_to_state_dict({"params": {
                              "lifter": v["params"]}}).items()})
    got = port(2, torch.from_numpy(pts))
    for key in ("representation", "rep_features"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(ref[key]), rtol=MOD_TOL,
                                   atol=MOD_TOL, err_msg=key)
    (got["representation"] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(port.anchor.grad.numpy(),
                               np.asarray(jg["anchor"]), rtol=1e-6,
                               atol=1e-6)
    assert not port.anchor.grad[:, :3].any()
    with pytest.raises(ValueError, match="anchor_points"):
        port(2)


def test_module_overrides_refuse_unknown_keys():
    """The segmentor's ``module_overrides`` reach a module keyword by the
    JAX dict's name; an unknown dict or keyword raises."""
    cfg = get_config("gs25600_solid_tiny")
    model = BEVSegmentor(cfg, {"lifter_cfg": {"pts_init": True},
                               "encoder_cfg": {"refine_cfg": {
                                   "xyz_coordinate": "polar"}},
                               "head_cfg": {"dataset_type": "kitti"}})
    assert model.lifter.pts_init and model.head.empty_first
    refines = [m for m in model.encoder.layers
               if isinstance(m, SparseGaussian3DRefinementModule)]
    assert refines and all(m.xyz_coordinate == "polar" for m in refines)
    for bad in ({"neck_cfg": {}}, {"head_cfg": {"splat_tile_n": 8}},
                {"encoder_cfg": {"refine_cfg": {"bogus": 1}}},
                {"encoder_cfg": {"norm_cfg": {}}}):
        with pytest.raises(KeyError):
            build_segmentor(cfg, device="cpu", module_overrides=bad)


# ------------------------------------------------------ the slice as a whole
# Two tiny train steps with the options on, one step each in both packages
# from one set of converted weights, dropout off (the packages draw other
# numbers), at fp32. The JAX side reaches the options by editing the dicts
# of ``segmentor_cfg()``, the port by ``module_overrides`` under the same
# names. Tolerances are those of test_torch_port_train.py: losses and the
# gradient norm to 1e-4 relative (fp32 sums in another order through the
# whole model), each gradient leaf to 2e-3 of its norm.
E2E_LOSS_RTOL = 1e-4
E2E_GRAD_REL = 2e-3
E2E_TOTAL_STEPS = 10
V1_OVERRIDES = {"lifter_cfg": {"pts_init": True},
                "encoder_cfg": {"refine_cfg": {"xyz_coordinate": "polar",
                                               "phi_activation": "loop"}},
                "head_cfg": {"dataset_type": "kitti"}}
PROB_OVERRIDES = {"head_cfg": {"dataset_type": "kitti"}}


def _edit(seg, overrides):
    """JAX: the same edits made to the dicts of ``segmentor_cfg()``."""
    for name, value in overrides.items():
        if isinstance(value, dict) and isinstance(seg.get(name), dict):
            _edit(seg[name], value)
        else:
            seg[name] = value


def _occ_term(pkg, cfg):
    mod = jocc if pkg == "jax" else occupancy
    fn = functools.partial(mod.occupancy_loss, mod.OccupancyLossCfg(**cfg))
    keys = ("pred_occ", "sampled_label", "occ_mask", "sampled_xyz")
    return (jmulti.LossTerm if pkg == "jax" else LossTerm)(
        name="OccupancyLoss", weight=1.0, fn=fn, input_keys=keys)


def _v1_loss(pkg):
    """CE replaced by the softmax focal loss, with sem/geo scal, Lovász
    and dice, the empty label 0 (KITTI's)."""
    manual = JAX_CLASS_WEIGHT if pkg == "jax" else MANUAL_CLASS_WEIGHT
    term = _occ_term(pkg, dict(
        empty_label=0, lovasz_ignore=0, lovasz_use_softmax=True,
        manual_class_weight=manual, use_focal=True, focal_use_sigmoid=False,
        use_sem_geo_scal=True, use_dice=True))
    return (jmulti.MultiLoss if pkg == "jax" else MultiLoss)([term])


def _prob_loss(pkg):
    """OccupancyLoss with every switch on (the sigmoid focal loss, scal,
    dice, ignore_empty, the frequency weights), plus BCE, density, depth
    and the pixel loss through its sigmoid, the empty label 0."""
    b, term = (jbce, jmulti.LossTerm) if pkg == "jax" else (bce, LossTerm)
    terms = [
        _occ_term(pkg, dict(
            empty_label=0, lovasz_ignore=0, ignore_empty=True,
            use_sem_geo_scal=True, manual_class_weight=None, use_focal=True,
            use_dice=True)),
        term("BinaryCrossEntropyLoss", 1.0, functools.partial(
            b.binary_cross_entropy_loss, empty_label=0,
            class_weights=(0.4, 1.6)),
            ("bin_logits", "sampled_label", "occ_mask")),
        term("DensityLoss", 0.5, functools.partial(
            b.density_loss, empty_label=0, thresh=0.1),
            ("density", "sampled_label", "occ_mask")),
        term("OccDepthLoss", 0.3, b.occ_depth_loss,
             ("pixel_logits", "pixel_gt")),
        term("PixelDistributionLoss", 1.0, functools.partial(
            b.pixel_distribution_loss, use_sigmoid=True),
            ("pixel_logits", "pixel_gt"))]
    return (jmulti.MultiLoss if pkg == "jax" else MultiLoss)(terms)


def _v1_pair():
    cfg = dataclasses.replace(
        get_config("gs25600_solid_tiny"), attn_drop=0.0, ffn_drop=0.0,
        ffn_pre_norm=True, empty_label=0,
        optim=OptimConfig(lr=2e-4, warmup_iters=1))
    jcfg = dataclasses.replace(
        jax_get_config("gs25600_solid"), embed_dims=cfg.embed_dims,
        num_decoder=cfg.num_decoder, num_anchor=cfg.num_anchor,
        scale_range=cfg.scale_range, spconv_grid_size=cfg.spconv_grid_size,
        ffn_in_channels=cfg.ffn_in_channels, compute_dtype="float32",
        attn_drop=0.0, ffn_drop=0.0, ffn_pre_norm=True, empty_label=0)
    seg = jcfg.segmentor_cfg()
    seg["backbone_cfg"].update(with_cp=False, depth=cfg.depth,
                               base_channels=cfg.base_channels,
                               stage_with_dcn=cfg.stage_with_dcn)
    _edit(seg, V1_OVERRIDES)
    # the lidar anchor points of pts_init, from a seeded scan
    rng = np.random.RandomState(50)
    scan = np.concatenate([rng.uniform(-45, 45, (200, 2)),
                           rng.uniform(-4, 2, (200, 1))], -1)
    pts = _prepare_anchor_points(scan.astype(np.float32), PC_RANGE,
                                 cfg.num_anchor, rng, 0.2)[None]
    return cfg, jcfg, seg, V1_OVERRIDES, {"anchor_points": pts}, _v1_loss


def _prob_pair():
    cfg = dataclasses.replace(
        get_config("prob_gs6400_tiny"), attn_drop=0.0, ffn_drop=0.0,
        ffn_pre_norm=True, empty_label=0,
        optim=OptimConfig(warmup_iters=1))
    jcfg = dataclasses.replace(
        jax_get_config("prob_gs6400"), embed_dims=cfg.embed_dims,
        num_decoder=cfg.num_decoder, num_anchor=cfg.num_anchor,
        random_samples=cfg.random_samples,
        num_depth_samples=cfg.num_depth_samples,
        num_learnable_pts=cfg.num_learnable_pts, compute_dtype="float32",
        attn_drop=0.0, ffn_drop=0.0, ffn_pre_norm=True, empty_label=0)
    seg = jcfg.segmentor_cfg()
    seg["backbone_cfg"].update(with_cp=False, depth=cfg.depth,
                               base_channels=cfg.base_channels,
                               stage_with_dcn=cfg.stage_with_dcn)
    g = cfg.grid
    seg["lifter_cfg"].update(
        num_samples=cfg.num_depth_samples, occ_resolution=(g.H, g.W, g.D),
        voxel_size=g.grid_size, initializer_depth=cfg.depth,
        initializer_dcn=cfg.stage_with_dcn,
        initializer_base_channels=cfg.base_channels,
        initializer_out_channels=cfg.initializer_out_channels,
        deterministic_sampling=True, depth_min=DEPTH_MIN,
        depth_max=DEPTH_MAX)
    _edit(seg, PROB_OVERRIDES)
    return cfg, jcfg, seg, PROB_OVERRIDES, {}, _prob_loss


def _variables(shapes):
    """Seed-0 weights for every leaf but the FFNs' ``pre_norm`` ones, which
    come from seed 1: the other leaves are then those of the slice tests
    at the same config without the option (test_torch_port_model.py,
    test_torch_port_v1_train.py). At other seeds the two packages' FPS can
    swap two anchors at a near-tie of their last-bit different
    candidates, and then every Gaussian moves (ROADMAP C)."""
    params = dict(shapes["params"])
    encoder = dict(params["encoder"])
    pre = {}
    for name, sub in list(encoder.items()):
        if isinstance(sub, dict) and "pre_norm" in sub:
            pre[name] = {"pre_norm": sub["pre_norm"]}
            encoder[name] = {k: v for k, v in sub.items() if k != "pre_norm"}
    assert pre
    variables = random_variables(dict(shapes, params=dict(
        params, encoder=encoder)), 0)
    for name, leaf in random_variables(pre, 1).items():
        variables["params"]["encoder"][name].update(leaf)
    return variables


@pytest.fixture(scope="module", params=["v1", "prob"])
def option_runs(request):
    return run_variant(request.param)


def run_variant(variant):
    """One forward in training mode and one train step of each package on
    the variant's tiny model, from the same weights and batch."""
    cfg, jcfg, seg, overrides, extra, loss = (
        _v1_pair if variant == "v1" else _prob_pair)()
    g = cfg.grid
    seg["head_cfg"]["grid"] = JaxGrid(
        H=g.H, W=g.W, D=g.D, pc_min=g.pc_min, grid_size=g.grid_size,
        scale_multiplier=g.scale_multiplier)
    jmodel = JaxSegmentor(**seg)
    batch = tiny_batch(cfg)
    batch.update({k: torch.from_numpy(v) for k, v in extra.items()})
    jb = jax_batch(batch)
    key = jax.random.PRNGKey(0)
    kw = dict(occ_xyz=jb["occ_xyz"], occ_label=jb["occ_label"],
              occ_cam_mask=jb["occ_cam_mask"],
              anchor_points=jb.get("anchor_points"), training=True, rng=key)
    args = (jb["imgs"], jb["projection_mat"], jb["image_wh"])
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, *args, **kw))
    variables = _variables(shapes)
    if cfg.version == 2:
        variables["params"]["lifter"]["projection"]["bias"][-1] = -1e4
    else:
        variables["params"]["head"]["empty_scalar"][:] = 0.5
    port = BEVSegmentor(cfg, overrides).eval()
    port.load_state_dict(jax_to_state_dict(variables))
    if cfg.version == 2:
        port.lifter.deterministic_sampling = True
        port.lifter.depth_min, port.lifter.depth_max = DEPTH_MIN, DEPTH_MAX

    stats = variables["batch_stats"]
    jloss = loss("jax")

    def jforward(params):
        return jmodel.apply({"params": params, "batch_stats": stats}, *args,
                            **kw, rngs={"dropout": key})
    def jobjective(params):
        out = jforward(params)
        total, logs = jloss(out)
        return total, (logs, out)
    (jl, (jlogs, jout)), jgrads = jax.jit(jax.value_and_grad(
        jobjective, has_aux=True))(variables["params"])
    tx, _ = jax_optimizer(variables["params"], cfg.optim.lr,
                          E2E_TOTAL_STEPS, warmup_steps=1,
                          frozen_prefixes=("img_backbone/conv1",
                                           "img_backbone/bn1",
                                           "img_backbone/stage1"))
    updates, _ = tx.update(jgrads, tx.init(variables["params"]),
                           variables["params"])
    jparams = optax.apply_updates(variables["params"], updates)

    with torch.no_grad():
        tout = port(batch["imgs"], batch["projection_mat"],
                    batch["image_wh"], batch["occ_xyz"], batch["occ_label"],
                    batch["occ_cam_mask"], batch.get("anchor_points"),
                    training=True)
    # the port freezes as the JAX optimizer above does: the stem, stage 1
    # and, for the prob config, the lifter's towers (left out of the JAX
    # run's frozen prefixes, so its frozen leaves are held elsewhere)
    opt, schedule = build_optimizer(
        port, dataclasses.replace(cfg, freeze_lifter=False),
        E2E_TOTAL_STEPS)
    metrics = train_step(port, opt, schedule, loss("port"), batch,
                         torch.Generator().manual_seed(0))
    return dict(
        cfg=cfg, jout=jout, tout=tout, variables=variables,
        jmetrics={"loss": float(jl), "grad_norm": float(
            optax_global_norm(jgrads)),
            **{k: float(v) for k, v in jlogs.items()}},
        tmetrics={k: v.item() for k, v in metrics.items()},
        jgrads=jax_to_state_dict({"params": jgrads}),
        tgrads={n: p.grad.detach().clone()
                for n, p in port.named_parameters()},
        jparams=jax_to_state_dict({"params": jparams}),
        tparams={n: p.detach().clone() for n, p in port.named_parameters()})


def test_options_forward_matches_jax(option_runs):
    """The supervised layer's ``pred_occ`` (and for prob ``bin_logits``
    and ``density``) to 1e-4 (1 + |jax|), and ``final_occ`` equal where
    the JAX predictions' top two differ by more than the packages'
    rounding."""
    r = option_runs
    jout, tout = r["jout"], r["tout"]
    keys = ["pred_occ"] + (["bin_logits", "density"]
                           if r["cfg"].version == 2 else [])
    for k in keys:
        got, ref = tout[k][-1].numpy(), np.asarray(jout[k][-1])
        assert got.shape == ref.shape and np.all(np.isfinite(got)), k
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    pred = np.asarray(jout["pred_occ"][-1])
    top2 = np.sort(pred, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2e-4 * (1 + np.abs(top2[..., 1]))
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(tout["final_occ"].numpy()[clear],
                                  np.asarray(jout["final_occ"])[clear])
    for f in ("means", "scales", "semantics"):
        np.testing.assert_allclose(
            getattr(tout["gaussian"], f).numpy(),
            np.asarray(getattr(jout["gaussian"], f)), rtol=1e-4, atol=1e-3,
            err_msg=f)


def test_options_losses_match_jax(option_runs):
    """Every loss term, the total and the gradient norm, to 1e-4."""
    r = option_runs
    assert set(r["tmetrics"]) == set(r["jmetrics"])
    names = {"loss", "OccupancyLoss", "grad_norm"}
    if r["cfg"].version == 2:
        names |= {"BinaryCrossEntropyLoss", "DensityLoss", "OccDepthLoss",
                  "PixelDistributionLoss"}
    assert set(r["tmetrics"]) == names
    for k, ref in r["jmetrics"].items():
        got = r["tmetrics"][k]
        assert np.isfinite(got) and got != 0.0, k
        np.testing.assert_allclose(got, ref, rtol=E2E_LOSS_RTOL, err_msg=k)


def test_options_gradients_match_jax(option_runs):
    """Every gradient leaf by relative norm (named by ``jax_paths``),
    against the JAX gradient times the port's clip factor; the FFN's
    ``pre_norm`` and, at v1, the bank among them."""
    r = option_runs
    scale = min(1.0, r["cfg"].optim.grad_max_norm
                / r["jmetrics"]["grad_norm"])
    paths = jax_paths(r["variables"])
    assert set(r["tgrads"]) == set(r["jgrads"])
    pre = [n for n in r["tgrads"] if ".pre_norm." in n]
    assert pre and all(paths[n].endswith(("pre_norm/scale",
                                          "pre_norm/bias")) for n in pre)
    bad = {}
    for name, ref in r["jgrads"].items():
        ref = ref * scale
        got = r["tgrads"][name]
        rel = ((got - ref).norm() / ref.norm().clamp_min(1e-12)).item()
        if not (rel <= E2E_GRAD_REL or (got - ref).abs().max() <= 1e-9):
            bad[paths[name]] = rel
    assert not bad, bad
    if r["cfg"].version == 1:
        g = r["tgrads"]["lifter.anchor"]
        assert not g[:, :3].any() and g[:, 3:].abs().max() > 0


def test_options_updated_parameters_match_jax(option_runs):
    """The parameters after the step (lr 1e-6 at the first step of the
    warm-up): every element within two steps' largest move, and the
    elements whose JAX gradient exceeds 10% of the leaf's RMS within 1%
    of the lr (the bounds of test_torch_port_train.py)."""
    r = option_runs
    lr = 1e-6
    for name, ref in r["jparams"].items():
        got = r["tparams"][name]
        diff = (got - ref).abs()
        ulp = 2.0 ** -22 * ref.abs()
        assert (diff <= 2.0 * lr * (1 + 0.01 * ref.abs()) + ulp).all(), name
        g = r["jgrads"][name]
        strong = g.abs() > 0.1 * g.square().mean().sqrt()
        assert (diff[strong] <= 0.01 * lr + ulp[strong]).all(), name
