"""The modules that the v1 GaussianFormer configs changed in the PyTorch
port, each against its JAX counterpart on the CPU at fp32: the learnable
anchor lifter, the v1 refinement (with and without the opacity column), the
FFN with ``identity_fc``, the deformable aggregation's ``cat`` residual,
the single-layer bias-free spconv, the head with the empty Gaussian, and CE
on logits with Lovasz-softmax. Weights are a JAX init tree filled from a
numpy seed and converted with ``utils/convert.py``; inputs come from numpy
seeds. Tolerance 1e-4 relative and absolute unless a test states another.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussianformer_tpu.configs.nuscenes import \
    MANUAL_CLASS_WEIGHT as JAX_CLASS_WEIGHT
from gaussianformer_tpu.losses.occupancy import \
    OccupancyLossCfg as JaxOccCfg
from gaussianformer_tpu.losses.occupancy import \
    occupancy_loss as jax_occupancy_loss
from gaussianformer_tpu.models.encoder.modules import (
    AsymmetricFFN as JaxFFN, DeformableFeatureAggregation as JaxDFA,
    GaussianPrediction as JaxPrediction,
    SparseConv3DModule as JaxSpconv,
    SparseGaussian3DEncoder as JaxAnchorEncoder,
    SparseGaussian3DRefinementModule as JaxRefine)
from gaussianformer_tpu.models.head.gaussian_head import \
    GaussianHead as JaxHead
from gaussianformer_tpu.models.lifter.gaussian_lifter import \
    GaussianLifter as JaxLifter
from gaussianformer_tpu.ops.splat import SplatGridSpec as JaxGrid

from gaussianformer_tpu_torch.losses.occupancy import (OccupancyLossCfg,
                                                       occupancy_loss)
from gaussianformer_tpu_torch.models.encoder.modules import (
    AsymmetricFFN, DeformableFeatureAggregation, GaussianPrediction,
    SparseConv3DModule, SparseGaussian3DEncoder,
    SparseGaussian3DRefinementModule)
from gaussianformer_tpu_torch.models.head.gaussian_head import GaussianHead
from gaussianformer_tpu_torch.models.lifter.gaussian_lifter import \
    GaussianLifter
from gaussianformer_tpu_torch.ops.splat import SplatGridSpec
from gaussianformer_tpu_torch.utils.convert import jax_to_state_dict

from test_torch_port_encoder import _load
from test_torch_port_model import random_variables, tiny_batch

PC_RANGE = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
E, CAMS, P, TOL = 32, 6, 40, 1e-4


def _init(jmod, seed, *args, **kw):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args,
                                              **kw))
    return random_variables(dict(shapes), seed)


def _close(got, ref, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, err_msg
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL, err_msg=err_msg)


@pytest.mark.parametrize("include_opa,sem", [(True, 17), (False, 18)])
def test_v1_lifter_matches_jax(include_opa, sem):
    """The bank and the zero-initialised features, broadcast over the
    batch; the anchor's width follows ``include_opa``."""
    kw = dict(num_anchor=P, embed_dims=E, semantic_dim=sem,
              include_opa=include_opa)
    jmod = JaxLifter(**kw)
    v = _init(jmod, 5, batch_size=2)
    ref = jmod.apply(v, batch_size=2)
    sd = jax_to_state_dict({"params": {"lifter": v["params"]}})
    assert set(sd) == {"lifter.anchor", "lifter.instance_feature"}
    port = GaussianLifter(**kw)
    port.load_state_dict({k[len("lifter."):]: t for k, t in sd.items()})
    got = port(2)
    assert got["representation"].shape == (2, P, 10 + int(include_opa) + sem)
    for key in ("representation", "rep_features"):
        _close(got[key], ref[key], key)


@pytest.mark.parametrize("include_opa,sem,act", [(True, 17, "softplus"),
                                                 (False, 18, "identity")])
def test_v1_anchor_encoder_and_refinement_match_jax(include_opa, sem, act):
    """gs25600_solid's and gs144000's shapes of the anchor embedding and
    of the v1 refinement (``restrict_xyz``, ``refine_manual`` (0, 1, 2)):
    the new anchor, which is the head's output with the quaternion
    normalised, and the decoded Gaussian."""
    rng = np.random.RandomState(6)
    width = 10 + int(include_opa) + sem
    anchor = (rng.randn(1, P, width) * 0.8).astype(np.float32)
    inst = rng.randn(1, P, E).astype(np.float32)

    jenc = JaxAnchorEncoder(embed_dims=E, include_opa=include_opa,
                            semantic_dim=sem)
    v = _init(jenc, 7, anchor)
    embed = np.array(jenc.apply(v, anchor))
    penc = _load(SparseGaussian3DEncoder(E, sem, include_opa), v["params"],
                 "encoder/anchor_encoder", "encoder.anchor_encoder.")
    assert hasattr(penc, "opacity_fc") == include_opa
    with torch.no_grad():
        _close(penc(torch.from_numpy(anchor)), embed, "anchor_embed")

    kw = dict(embed_dims=E, pc_range=PC_RANGE, scale_range=(0.08, 0.64),
              unit_xyz=(4.0, 4.0, 1.0), semantic_dim=sem,
              include_opa=include_opa, semantics_activation=act,
              restrict_xyz=True, refine_manual=(0, 1, 2))
    jref = JaxRefine(**kw)
    v = _init(jref, 8, inst, anchor, embed)
    ref_anchor, ref_g = jref.apply(v, inst, anchor, embed)
    pref = _load(SparseGaussian3DRefinementModule(**kw), v["params"],
                 "encoder/op3_refine", "encoder.layers.3.")
    with torch.no_grad():
        got_anchor, got_g = pref(torch.from_numpy(inst),
                                 torch.from_numpy(anchor),
                                 torch.from_numpy(embed))
    _close(got_anchor, ref_anchor, "anchor")
    for field in GaussianPrediction._fields:
        _close(getattr(got_g, field), getattr(ref_g, field), field)
    assert got_g.opacities.shape[-1] == int(include_opa)
    # the step in the anchor's logit space is bounded by 4 unit / range
    step = (got_anchor[..., :3] - torch.from_numpy(anchor[..., :3])).abs()
    assert torch.all(step <= torch.tensor([0.16, 0.16, 0.5]) + 1e-6)


def test_ffn_identity_fc_matches_jax():
    """256 -> 128 with the input projected by ``identity_fc`` and added
    (the v1 FFN after the concatenating deformable op)."""
    rng = np.random.RandomState(9)
    x = rng.randn(1, P, 2 * E).astype(np.float32)
    kw = dict(embed_dims=E, feedforward_channels=4 * E, ffn_drop=0.1,
              add_identity=True, in_channels=2 * E)
    jmod = JaxFFN(**kw)
    v = _init(jmod, 10, x)
    ref = jmod.apply(v, x, deterministic=True)
    port = _load(AsymmetricFFN(**kw), v["params"], "encoder/op1_ffn",
                 "encoder.layers.1.")
    assert port.identity_fc.weight.shape == (E, 2 * E)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), ref)


def test_deformable_cat_matches_jax():
    """``residual_mode="cat"`` with the v1 key points (1 fixed + 2
    learnable, ``learnable_fixed_scale`` 1): [output, input] on the
    channel axis."""
    batch = tiny_batch()
    rng = np.random.RandomState(11)
    anchor = np.concatenate([rng.randn(P, 3) * 0.8, rng.randn(P, 25)],
                            -1)[None].astype(np.float32)
    inst = rng.randn(1, P, E).astype(np.float32)
    embed = rng.randn(1, P, E).astype(np.float32)
    feats = [rng.randn(1, CAMS, h, w, E).astype(np.float32)
             for h, w in ((8, 12), (4, 6), (2, 3), (1, 2))]
    kw = dict(embed_dims=E, num_cams=CAMS, num_learnable_pts=2,
              learnable_fixed_scale=1.0, pc_range=PC_RANGE,
              scale_range=(0.08, 0.64), residual_mode="cat")
    jmod = JaxDFA(backend="xla", **kw)
    from gaussianformer_tpu.ops.deformable import pack_feature_maps
    packed = pack_feature_maps([jnp.asarray(f) for f in feats])
    args = (inst, anchor, embed, packed, batch["projection_mat"].numpy(),
            batch["image_wh"].numpy())
    v = _init(jmod, 12, *args)
    ref = np.asarray(jax.jit(jmod.apply)(v, *args))
    port = _load(DeformableFeatureAggregation(**kw), v["params"],
                 "encoder/op0_deformable", "encoder.layers.0.")
    with torch.no_grad():
        got = port(torch.from_numpy(inst), torch.from_numpy(anchor),
                   torch.from_numpy(embed),
                   [torch.from_numpy(f) for f in feats],
                   batch["projection_mat"], batch["image_wh"])
    assert got.shape == (1, P, 2 * E)
    _close(got, ref)
    np.testing.assert_array_equal(got[..., E:].numpy(), inst)


@pytest.mark.parametrize("use_out_proj", [True, False])
def test_single_layer_spconv_matches_jax(use_out_proj):
    """One 5x5x5 submanifold conv without bias, LayerNorm or ReLU on the
    v1 configs' 0.5 m grid, with and without the output projection; one
    anchor per voxel, several pairs of anchors in neighbouring voxels."""
    rng = np.random.RandomState(13)
    dims = (200, 200, 16)
    base = np.stack([rng.randint(5, 190, P // 2), rng.randint(5, 190, P // 2),
                     rng.randint(2, 13, P // 2)], -1)
    vox = np.concatenate([base, base + rng.randint(1, 3, base.shape)], 0)
    assert len({tuple(v) for v in vox}) == P
    world = (vox + rng.uniform(0.2, 0.8, vox.shape)) * 0.5 \
        + [-50.0, -50.0, -5.0]
    unit = (world - [-50.0, -50.0, -5.0]) / [100.0, 100.0, 8.0]
    anchor = np.zeros((1, P, 28), np.float32)
    anchor[0, :, :3] = np.log(unit / (1 - unit))
    inst = rng.randn(1, P, E).astype(np.float32)
    kw = dict(in_channels=E, embed_channels=E, pc_range=PC_RANGE,
              grid_size=(0.5, 0.5, 0.5), use_out_proj=use_out_proj,
              use_multi_layer=False)
    jmod = JaxSpconv(**kw)
    v = _init(jmod, 14, inst, anchor)
    assert set(v["params"]) == ({"conv0_kernel", "output_proj"}
                                if use_out_proj else {"conv0_kernel"})
    ref = np.asarray(jax.jit(jmod.apply)(v, inst, anchor))
    port = _load(SparseConv3DModule(**kw), v["params"], "encoder/op4_spconv",
                 "encoder.layers.4.")
    assert port.layer.bias is None and tuple(dims)
    with torch.no_grad():
        got = port(torch.from_numpy(inst), torch.from_numpy(anchor))
    _close(got, ref)
    # neighbours do reach each other: the conv is not the centre tap alone
    centre = inst[0] @ port.layer.weight[:, 2, 2, 2].T.detach().numpy()
    if not use_out_proj:
        assert np.abs(got[0].numpy() - centre).max() > 1e-2


def _prediction(rng, p, sem_dim, include_opa, cls):
    means = rng.uniform(-1, 1, (1, p, 3)) * [45.0, 45.0, 3.5] + [0, 0, -1.0]
    fields = dict(
        means=means, scales=rng.uniform(1.0, 4.0, (1, p, 3)),
        rotations=rng.randn(1, p, 4),
        opacities=rng.rand(1, p, int(include_opa)),
        semantics=np.log1p(np.exp(rng.randn(1, p, sem_dim))))
    conv = (lambda a: torch.from_numpy(np.asarray(a, np.float32))) \
        if cls is GaussianPrediction else \
        (lambda a: jnp.asarray(a, jnp.float32))
    return cls(**{k: conv(v) for k, v in fields.items()})


@pytest.mark.parametrize("with_empty,include_opa,sem_dim",
                         [(True, True, 17), (False, False, 18)])
def test_v1_head_matches_jax(with_empty, include_opa, sem_dim):
    """The additive head: ``pred_occ`` (raw sums) and ``final_occ`` of the
    last layer at inference, with the empty Gaussian and its
    ``empty_scalar`` (gs25600_solid) and with ones for the missing
    opacities (gs144000); no ``bin_logits`` or ``density``."""
    grid = dict(H=20, W=20, D=8, pc_min=(-50.0, -50.0, -5.0), grid_size=5.0,
                scale_multiplier=3.0)
    axes = [np.arange(n, dtype=np.float32) * 5.0 + 2.5 + lo
            for n, lo in zip((20, 20, 8), grid["pc_min"])]
    occ_xyz = np.stack(np.meshgrid(*axes, indexing="ij"), -1)[None]
    occ_label = np.zeros((1, 20, 20, 8), np.int32)
    occ_mask = np.ones((1, 20, 20, 8), bool)
    kw = dict(apply_loss_type="random_1", num_classes=18, empty_label=17,
              with_empty=with_empty, use_localaggprob=False,
              combine_geosem=False)
    jmod = JaxHead(grid=JaxGrid(**grid), **kw)
    p = 300   # boxes of 27-343 voxels: most of the 3200 voxels are held
    jrep = [_prediction(np.random.RandomState(15 + i), p, sem_dim,
                        include_opa, JaxPrediction) for i in range(2)]
    v = jmod.init(jax.random.PRNGKey(0), jrep, occ_xyz, occ_label, occ_mask)
    if with_empty:
        v = {"params": {"empty_scalar": np.asarray([0.8], np.float32)}}
    ref = jmod.apply(v, jrep, occ_xyz, occ_label, occ_mask, training=False)
    port = GaussianHead(SplatGridSpec(**grid), **kw)
    if with_empty:
        port.load_state_dict({k[len("head."):]: t for k, t in
                              jax_to_state_dict({"params": {
                                  "head": v["params"]}}).items()})
        assert port.empty_scalar.item() == np.float32(0.8)
    else:
        assert not list(port.parameters())
    trep = [_prediction(np.random.RandomState(15 + i), p, sem_dim,
                        include_opa, GaussianPrediction) for i in range(2)]
    with torch.no_grad():
        got = port(trep, torch.from_numpy(occ_xyz),
                   torch.from_numpy(occ_label), torch.from_numpy(occ_mask))
    assert len(got["pred_occ"]) == 1 and got["bin_logits"] == []
    assert got["density"] == []
    ref_logits = np.asarray(ref["pred_occ"][-1])
    _close(got["pred_occ"][-1], ref_logits)
    top2 = np.sort(ref_logits, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2e-4 * (1 + np.abs(top2[..., 1]))
    assert clear.mean() > 0.2
    np.testing.assert_array_equal(got["final_occ"].numpy()[clear],
                                  np.asarray(ref["final_occ"])[clear])
    if with_empty:
        assert (got["final_occ"] == 17).float().mean() > 0.2
        assert len(torch.unique(got["final_occ"])) > 3
    for key in ("sampled_label", "occ_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))


@pytest.mark.parametrize("layers", [1, 4])
def test_occupancy_loss_with_softmax_matches_jax(layers):
    """CE on logits (log-softmax) + Lovasz on their softmax, with ignored
    (label 17) and masked voxels, averaged over the supervised layers (1
    for ``random_1``, 4 for gs144000's ``all``): value and gradient with
    respect to the logits, to 1e-5 relative."""
    rng = np.random.RandomState(23)
    n, c = 600, 18
    logits = [np.abs(rng.randn(1, n, c) * 2.0).astype(np.float32)
              for _ in range(layers)]
    labels = rng.randint(0, c, (1, n)).astype(np.int32)
    labels[rng.rand(1, n) < 0.4] = 17
    mask = rng.rand(1, n) > 0.2
    jcfg = JaxOccCfg(manual_class_weight=JAX_CLASS_WEIGHT,
                     lovasz_use_softmax=True)
    ref, ref_g = jax.value_and_grad(
        lambda p: jax_occupancy_loss(jcfg, list(p), labels, mask))(
        tuple(jnp.asarray(x) for x in logits))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in logits]
    got = occupancy_loss(OccupancyLossCfg(lovasz_use_softmax=True), leaves,
                         torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    grads = torch.autograd.grad(got, leaves)
    for g, r in zip(grads, ref_g):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())
    # not the probabilities' loss: the same numbers read as probabilities
    # give another value
    other = occupancy_loss(OccupancyLossCfg(), [x.detach() for x in leaves],
                           torch.from_numpy(labels), torch.from_numpy(mask))
    assert abs(other.item() - got.item()) > 1e-2
