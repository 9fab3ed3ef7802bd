"""The PyTorch port's lifter and encoder modules against the JAX package
on the CPU at fp32: DeformableFeatureAggregation (camera embedding, masked
softmax with all-miss rows, projection, aggregation summed over key
points), SparseConv3DModule with one anchor per voxel (ROADMAP C5), and
GaussianLifterV2 with top-1 depth sampling and every candidate valid
(ROADMAP C3). Weights: the JAX init's tree filled from a numpy seed,
loaded through the port's converter."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from gaussianformer_tpu.models.encoder.modules import (
    DeformableFeatureAggregation as JaxDFA, SparseConv3DModule as JaxSpconv)
from gaussianformer_tpu.models.lifter.gaussian_lifter_v2 import \
    GaussianLifterV2 as JaxLifter

from gaussianformer_tpu_torch.models.encoder.modules import (
    DeformableFeatureAggregation, SparseConv3DModule)
from gaussianformer_tpu_torch.models.lifter.gaussian_lifter_v2 import \
    GaussianLifterV2
from gaussianformer_tpu_torch.utils.convert import jax_to_state_dict
from test_torch_port_model import random_variables, tiny_batch

PC_RANGE = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
E, CAMS, P, TOL = 32, 6, 40, 1e-4


def _load(module, jax_params, scope, prefix):
    """Load a JAX sub-module's params into a port module through the
    full-model converter, under the sub-module's full-model scope."""
    tree = jax_params
    for name in reversed(scope.split("/")):
        tree = {name: tree}
    sd = jax_to_state_dict({"params": tree})
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return module.eval()


def _anchor(rng, p):
    xyz = rng.randn(p, 3) * 0.8
    rest = rng.randn(p, 25)
    return np.concatenate([xyz, rest], -1)[None].astype(np.float32)


def test_deformable_module_matches_jax():
    batch = tiny_batch()
    rng = np.random.RandomState(0)
    anchor = _anchor(rng, P)
    inst = rng.randn(1, P, E).astype(np.float32)
    embed = rng.randn(1, P, E).astype(np.float32)
    shapes = ((8, 12), (4, 6), (2, 3), (1, 2))
    feats = [rng.randn(1, CAMS, h, w, E).astype(np.float32)
             for h, w in shapes]
    proj = batch["projection_mat"].numpy()
    wh = batch["image_wh"].numpy()
    kw = dict(embed_dims=E, num_cams=CAMS, num_learnable_pts=2,
              learnable_fixed_scale=6.0, pc_range=PC_RANGE)
    jmod = JaxDFA(backend="xla", residual_mode="none", **kw)
    from gaussianformer_tpu.ops.deformable import pack_feature_maps
    packed = pack_feature_maps([jnp.asarray(f) for f in feats])
    args = (inst, anchor, embed, packed, proj, wh)
    v = random_variables(dict(jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0), *args)), 3)
    ref = np.asarray(jax.jit(jmod.apply)(v, *args))
    port = _load(DeformableFeatureAggregation(**kw), v["params"],
                 "encoder/op1_deformable", "encoder.layers.1.")
    with torch.no_grad():
        got = port(torch.from_numpy(inst), torch.from_numpy(anchor),
                   torch.from_numpy(embed),
                   [torch.from_numpy(f) for f in feats],
                   batch["projection_mat"], batch["image_wh"])
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_spconv_module_matches_jax():
    rng = np.random.RandomState(1)
    cells = rng.choice(100 * 100 * 8, P, replace=False)
    vox = np.stack(np.unravel_index(cells, (100, 100, 8)), -1)
    world = vox + rng.uniform(0.2, 0.8, vox.shape) + [-50.0, -50.0, -5.0]
    unit = (world - [-50.0, -50.0, -5.0]) / [100.0, 100.0, 8.0]
    anchor = np.zeros((1, P, 28), np.float32)
    anchor[0, :, :3] = np.log(unit / (1 - unit))
    inst = rng.randn(1, P, E).astype(np.float32)
    kw = dict(in_channels=E, embed_channels=E, pc_range=PC_RANGE)
    jmod = JaxSpconv(use_out_proj=True, use_multi_layer=True, **kw)
    v = random_variables(dict(jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0), inst, anchor)), 4)
    ref = np.asarray(jax.jit(jmod.apply)(v, inst, anchor))
    port = _load(SparseConv3DModule(**kw), v["params"], "encoder/op9_spconv",
                 "encoder.layers.9.")
    with torch.no_grad():
        got = port(torch.from_numpy(inst), torch.from_numpy(anchor))
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_lifter_matches_jax():
    batch = tiny_batch()
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    kw = dict(num_anchor=16, embed_dims=E, num_samples=8,
              random_samples=16, depth_min=1.0, depth_max=2.0)
    tower = dict(initializer_depth=26, initializer_base_channels=8,
                 initializer_out_channels=(8, 8, 8, 8),
                 initializer_dcn=(False, False, False, True))
    jmod = JaxLifter(deterministic_sampling=True, **kw, **tower)
    args = (jb["imgs"], jb["projection_mat"], jb["image_wh"])
    key = jax.random.PRNGKey(0)
    call = dict(compute_gt=False, fuse_dcn_epilogue=True, rng=key)
    v = random_variables(dict(jax.eval_shape(
        lambda: jmod.init(key, *args, **call))), 5)
    v["params"]["projection"]["bias"][-1] = -1e4   # no disabled rays
    ref = jax.jit(lambda v: jmod.apply(v, *args, **call))(v)
    sd = jax_to_state_dict({"params": {"lifter": v["params"]},
                            "batch_stats": {"lifter": v["batch_stats"]}})
    port = GaussianLifterV2(deterministic_sampling=True, dtype=torch.float32,
                            **kw, **tower)
    port.load_state_dict({k[len("lifter."):]: t for k, t in sd.items()})
    with torch.no_grad():
        got = port.eval()(batch["imgs"], batch["projection_mat"],
                          batch["image_wh"])
    for key_ in ("pixel_logits", "representation", "rep_features"):
        np.testing.assert_allclose(got[key_].detach().numpy(),
                                   np.asarray(ref[key_]), rtol=TOL,
                                   atol=TOL, err_msg=key_)
