"""The PyTorch port's whole prob_gs6400 inference slice against the JAX
package, on the CPU at fp32, at the tiny config.

Both packages get one set of weights: the JAX init's parameter tree (from
``jax.eval_shape`` of ``BEVSegmentor.init``) filled from a numpy seed,
loaded into the port through ``gaussianformer_tpu_torch.utils.convert``.
The lifter runs top-1 depth sampling with the no-occupancy bin disabled
and rays kept inside pc_range (depths 1-2 m), so every candidate is valid
and no random draw enters either forward (ROADMAP C3). The JAX side runs
its CPU paths: the exact DCN gather, the XLA deformable gather, masked FPS
in XLA, the XLA splat and its label twin.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussianformer_tpu.configs import get_config as jax_get_config
from gaussianformer_tpu.models import BEVSegmentor as JaxSegmentor
from gaussianformer_tpu.ops.splat import SplatGridSpec as JaxGrid
from gaussianformer_tpu.utils.torch_convert import convert_full_state_dict

from gaussianformer_tpu_torch.configs import get_config
from gaussianformer_tpu_torch.data.synthetic import synthetic_batch
from gaussianformer_tpu_torch.models.segmentor import (BEVSegmentor,
                                                       build_segmentor)
from gaussianformer_tpu_torch.utils.convert import jax_to_state_dict

TINY = get_config("prob_gs6400_tiny")
DEPTH_MIN, DEPTH_MAX = 1.0, 2.0


def jax_tiny_segmentor(cfg=TINY):
    """The JAX BEVSegmentor at the port's tiny config."""
    jcfg = dataclasses.replace(
        jax_get_config("prob_gs6400"), embed_dims=cfg.embed_dims,
        num_decoder=cfg.num_decoder, num_anchor=cfg.num_anchor,
        random_samples=cfg.random_samples,
        num_depth_samples=cfg.num_depth_samples,
        num_learnable_pts=cfg.num_learnable_pts,
        compute_dtype=cfg.compute_dtype, attn_drop=cfg.attn_drop,
        ffn_drop=cfg.ffn_drop)
    seg = jcfg.segmentor_cfg()
    towers = dict(depth=cfg.depth, base_channels=cfg.base_channels,
                  stage_with_dcn=cfg.stage_with_dcn)
    seg["backbone_cfg"].update(with_cp=False, **towers)
    g = cfg.grid
    seg["lifter_cfg"].update(
        num_samples=cfg.num_depth_samples, occ_resolution=(g.H, g.W, g.D),
        voxel_size=g.grid_size, initializer_depth=cfg.depth,
        initializer_dcn=cfg.stage_with_dcn,
        initializer_base_channels=cfg.base_channels,
        initializer_out_channels=cfg.initializer_out_channels,
        deterministic_sampling=True, depth_min=DEPTH_MIN,
        depth_max=DEPTH_MAX)
    seg["head_cfg"]["grid"] = JaxGrid(
        H=g.H, W=g.W, D=g.D, pc_min=g.pc_min, grid_size=g.grid_size,
        scale_multiplier=g.scale_multiplier)
    return JaxSegmentor(**seg)


def random_variables(shapes, seed: int):
    """Fill a JAX variable tree of ShapeDtypeStructs from a numpy seed:
    fan-in scaled kernels, small DCN offset kernels (fractional offsets),
    positive BN variances."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        names = [getattr(k, "key", str(k)) for k in path]
        leaf = names[-1]
        shape = s.shape
        if leaf == "var":
            v = rng.rand(*shape) + 0.5
        elif leaf == "mean":
            v = rng.randn(*shape) * 0.1
        elif leaf == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif leaf == "bias" or len(shape) == 1:
            v = rng.randn(*shape) * 0.1
        elif leaf in ("anchor", "random_anchors", "instance_feature"):
            v = rng.randn(*shape)
        else:
            fan_in = int(np.prod(shape[:-1]))
            std = (0.1 if "conv_offset" in names else 1.0) / np.sqrt(fan_in)
            v = rng.randn(*shape) * std
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_batch(cfg=TINY):
    g = cfg.grid
    return synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=0,
                           device="cpu")


def tiny_pair(seed: int = 0, cfg=TINY):
    """(jax model, jax variables, port model, batch) with shared weights."""
    batch = tiny_batch()
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jmodel = jax_tiny_segmentor(cfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, jb["imgs"], jb["projection_mat"],
        jb["image_wh"], occ_xyz=jb["occ_xyz"], occ_label=jb["occ_label"],
        occ_cam_mask=jb["occ_cam_mask"], training=False, rng=key))
    variables = random_variables(dict(shapes), seed)
    # disable the lifter's no-occupancy bin: every candidate stays valid
    variables["params"]["lifter"]["projection"]["bias"][-1] = -1e4
    port = BEVSegmentor(cfg).eval()
    port.load_state_dict(jax_to_state_dict(variables))
    port.lifter.deterministic_sampling = True
    port.lifter.depth_min, port.lifter.depth_max = DEPTH_MIN, DEPTH_MAX
    return jmodel, variables, port, batch


@pytest.fixture(scope="module")
def slice_outputs():
    jmodel, variables, port, batch = tiny_pair()
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    fwd = jax.jit(lambda v: jmodel.apply(
        v, jb["imgs"], jb["projection_mat"], jb["image_wh"],
        occ_xyz=jb["occ_xyz"], occ_label=jb["occ_label"],
        occ_cam_mask=jb["occ_cam_mask"], training=False,
        rng=jax.random.PRNGKey(0)))
    jout = fwd(variables)
    with torch.inference_mode():
        tout = port(batch["imgs"], batch["projection_mat"],
                    batch["image_wh"], batch["occ_xyz"])
    return jout, tout


@pytest.mark.parametrize("key,tol", [
    ("pred_occ", 1e-4), ("bin_logits", 1e-4), ("density", 1e-4)])
def test_slice_outputs_match_jax(slice_outputs, key, tol):
    """pred_occ (combine_geosem logits), bin_logits and density at fp32:
    |port - jax| <= tol * (1 + |jax|)."""
    jout, tout = slice_outputs
    ref = np.asarray(jout[key][-1])
    got = tout[key][-1].numpy()
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_slice_final_occ_labels_equal(slice_outputs):
    jout, tout = slice_outputs
    ref = np.asarray(jout["final_occ"])
    got = tout["final_occ"].numpy()
    assert got.shape == ref.shape == (1, TINY.grid.num_voxels)
    np.testing.assert_array_equal(got, ref)
    assert got.min() >= 0 and got.max() < TINY.num_classes


def test_slice_gaussians_match_jax(slice_outputs):
    """The decoded Gaussians that feed the splat, to 1e-4."""
    jout, tout = slice_outputs
    for field in ("means", "scales", "rotations", "opacities", "semantics"):
        np.testing.assert_allclose(
            getattr(tout["gaussian"], field).numpy(),
            np.asarray(getattr(jout["gaussian"], field)),
            rtol=1e-4, atol=1e-4, err_msg=field)


def test_conversion_round_trip():
    """JAX params -> port state_dict -> the JAX package's own converter
    gives back every JAX leaf exactly, and the port loads the state_dict
    with no missing or unexpected key."""
    jmodel, variables, port, _ = tiny_pair(seed=1)
    sd = jax_to_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    params, stats, unmapped = convert_full_state_dict(
        {k: v.numpy() for k, v in sd.items()}, TINY.operation_order)
    assert unmapped == []
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(
        {"params": params, "batch_stats": stats}))
    assert len(flat_got) == len(flat_ref)
    for path, ref in flat_ref.items():
        np.testing.assert_array_equal(np.asarray(flat_got[path]), ref,
                                      err_msg=jax.tree_util.keystr(path))


def test_entry_points_default_to_cuda():
    """Without device="cpu", the port's entry points refuse to run on a
    host with no CUDA device instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_segmentor(TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_batch(1, TINY.input_size, (4, 4, 2))
