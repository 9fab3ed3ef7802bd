"""The PyTorch port's v1 GaussianFormer path against the JAX package, on
the CPU at fp32, at the two tiny v1 configs: ``gs25600_solid_tiny`` (the
empty Gaussian, softplus semantics, opacities) and ``gs144000_tiny`` (no
opacity column, 18 semantic channels, no empty Gaussian).

Both packages get one set of weights: the JAX init's parameter tree filled
from a numpy seed (the helper of test_torch_port_model.py) and loaded into
the port through ``utils/convert.py``. The v1 forward draws no random
number. The JAX side runs its CPU paths: the exact DCN gather, the XLA
deformable gather, the dense spconv, the XLA additive splat and its label
twin.
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

from gaussianformer_tpu_torch.configs import get_config, list_configs
from gaussianformer_tpu_torch.data.synthetic import synthetic_batch
from gaussianformer_tpu_torch.models.segmentor import (BEVSegmentor,
                                                       build_segmentor)
from gaussianformer_tpu_torch.utils.convert import (jax_paths,
                                                    jax_to_state_dict)

from test_torch_port_model import random_variables

V1_TINY = ("gs25600_solid_tiny", "gs144000_tiny")


def jax_v1_segmentor(cfg):
    """The JAX BEVSegmentor at one of the port's tiny v1 configs."""
    jcfg = dataclasses.replace(
        jax_get_config(cfg.name.replace("_tiny", "")),
        embed_dims=cfg.embed_dims, num_decoder=cfg.num_decoder,
        num_anchor=cfg.num_anchor, scale_range=cfg.scale_range,
        spconv_grid_size=cfg.spconv_grid_size,
        ffn_in_channels=cfg.ffn_in_channels,
        compute_dtype=cfg.compute_dtype, attn_drop=cfg.attn_drop,
        ffn_drop=cfg.ffn_drop)
    seg = jcfg.segmentor_cfg()
    seg["backbone_cfg"].update(with_cp=False, depth=cfg.depth,
                               base_channels=cfg.base_channels,
                               stage_with_dcn=cfg.stage_with_dcn)
    g = cfg.grid
    seg["head_cfg"]["grid"] = JaxGrid(
        H=g.H, W=g.W, D=g.D, pc_min=g.pc_min, grid_size=g.grid_size,
        scale_multiplier=g.scale_multiplier)
    return JaxSegmentor(**seg)


def jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def v1_pair(cfg, seed: int = 0):
    """(jax model, jax variables, port model, batch) with shared weights."""
    g = cfg.grid
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=0,
                            device="cpu")
    jb = jax_batch(batch)
    jmodel = jax_v1_segmentor(cfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, jb["imgs"], jb["projection_mat"],
        jb["image_wh"], occ_xyz=jb["occ_xyz"], occ_label=jb["occ_label"],
        occ_cam_mask=jb["occ_cam_mask"], training=False, rng=key))
    variables = random_variables(dict(shapes), seed)
    if cfg.with_empty:
        # a positive logit on the empty class, small enough that the
        # learnt Gaussians win the voxels near them
        variables["params"]["head"]["empty_scalar"][:] = 0.5
    port = BEVSegmentor(cfg).eval()
    port.load_state_dict(jax_to_state_dict(variables))
    return jmodel, variables, port, batch


@pytest.fixture(scope="module", params=V1_TINY)
def v1_outputs(request):
    cfg = get_config(request.param)
    jmodel, variables, port, batch = v1_pair(cfg)
    jb = jax_batch(batch)
    jout = jax.jit(lambda v: jmodel.apply(
        v, jb["imgs"], jb["projection_mat"], jb["image_wh"],
        occ_xyz=jb["occ_xyz"], occ_label=jb["occ_label"],
        occ_cam_mask=jb["occ_cam_mask"], training=False))(variables)
    with torch.inference_mode():
        tout = port(batch["imgs"], batch["projection_mat"],
                    batch["image_wh"], batch["occ_xyz"], batch["occ_label"],
                    batch["occ_cam_mask"])
    return cfg, jout, tout, batch


def test_v1_pred_occ_matches_jax(v1_outputs):
    """The additive splat's raw sums at fp32: |port - jax| <= 1e-4 (1 +
    |jax|). No ``bin_logits`` or ``density`` on this path."""
    cfg, jout, tout, _ = v1_outputs
    assert len(tout["pred_occ"]) == len(jout["pred_occ"]) == 1
    ref = np.asarray(jout["pred_occ"][-1])
    got = tout["pred_occ"][-1].numpy()
    assert got.shape == ref.shape == (1, cfg.grid.num_voxels, 18)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert tout["bin_logits"] == [] and tout["density"] == []
    assert tout["pixel_logits"] is None and tout["pixel_gt"] is None


def test_v1_final_occ_labels_equal(v1_outputs):
    """First-index argmax of the sums; equal wherever the JAX sums' two
    largest differ by more than the packages' 1e-4 rounding, and 0 in
    both where no box holds the voxel (most voxels of gs144000_tiny,
    which has 48 small Gaussians and no empty one)."""
    cfg, jout, tout, batch = v1_outputs
    ref = np.asarray(jout["final_occ"])
    got = tout["final_occ"].numpy()
    assert got.shape == ref.shape == (1, cfg.grid.num_voxels)
    top2 = np.sort(np.asarray(jout["pred_occ"][-1]), -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2e-4 * (1 + np.abs(top2[..., 1]))
    assert clear.mean() > 0.1
    np.testing.assert_array_equal(got[clear], ref[clear])
    # zero in both: XLA flushes the far tails' denormal sums to zero on
    # the CPU, PyTorch keeps them
    uncovered = (np.all(np.asarray(jout["pred_occ"][-1]) == 0.0, -1)
                 & np.all(tout["pred_occ"][-1].numpy() == 0.0, -1))
    assert np.all(got[uncovered] == 0) and np.all(ref[uncovered] == 0)
    assert (uncovered.mean() > 0.5) != cfg.with_empty
    assert got.min() >= 0 and got.max() < cfg.num_classes
    # the losses' ground truth goes through the head for both variants
    np.testing.assert_array_equal(tout["sampled_label"].numpy(),
                                  batch["occ_label"].reshape(1, -1).numpy())
    np.testing.assert_array_equal(
        tout["occ_mask"].numpy(),
        batch["occ_cam_mask"].reshape(1, -1).numpy())


def test_v1_gaussians_match_jax(v1_outputs):
    """The decoded Gaussians that feed the splat, to 1e-4; gs144000 has
    an empty opacity column in both packages."""
    cfg, jout, tout, _ = v1_outputs
    for field in ("means", "scales", "rotations", "opacities", "semantics"):
        got = getattr(tout["gaussian"], field).numpy()
        ref = np.asarray(getattr(jout["gaussian"], field))
        assert got.shape == ref.shape, field
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                   err_msg=field)
    assert tout["gaussian"].opacities.shape[-1] == int(cfg.include_opa)


@pytest.mark.parametrize("name", V1_TINY)
def test_v1_conversion_places_every_leaf(name):
    """No JAX leaf is left unplaced and no port parameter or buffer
    unfilled; the JAX package's own converter maps the state_dict back
    onto every JAX leaf exactly; ``jax_paths`` names each leaf once."""
    cfg = get_config(name)
    _, variables, port, _ = v1_pair(cfg, seed=1)
    sd = jax_to_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves
    paths = jax_paths(variables)
    assert set(paths) == set(sd) and len(set(paths.values())) == n_leaves
    for key in ("lifter.anchor", "lifter.instance_feature",
                "encoder.layers.1.identity_fc.weight",
                "encoder.layers.4.layer.weight"):
        assert key in sd, key
    assert ("head.empty_scalar" in sd) == cfg.with_empty
    assert ("encoder.anchor_encoder.opacity_fc.0.weight" in sd) \
        == cfg.include_opa
    assert not any(k.startswith("encoder.layers.4.layer.bias") for k in sd)
    params, stats, unmapped = convert_full_state_dict(
        {k: v.numpy() for k, v in sd.items()}, cfg.operation_order,
        lifter="v1")
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


def test_list_configs_and_full_width_values():
    """The port's config names, and the five full-width configs' values
    against the JAX package's, field by field where both have the field,
    the splat grid (box multiplier included) against ``splat_grid()``."""
    names = ("prob_gs6400", "prob_gs12800", "prob_gs25600", "gs144000",
             "gs25600_solid")
    assert list_configs() == sorted(list_configs())
    assert set(names) <= set(list_configs())
    for name in names:
        cfg, jcfg = get_config(name), jax_get_config(name)
        for f in dataclasses.fields(cfg):
            if (f.name in ("optim", "grid", "data")
                    or not hasattr(jcfg, f.name)):
                continue
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), \
                (name, f.name)
        assert dataclasses.asdict(cfg.optim) == dataclasses.asdict(jcfg.optim)
        for f in dataclasses.fields(cfg.data):
            assert getattr(cfg.data, f.name) == getattr(jcfg.data, f.name), \
                (name, f.name)
        assert cfg.input_size == jcfg.data.input_size
        assert cfg.num_cams == jcfg.data.num_cams
        jg = jcfg.splat_grid()
        assert dataclasses.asdict(cfg.grid) == dataclasses.asdict(jg), name
        assert cfg.operation_order == jcfg.operation_order
        assert cfg.total_anchors == jcfg.total_anchors


@pytest.mark.parametrize("name", ["gs25600_solid_tiny", "prob_gs6400_tiny"])
def test_seeded_init_keeps_the_configs_constants(name):
    """``build_segmentor``'s seeded init fills weights and BN statistics
    only: the modules' constant buffers (the fixed key point, the
    refinement's unit step, the empty Gaussian) keep the config's values,
    and the v1 lifter and ``empty_scalar`` get the reference's init."""
    cfg = get_config(name)
    model = build_segmentor(cfg, device="cpu", seed=3)
    consts = {n: b for n, b in model.named_buffers()
              if n.rsplit(".", 1)[-1] not in ("running_mean", "running_var",
                                              "num_batches_tracked")}
    fix = torch.tensor(cfg.fix_scale)
    for n, b in consts.items():
        if n.endswith("fix_scale"):
            assert torch.equal(b, fix), n
        if n.endswith("unit_xyz"):
            assert torch.equal(b, torch.tensor(cfg.unit_xyz)), n
    assert any(n.endswith("fix_scale") for n in consts)
    if cfg.version == 2:
        assert any(n.endswith("unit_xyz") for n in consts)
        return
    assert torch.equal(model.head.empty_mean, torch.tensor(cfg.empty_mean))
    assert torch.equal(model.head.empty_scale, torch.tensor(cfg.empty_scale))
    assert model.head.empty_scalar.item() == 10.0
    anchor = model.lifter.anchor.detach()
    assert torch.equal(anchor[:, 6:10], torch.tensor(
        [1.0, 0.0, 0.0, 0.0]).expand(cfg.num_anchor, 4))
    assert torch.all(anchor[:, 10] == 0.0)          # opacity 0.5
    assert anchor[:, :6].abs().max() <= 9.22        # logit of [1e-4, 0.9999]
    assert torch.sigmoid(anchor[:, :3]).std() > 0.2  # spread over the range
    assert torch.all(model.lifter.instance_feature == 0.0)
