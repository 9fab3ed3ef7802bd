"""The PyTorch port's image towers against the JAX package on the CPU at
fp32: the main ResNet (caffe bottlenecks, DCNv2 in stages 3-4 with the
fused bn2+ReLU epilogue, frozen BN) + FPN, and the lifter's ResNet +
SECONDFPN initializer tower, at DEPTH=26, BASE=8 (as
tests/test_torch_parity_towers.py). Weights: the JAX init's tree filled
from a numpy seed, loaded through the port's converter."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussianformer_tpu.models.backbone.resnet import ResNet as JaxResNet
from gaussianformer_tpu.models.lifter.initializer import \
    ResNetSecondFPN as JaxInit
from gaussianformer_tpu.models.neck.fpn import FPN as JaxFPN

from gaussianformer_tpu_torch.models.backbone.resnet import ResNet
from gaussianformer_tpu_torch.models.lifter.initializer import \
    ResNetSecondFPN
from gaussianformer_tpu_torch.models.neck.fpn import FPN
from gaussianformer_tpu_torch.utils.convert import jax_to_state_dict
from test_torch_port_model import random_variables

DEPTH, BASE, EMBED = 26, 8, 32
DCN = (False, False, True, True)
TOL = 1e-4


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(2, 64, 96, 3).astype(np.float32)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


class _MainTower(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.img_backbone = ResNet(DEPTH, BASE, DCN)
        self.img_neck = FPN(self.img_backbone.out_channels, EMBED)

    def forward(self, x):
        return self.img_neck(self.img_backbone(x))


def test_main_tower_matches_jax():
    imgs = _images()
    backbone = JaxResNet(depth=DEPTH, base_channels=BASE,
                         stage_with_dcn=DCN, fuse_dcn_epilogue=True)
    neck = JaxFPN(out_channels=EMBED)

    def fwd(v, x):
        feats = backbone.apply(v["backbone"], x)
        return neck.apply(v["neck"], feats)

    key = jax.random.PRNGKey(0)
    vb = jax.eval_shape(backbone.init, key, imgs)
    feats = jax.eval_shape(backbone.apply, vb, imgs)
    vn = jax.eval_shape(neck.init, key, feats)
    vb, vn = random_variables(dict(vb), 0), random_variables(dict(vn), 1)
    ref = jax.jit(fwd)({"backbone": vb, "neck": vn}, imgs)
    sd = jax_to_state_dict({
        "params": {"img_backbone": vb["params"], "img_neck": vn["params"]},
        "batch_stats": {"img_backbone": vb["batch_stats"]}})
    port = _MainTower().eval()
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), rtol=TOL, atol=TOL)


def test_initializer_tower_matches_jax():
    imgs = _images(1)
    tower = JaxInit(depth=DEPTH, base_channels=BASE, stage_with_dcn=DCN,
                    out_channels=(8, 8, 8, 8), with_cp=False,
                    fuse_dcn_epilogue=True)
    v = random_variables(dict(jax.eval_shape(
        tower.init, jax.random.PRNGKey(0), imgs)), 2)
    ref = np.asarray(jax.jit(tower.apply)(v, imgs))
    sd = jax_to_state_dict({
        "params": {"lifter": {"initialize_backbone": v["params"]}},
        "batch_stats": {"lifter": {"initialize_backbone":
                                   v["batch_stats"]}}})
    port = ResNetSecondFPN(DEPTH, DCN, BASE, (8, 8, 8, 8),
                           dtype=torch.float32).eval()
    port.load_state_dict(_strip(sd, "lifter.initialize_backbone."))
    with torch.no_grad():
        got = port(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=TOL, atol=TOL)
