"""Model configs of the port, with the values of
gaussianformer_tpu/configs/nuscenes.py:

  - ``prob_gs6400``    GaussianFormer-2 Prob-64, the flagship
                       (reference config/prob/nuscenes_gs6400.py)
  - ``prob_gs12800``   GaussianFormer-2 Prob-128
  - ``prob_gs25600``   GaussianFormer-2 Prob-256
  - ``gs144000``       GaussianFormer baseline, 144000 anchors
                       (reference config/nuscenes_gs144000.py)
  - ``gs25600_solid``  GaussianFormer NonEmpty, 25600 anchors and the empty
                       Gaussian (reference config/nuscenes_gs25600_solid.py)

and a narrow ``*_tiny`` variant of each for the tests."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..ops.splat import SplatGridSpec

PC_RANGE = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)

# manual 18-class CE weights (reference config/nuscenes_gs144000.py:53-56)
MANUAL_CLASS_WEIGHT = (
    1.01552756, 1.06897009, 1.30013094, 1.07253735, 0.94637502, 1.10087012,
    1.26960524, 1.06258364, 1.189019, 1.06217292, 1.00595144, 0.85706115,
    1.03923299, 0.90867526, 0.8936431, 0.85486129, 0.8527829, 0.5,
)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """AdamW with a backbone lr multiplier, global-norm clipping and a
    linear-warm-up cosine schedule (reference prob config)."""
    lr: float = 4e-4
    weight_decay: float = 0.01
    backbone_lr_mult: float = 0.1
    grad_max_norm: float = 35.0
    warmup_iters: int = 500
    min_lr_ratio: float = 0.1
    max_epochs: int = 20


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The input pipeline (reference config data blocks): the batch, the
    augmentation limits of ``data.transforms.sample_augmentation`` and the
    image normalisation. The image size is the model's ``input_size``."""
    batch_size: int = 1
    resize_lim: Tuple[float, float] = (1.0, 1.0)
    rot_lim: Tuple[float, float] = (0.0, 0.0)
    rand_flip: bool = True
    img_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    img_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class GaussianFormerConfig:
    name: str
    version: int = 2                  # 1: GaussianFormer, 2: GaussianFormer-2
    embed_dims: int = 128
    num_decoder: int = 4
    semantic_dim: int = 17
    num_classes: int = 18
    include_opa: bool = True
    pc_range: Tuple[float, ...] = PC_RANGE
    scale_range: Tuple[float, float] = (0.01, 3.2)
    # cameras and images
    num_cams: int = 6
    input_size: Tuple[int, int] = (864, 1600)     # (H, W)
    # towers: both ResNets (main and lifter initializer)
    depth: int = 101
    base_channels: int = 64
    stage_with_dcn: Tuple[bool, ...] = (False, False, True, True)
    initializer_out_channels: Tuple[int, ...] = (128, 128, 128, 128)
    compute_dtype: str = "bfloat16"               # towers and necks
    # lifter
    num_anchor: int = 4000
    random_samples: int = 2400
    num_depth_samples: int = 128
    freeze_lifter: bool = True
    # encoder
    num_learnable_pts: int = 6
    learnable_fixed_scale: float = 6.0
    fix_scale: Tuple[Tuple[float, float, float], ...] = ((0.0, 0.0, 0.0),)
    unit_xyz: Tuple[float, float, float] = (4.0, 4.0, 1.0)
    restrict_xyz: bool = False                    # v1 refinement
    refine_manual: Optional[Tuple[int, ...]] = None
    semantics_activation: str = "identity"
    spconv_grid_size: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    spconv_use_out_proj: bool = True
    spconv_use_multi_layer: bool = True
    ffn_add_identity: bool = False
    ffn_in_channels: Optional[int] = None
    deformable_residual_mode: str = "none"
    ffn_drop: float = 0.1
    attn_drop: float = 0.15
    # head
    grid: SplatGridSpec = SplatGridSpec(H=200, W=200, D=16,
                                        pc_min=PC_RANGE[:3], grid_size=0.5,
                                        scale_multiplier=4.0)
    apply_loss_type: str = "random_1"
    empty_label: int = 17
    with_empty: bool = False
    empty_mean: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    empty_scale: Tuple[float, float, float] = (100.0, 100.0, 8.0)
    use_localaggprob: bool = True
    # per-axis splat radii (the reference's localagg_prob_fast) in place of
    # the isotropic ones from each Gaussian's largest scale
    use_localaggprob_fast: bool = False
    # False: the prob head's threshold label mode (argmax of the normalised
    # semantics where the occupancy exceeds 0.5, else the empty class)
    combine_geosem: bool = True
    # losses
    ce_weight: float = 10.0
    lovasz_weight: float = 1.0
    lovasz_use_softmax: bool = False
    use_pixel_distribution_loss: bool = True
    # training
    optim: OptimConfig = OptimConfig()
    data: DataConfig = DataConfig()

    @property
    def total_anchors(self) -> int:
        return self.num_anchor + self.random_samples

    @property
    def operation_order(self) -> Tuple[str, ...]:
        if self.version == 2:
            block = ("identity", "deformable", "add", "norm",
                     "identity", "ffn", "add", "norm",
                     "identity", "spconv", "add", "norm",
                     "identity", "ffn", "add", "norm",
                     "refine")
            return block * self.num_decoder
        first = ("deformable", "ffn", "norm", "refine")
        rest = ("spconv", "norm", "deformable", "ffn", "norm", "refine")
        return first + rest * (self.num_decoder - 1)

    @property
    def occ_resolution(self) -> Tuple[int, int, int]:
        return (self.grid.H, self.grid.W, self.grid.D)


def _prob_config(name, num_anchor, random_samples, scale_range,
                 scale_multiplier) -> GaussianFormerConfig:
    """A GaussianFormer-2 config: the image lifter's FPS anchors plus
    random ones, the GMM splat on the 0.5 m grid with the config's box
    multiplier."""
    return GaussianFormerConfig(
        name=name, num_anchor=num_anchor, random_samples=random_samples,
        scale_range=scale_range,
        grid=SplatGridSpec(H=200, W=200, D=16, pc_min=PC_RANGE[:3],
                           grid_size=0.5, scale_multiplier=scale_multiplier))


def _v1_config(name, **kw) -> GaussianFormerConfig:
    """What the two GaussianFormer (v1) configs share: a learnable anchor
    bank in place of the image lifter, 1 fixed + 2 learnable key points,
    the deformable output concatenated to the features and an FFN that
    projects the 256 channels back, one bias-free spconv layer on a 0.5 m
    grid, the additive splat with 3-sigma boxes, CE on logits with
    Lovasz-softmax and no pixel loss, lr 2e-4 with the lifter trained."""
    base = dict(
        version=1, random_samples=0, freeze_lifter=False,
        num_learnable_pts=2, learnable_fixed_scale=1.0, restrict_xyz=True,
        refine_manual=(0, 1, 2), spconv_grid_size=(0.5, 0.5, 0.5),
        spconv_use_multi_layer=False, ffn_add_identity=True,
        ffn_in_channels=256, deformable_residual_mode="cat",
        grid=SplatGridSpec(H=200, W=200, D=16, pc_min=PC_RANGE[:3],
                           grid_size=0.5, scale_multiplier=3.0),
        use_localaggprob=False, combine_geosem=False,
        lovasz_use_softmax=True, use_pixel_distribution_loss=False,
        optim=OptimConfig(lr=2e-4))
    base.update(kw)
    return GaussianFormerConfig(name=name, **base)


_GS144000 = _v1_config(
    "gs144000", num_anchor=144000, semantic_dim=18, include_opa=False,
    scale_range=(0.08, 0.32), unit_xyz=(2.0, 2.0, 0.5),
    spconv_use_out_proj=False, apply_loss_type="all")
_GS25600_SOLID = _v1_config(
    "gs25600_solid", num_anchor=25600, semantic_dim=17,
    scale_range=(0.08, 0.64), unit_xyz=(4.0, 4.0, 1.0),
    semantics_activation="softplus", apply_loss_type="random_1",
    with_empty=True)

# What the tiny v1 variants change: the narrow towers of prob_gs6400_tiny,
# two decoder blocks (so the spconv of the later blocks runs), 48 anchors, a
# 20x20x8 grid of 5 m voxels with scales up to 3.2 m (radii of 1-2 voxels)
# and a 1 m spconv grid.
_TINY_V1 = dict(
    embed_dims=32, num_decoder=2, input_size=(64, 96), depth=26,
    base_channels=8, stage_with_dcn=(False, False, False, True),
    compute_dtype="float32", num_anchor=48, scale_range=(0.4, 3.2),
    ffn_in_channels=64, spconv_grid_size=(1.0, 1.0, 1.0),
    grid=SplatGridSpec(H=20, W=20, D=8, pc_min=PC_RANGE[:3], grid_size=5.0,
                       scale_multiplier=3.0))

_CONFIGS = {
    # reference config/prob/nuscenes_gs{6400,12800,25600}.py
    "prob_gs6400": _prob_config("prob_gs6400", 4000, 2400, (0.01, 3.2), 4.0),
    "prob_gs12800": _prob_config("prob_gs12800", 6400, 6400, (0.01, 2.5),
                                 5.0),
    "prob_gs25600": _prob_config("prob_gs25600", 19200, 6400, (0.01, 1.8),
                                 4.0),
    "gs144000": _GS144000,
    "gs25600_solid": _GS25600_SOLID,
    "gs144000_tiny": dataclasses.replace(_GS144000, name="gs144000_tiny",
                                         **_TINY_V1),
    "gs25600_solid_tiny": dataclasses.replace(
        _GS25600_SOLID, name="gs25600_solid_tiny", **_TINY_V1),
    # The tiny variant of the tests: narrow towers (one bottleneck per
    # stage) with DCN in stage 4, one decoder block, 48 anchors, a 20x20x8
    # grid, fp32.
    "prob_gs6400_tiny": GaussianFormerConfig(
        name="prob_gs6400_tiny", embed_dims=32, num_decoder=1,
        input_size=(64, 96), depth=26, base_channels=8,
        stage_with_dcn=(False, False, False, True),
        initializer_out_channels=(8, 8, 8, 8), compute_dtype="float32",
        num_anchor=32, random_samples=16, num_depth_samples=8,
        num_learnable_pts=2,
        grid=SplatGridSpec(H=20, W=20, D=8, pc_min=PC_RANGE[:3],
                           grid_size=5.0, scale_multiplier=4.0)),
}


def get_config(name: str) -> GaussianFormerConfig:
    return _CONFIGS[name]


def list_configs():
    return sorted(_CONFIGS)
