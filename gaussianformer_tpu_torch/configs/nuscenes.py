"""Model configs of the port: the flagship ``prob_gs6400`` (GaussianFormer-2
Prob-64, reference config/prob/nuscenes_gs6400.py, as in
gaussianformer_tpu/configs/nuscenes.py) and ``prob_gs6400_tiny``, its
narrow test variant."""
from __future__ import annotations

import dataclasses
from typing import Tuple

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
class GaussianFormerConfig:
    name: str
    embed_dims: int = 128
    num_decoder: int = 4
    semantic_dim: int = 17
    num_classes: int = 18
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
    spconv_grid_size: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    ffn_drop: float = 0.1
    attn_drop: float = 0.15
    # head
    grid: SplatGridSpec = SplatGridSpec(H=200, W=200, D=16,
                                        pc_min=PC_RANGE[:3], grid_size=0.5,
                                        scale_multiplier=4.0)
    apply_loss_type: str = "random_1"
    empty_label: int = 17
    # losses
    ce_weight: float = 10.0
    lovasz_weight: float = 1.0
    lovasz_use_softmax: bool = False
    use_pixel_distribution_loss: bool = True
    # training
    optim: OptimConfig = OptimConfig()

    @property
    def total_anchors(self) -> int:
        return self.num_anchor + self.random_samples

    @property
    def operation_order(self) -> Tuple[str, ...]:
        block = ("identity", "deformable", "add", "norm",
                 "identity", "ffn", "add", "norm",
                 "identity", "spconv", "add", "norm",
                 "identity", "ffn", "add", "norm",
                 "refine")
        return block * self.num_decoder

    @property
    def occ_resolution(self) -> Tuple[int, int, int]:
        return (self.grid.H, self.grid.W, self.grid.D)


_CONFIGS = {
    "prob_gs6400": GaussianFormerConfig(name="prob_gs6400"),
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
