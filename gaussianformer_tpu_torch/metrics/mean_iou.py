"""Mean IoU over the semantic classes and the binary occupancy IoU
(gaussianformer_tpu/metrics/mean_iou.py, reference misc/metric_util.py:9-111:
classes 1-16, empty label 17, the camera-visibility mask).

The counts of a batch are made on the tensors' device and read on the
host later: :meth:`MeanIoU.counts_for` queues them behind the forward,
:meth:`MeanIoU.add_counts` reads them. An eval loop reads batch n's counts
after queueing batch n+1's forward, so the device never waits for the
host between batches."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

NUSC_LABELS = [
    "barrier", "bicycle", "bus", "car", "construction_vehicle", "motorcycle",
    "pedestrian", "traffic_cone", "trailer", "truck", "driveable_surface",
    "other_flat", "sidewalk", "terrain", "manmade", "vegetation",
]


def iou_counts(outputs: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor, class_indices: Sequence[int],
               empty_label: int) -> torch.Tensor:
    """Per class (seen, correct, positive) and the same for occupied (not
    ``empty_label``) voxels, over the voxels where ``mask`` holds.
    outputs / targets: [N] integers; mask: [N] bool. Returns [C + 1, 3]
    int64 on their device."""
    cls = torch.as_tensor(class_indices, device=outputs.device)[:, None]
    t = (targets[None] == cls) & mask
    o = (outputs[None] == cls) & mask
    per = torch.stack([t.sum(1), (t & o).sum(1), o.sum(1)], dim=1)
    t_occ = (targets != empty_label) & mask
    o_occ = (outputs != empty_label) & mask
    occ = torch.stack([t_occ.sum(), (t_occ & o_occ).sum(), o_occ.sum()])
    return torch.cat([per, occ[None]]).long()


def compute_iou(counts):
    """counts: [C + 1, 3] -> (mIoU %, occupancy IoU %, per-class IoUs). A
    class never seen gets IoU 1 (reference metric_util.py:92-95)."""
    counts = np.asarray(counts, np.float64)
    seen, correct, positive = counts[:-1, 0], counts[:-1, 1], counts[:-1, 2]
    union = seen + positive - correct
    ious = np.where(seen == 0, 1.0, correct / np.maximum(union, 1e-12))
    occ_seen, occ_corr, occ_pos = counts[-1]
    occ_iou = occ_corr / max(occ_seen + occ_pos - occ_corr, 1e-12)
    return float(np.mean(ious) * 100.0), float(occ_iou * 100.0), ious


class MeanIoU:
    """Accumulates counts on the host (int64) from batches' device counts."""

    def __init__(self, class_indices: Optional[Sequence[int]] = None,
                 empty_label: int = 17,
                 label_str: Optional[Sequence[str]] = None,
                 use_mask: bool = True):
        self.class_indices = list(class_indices or range(1, 17))
        self.empty_label = empty_label
        self.label_str = list(label_str or NUSC_LABELS)
        self.use_mask = use_mask
        self.reset()

    def reset(self):
        self.counts = np.zeros((len(self.class_indices) + 1, 3), np.int64)

    def counts_for(self, outputs, targets, mask=None) -> torch.Tensor:
        """Queue one sample's counts on the device; no host read."""
        outputs, targets = outputs.reshape(-1), targets.reshape(-1)
        if mask is None or not self.use_mask:
            mask = torch.ones_like(outputs, dtype=torch.bool)
        return iou_counts(outputs, targets, mask.reshape(-1).bool(),
                          self.class_indices, self.empty_label)

    def add_counts(self, counts: torch.Tensor):
        """Add a :meth:`counts_for` result (reads it on the host)."""
        self.counts += counts.cpu().numpy()

    def update(self, outputs, targets, mask=None):
        self.add_counts(self.counts_for(outputs, targets, mask))

    def result(self, distributed: bool = False):
        """(mIoU %, occupancy IoU %, per-class IoUs); ``distributed`` sums
        the int64 counts over the process group first (reference
        dist.all_reduce, metric_util.py:69-73)."""
        counts = self.counts
        if distributed:
            from ..parallel.distributed import all_reduce_sum_host
            counts = all_reduce_sum_host(counts)
        return compute_iou(counts)
