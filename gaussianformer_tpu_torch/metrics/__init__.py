"""Evaluation metrics (gaussianformer_tpu/metrics/)."""
from .mean_iou import MeanIoU, compute_iou, iou_counts

__all__ = ["MeanIoU", "compute_iou", "iou_counts"]
