"""Eval CLI of the port (eval.py): validation inference and mean IoU.

    python -m gaussianformer_tpu_torch.eval --config prob_gs6400 \
        --work-dir out/prob64 [--ckpt PATH | the work dir's latest] \
        [--synthetic] [--device cpu]

Prints ``mIoU: ..%  occupancy IoU: ..%``."""
from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("gaussianformer_tpu_torch")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gaussianformer_tpu_torch.eval")
    ap.add_argument("--config", default="prob_gs6400")
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--data-root", default="data/nuscenes")
    ap.add_argument("--anno-root", default="data/nuscenes_cam")
    ap.add_argument("--occ-path", default="data/surroundocc/samples")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-samples", type=int, default=0,
                    help="evaluate only the first N samples (0 = all)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Evaluate as the flags say and print the result; returns the
    Trainer (its ``last_counts`` are the counts behind the numbers)."""
    from .configs import get_config
    from .data import DataLoader, ShardedSampler
    from .device import resolve_device
    from .train.runner import Trainer, build_dataset, setup_logging
    from .utils.checkpoint import latest_checkpoint, load_checkpoint

    args = parse_args(argv)
    setup_logging(args.work_dir)
    device = resolve_device(args.device)
    cfg = get_config(args.config)
    val_ds = build_dataset(
        cfg, "val", synthetic=args.synthetic,
        num_samples=args.num_samples or 2, data_root=args.data_root,
        anno_root=args.anno_root, occ_path=args.occ_path)
    n = min(args.num_samples or len(val_ds), len(val_ds))
    val_loader = DataLoader(val_ds, cfg.data.batch_size,
                            sampler=ShardedSampler(n, shuffle=False),
                            num_workers=args.num_workers,
                            pin_memory=device.type == "cuda")
    try:
        trainer = Trainer(cfg, val_loader, val_loader, args.work_dir,
                          device=device)
        trainer.init_state(inference_only=True)
        ckpt = args.ckpt or latest_checkpoint(args.work_dir)
        if ckpt:
            trainer.model.load_state_dict(
                load_checkpoint(ckpt, map_location=device)["model"])
            logger.info("evaluating %s", ckpt)
        else:
            logger.warning("no checkpoint: evaluating the seeded random "
                           "weights")
        miou, occ_iou = trainer.evaluate()
    finally:
        val_loader.close()
    print(f"mIoU: {miou:.2f}%  occupancy IoU: {occ_iou:.2f}%")
    return trainer


if __name__ == "__main__":
    main()
