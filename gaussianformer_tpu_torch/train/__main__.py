"""Train CLI of the port (train.py):

    python -m gaussianformer_tpu_torch.train --config prob_gs6400 \
        --work-dir out/prob64 --data-root data/nuscenes \
        --anno-root data/nuscenes_cam --occ-path data/surroundocc/samples

``--synthetic`` trains on random data (a smoke test of the pipeline);
``--device cpu`` runs the plain PyTorch versions on the CPU (with a tiny
config such as ``prob_gs6400_tiny``). The pretrains load first, then the
newest checkpoint of the work dir, if any, and training resumes from it."""
from __future__ import annotations

import argparse
import dataclasses


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gaussianformer_tpu_torch.train")
    ap.add_argument("--config", default="prob_gs6400")
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--data-root", default="data/nuscenes")
    ap.add_argument("--anno-root", default="data/nuscenes_cam")
    ap.add_argument("--occ-path", default="data/surroundocc/samples")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-epochs", type=int, default=None,
                    help="epochs to train (default: the config's)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthetic-samples", type=int, default=8)
    ap.add_argument("--print-freq", type=int, default=50)
    ap.add_argument("--num-workers", type=int, default=4,
                    help="data-loading worker processes (0: load in this "
                         "process)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iter-resume", action="store_true",
                    help="also checkpoint every 50 iterations, for a "
                         "mid-epoch resume")
    ap.add_argument("--backbone-pretrain", default=None,
                    help="torch checkpoint of the backbone and neck "
                         "(r101_dcn_fcos3d_pretrain.pth)")
    ap.add_argument("--lifter-init-ckpt", default=None,
                    help="torch checkpoint of the v2 lifter's initializer "
                         "(init.pth)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Train as the flags say; returns the Trainer."""
    from ..configs import get_config
    from ..data import DataLoader, ShardedSampler
    from ..device import resolve_device
    from .runner import Trainer, build_dataset, setup_logging

    args = parse_args(argv)
    setup_logging(args.work_dir)
    device = resolve_device(args.device)
    cfg = get_config(args.config)
    if args.max_epochs is not None:
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
            cfg.optim, max_epochs=args.max_epochs))
    batch_size = args.batch_size or cfg.data.batch_size
    files = dict(synthetic=args.synthetic, data_root=args.data_root,
                 anno_root=args.anno_root, occ_path=args.occ_path)
    train_ds = build_dataset(cfg, "train", seed=args.seed,
                             num_samples=args.synthetic_samples, **files)
    val_ds = build_dataset(cfg, "val", num_samples=2, **files)
    loader = dict(num_workers=args.num_workers,
                  pin_memory=device.type == "cuda")
    train_loader = DataLoader(train_ds, batch_size, sampler=ShardedSampler(
        len(train_ds), shuffle=True, seed=args.seed), **loader)
    val_loader = DataLoader(val_ds, batch_size, sampler=ShardedSampler(
        len(val_ds), shuffle=False), **loader)
    try:
        trainer = Trainer(cfg, train_loader, val_loader, args.work_dir,
                          seed=args.seed, print_freq=args.print_freq,
                          iter_resume=args.iter_resume, device=device)
        if args.backbone_pretrain or args.lifter_init_ckpt:
            trainer.init_state()
            trainer.load_torch_pretrained(args.backbone_pretrain,
                                          args.lifter_init_ckpt)
            trainer.try_resume()
        trainer.fit()
    finally:
        train_loader.close()
        val_loader.close()
    return trainer


if __name__ == "__main__":
    main()
