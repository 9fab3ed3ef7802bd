"""Visualization CLI of the port (visualize.py): validation inference and,
per frame, the predicted and ground-truth occupancy and the refined
Gaussians, rendered by ``utils/vis.py``.

    python -m gaussianformer_tpu_torch.visualize --config prob_gs6400 \\
        --work-dir out/prob64 [--ckpt PATH | the work dir's latest] \\
        [--num-samples 2] [--synthetic] [--scatter3d] [--device cpu]

Writes ``frame{i:04d}_pred.png``, ``_gt.png``, ``_gaussians.png`` (top
down) and ``_gaussians3d.png`` under ``<work-dir>/vis``. Without a
checkpoint the model keeps the seeded random weights of
``build_segmentor``. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import logging
import os

logger = logging.getLogger("gaussianformer_tpu_torch")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m gaussianformer_tpu_torch.visualize")
    ap.add_argument("--config", default="prob_gs6400")
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--data-root", default="data/nuscenes")
    ap.add_argument("--anno-root", default="data/nuscenes_cam")
    ap.add_argument("--occ-path", default="data/surroundocc/samples")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-samples", type=int, default=2)
    ap.add_argument("--scatter3d", action="store_true",
                    help="3D scatter render instead of top-down")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Render as the flags say; returns the paths written."""
    import torch

    from .configs import get_config
    from .data import DataLoader, ShardedSampler
    from .device import resolve_device
    from .models.segmentor import build_segmentor
    from .train.runner import build_dataset, setup_logging
    from .utils.checkpoint import latest_checkpoint, load_checkpoint
    from .utils.vis import save_gaussian, save_gaussian_topdown, save_occ

    args = parse_args(argv)
    device = resolve_device(args.device)
    setup_logging(args.work_dir)
    cfg = get_config(args.config)
    out_dir = os.path.join(args.work_dir, "vis")
    os.makedirs(out_dir, exist_ok=True)
    ds = build_dataset(cfg, "val", synthetic=args.synthetic,
                       num_samples=args.num_samples,
                       data_root=args.data_root, anno_root=args.anno_root,
                       occ_path=args.occ_path)
    n = min(args.num_samples, len(ds))
    loader = DataLoader(ds, 1, sampler=ShardedSampler(n, shuffle=False))
    model = build_segmentor(cfg, device=device, seed=0)
    ckpt = args.ckpt or latest_checkpoint(args.work_dir)
    if ckpt:
        model.load_state_dict(load_checkpoint(ckpt, map_location=device)
                              ["model"])
        logger.info("visualizing %s", ckpt)
    else:
        logger.warning("no checkpoint: visualizing the seeded random "
                       "weights")

    g = cfg.grid
    view = "scatter3d" if args.scatter3d else "topdown"
    written = []
    try:
        for i, batch in enumerate(loader):
            b = {k: v.to(device) for k, v in batch.items()}
            gen = torch.Generator(device=device).manual_seed(0)
            with torch.inference_mode():
                out = model(b["imgs"], b["projection_mat"], b["image_wh"],
                            b["occ_xyz"], generator=gen)
            pred = out["final_occ"][0].reshape(g.H, g.W, g.D).cpu().numpy()
            gs = out["gaussian"]
            means, scales, sem = (t[0].float().cpu().numpy() for t in (
                gs.means, gs.scales, gs.semantics))
            opa = (gs.opacities[0].float().cpu().numpy()
                   if gs.opacities.shape[-1] else None)
            stem = os.path.join(out_dir, f"frame{i:04d}")
            written += [
                save_occ(f"{stem}_pred.png", pred, view=view,
                         title=f"pred {i}"),
                save_occ(f"{stem}_gt.png", batch["occ_label"][0].numpy(),
                         view=view, title=f"gt {i}"),
                save_gaussian_topdown(f"{stem}_gaussians.png", means, scales,
                                      sem, opacities=opa,
                                      pc_range=cfg.pc_range),
                save_gaussian(f"{stem}_gaussians3d.png", means, scales,
                              gs.rotations[0].float().cpu().numpy(), sem,
                              opacities=opa, pc_range=cfg.pc_range)]
            print(f"rendered frame {i} -> {out_dir}", flush=True)
    finally:
        loader.close()
    return written


if __name__ == "__main__":
    main()
