"""The port's bench (bench.py): frames per second of the flagship
``prob_gs6400`` forward (GaussianFormer-2 Prob-64, 6 x 864 x 1600 images,
6400 Gaussians, the 200 x 200 x 16 grid) on one GPU, on the synthetic
flagship batch with the seed-0 weights of ``build_segmentor``, under
``torch.inference_mode()``.

    python -m gaussianformer_tpu_torch.bench [--batch N]

One warm-up forward and a host read of ``final_occ[:, :8]``, then 10
forwards between two CUDA events, ended by another such read. ``#`` lines
give the setup and warm-up times and the card's name and power limit; the
last line is bench.py's JSON: ``metric`` (``prob_gs6400_infer_fps_per_chip``,
``_b{N}`` for batch N > 1), ``value`` in frames/s, ``unit`` and
``vs_baseline`` against 10 frames/s. :func:`run` also takes another config
and the CPU (the tests' tiny runs); its metric then names the config, and
a CPU run's ends in ``_cpu`` in place of ``_per_chip``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Tuple

import torch

BASELINE_FPS = 10.0
ITERS = 10


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"
    return out.stdout.strip().splitlines()[0]


def run(config: str = "prob_gs6400", batch: int = 1, device="cuda"
        ) -> Tuple[dict, float]:
    """Time ``config``'s forward at ``batch`` on ``device`` (CUDA unless
    the caller asks for the CPU), print the ``#`` lines and then the JSON
    line. Returns (the JSON record, ms a forward)."""
    from .configs import get_config
    from .data.synthetic import synthetic_batch
    from .device import resolve_device
    from .models.segmentor import build_segmentor

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    t_start = time.perf_counter()
    cfg = get_config(config)
    g = cfg.grid
    model = build_segmentor(cfg, device=dev, seed=0)
    data = synthetic_batch(batch, cfg.input_size, (g.H, g.W, g.D), seed=0,
                           device=dev)
    # the per-forward generators are made before the timed loop
    gens = [torch.Generator(device=dev).manual_seed(i)
            for i in range(ITERS + 1)]

    def forward(gen):
        with torch.inference_mode():
            return model(data["imgs"], data["projection_mat"],
                         data["image_wh"], data["occ_xyz"], generator=gen,
                         occ_only=True)["final_occ"]

    print(f"# setup {time.perf_counter() - t_start:.1f}s ({config}, batch "
          f"{batch}, {dev})", flush=True)
    forward(gens[0])[:, :8].cpu()
    print(f"# warm-up {time.perf_counter() - t_start:.1f}s", flush=True)
    print(f"# card: {card_line() if cuda else 'none, a CPU run'}", flush=True)

    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(ITERS):
            out = forward(gens[1 + i])
        end.record()
        out[:, :8].cpu()
        ms = start.elapsed_time(end) / ITERS
    else:
        t0 = time.perf_counter()
        for i in range(ITERS):
            out = forward(gens[1 + i])
        out[:, :8].cpu()
        ms = (time.perf_counter() - t0) * 1e3 / ITERS
    fps = batch / (ms / 1e3)
    print(f"# {ms:.3f} ms a forward of batch {batch}, {ITERS} forwards "
          f"({'CUDA events' if cuda else 'host clock, CPU'})", flush=True)
    metric = f"{config}_infer_fps_{'per_chip' if cuda else 'cpu'}"
    if batch > 1:
        metric += f"_b{batch}"
    record = {"metric": metric, "value": round(fps, 3), "unit": "frames/s",
              "vs_baseline": round(fps / BASELINE_FPS, 3)}
    print(json.dumps(record), flush=True)
    return record, ms


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gaussianformer_tpu_torch.bench")
    ap.add_argument("--batch", type=int, default=1)
    run("prob_gs6400", ap.parse_args(argv).batch, "cuda")


if __name__ == "__main__":
    main()
