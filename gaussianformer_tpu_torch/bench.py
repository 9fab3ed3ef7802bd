"""The port's bench (bench.py): frames per second of the flagship
``prob_gs6400`` forward (GaussianFormer-2 Prob-64, 6 x 864 x 1600 images,
6400 Gaussians, the 200 x 200 x 16 grid) on one GPU, on the synthetic
flagship batch with the seed-0 weights of ``build_segmentor``, under
``torch.inference_mode()``.

    python -m gaussianformer_tpu_torch.bench [--batch N] [--pipeline K]

One warm-up forward and a host read of ``final_occ[:, :8]``, then 10
forwards between two CUDA events, ended by another such read. ``#`` lines
give the setup and warm-up times and the card's name and power limit; the
last line is bench.py's JSON: ``metric`` (``prob_gs6400_infer_fps_per_chip``,
``_b{N}`` for batch N > 1), ``value`` in frames/s, ``unit`` and
``vs_baseline`` against 10 frames/s. :func:`run` also takes another config
and the CPU (the tests' tiny runs); its metric then names the config, and
a CPU run's ends in ``_cpu`` in place of ``_per_chip``.

``--pipeline K`` also times K forwards captured into one CUDA graph
(:func:`pipeline`), printed as ``# pipeline(K): X ms/frame = Y frames/s``
before the JSON line, whose metric stays the per-frame loop's. It needs
the card; on the CPU it raises.
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


def pipeline(model, data, k: int) -> dict:
    """K forwards of ``model`` captured into one ``torch.cuda.CUDAGraph``
    and replayed: one replay warms, one is timed between CUDA events. Each
    frame has its own static images, ``data["imgs"] + i * 1e-3`` (identical
    inputs would let work be left out of the count, as the root bench.py
    notes), and its own lifter draws made before the capture from
    generators seeded i (``GaussianLifterV2.draw``). Everything runs once
    before the capture, on a side stream (the kernels' first build, cuDNN's
    choices, the forward's constants); the splat bins' flag words are read
    after the replays (``kernels.splat.check_deferred_flags``). The launch
    counters count the warm-up and the capture, not the replays. Returns
    ms a frame, the replay's ``final_occ`` of each frame and ``frame(i)``,
    the same forward run eagerly."""
    from .kernels import splat
    imgs = [data["imgs"] + i * 1e-3 for i in range(k)]
    draws = [model.lifter.draw(im, torch.Generator(
        device=im.device).manual_seed(i)) for i, im in enumerate(imgs)]

    def frame(i):
        with torch.inference_mode():
            return model(imgs[i], data["projection_mat"], data["image_wh"],
                         data["occ_xyz"], lifter_draws=draws[i],
                         occ_only=True)["final_occ"]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(k):
            frame(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    splat.DEFERRED_FLAGS.clear()
    with torch.cuda.graph(graph):
        outs = [frame(i) for i in range(k)]
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    splat.check_deferred_flags()
    return dict(ms=start.elapsed_time(end) / k, outs=outs, frame=frame,
                graph=graph)


def run(config: str = "prob_gs6400", batch: int = 1, device="cuda",
        pipeline_frames: int = 0, on_pipeline=None) -> Tuple[dict, float]:
    """Time ``config``'s forward at ``batch`` on ``device`` (CUDA unless
    the caller asks for the CPU), print the ``#`` lines and then the JSON
    line. With ``pipeline_frames`` K, also time K frames as one CUDA graph
    (:func:`pipeline`; the CPU raises) and hand its result to
    ``on_pipeline`` where given. Returns (the JSON record, ms a forward)."""
    from .configs import get_config
    from .data.synthetic import synthetic_batch
    from .device import resolve_device
    from .models.segmentor import build_segmentor

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if pipeline_frames and not cuda:
        raise RuntimeError("--pipeline captures a CUDA graph: it needs a "
                           "CUDA device, and has no CPU version")
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
    if pipeline_frames:
        piped = pipeline(model, data, pipeline_frames)
        print(f"# pipeline({pipeline_frames}): {piped['ms']:.3f} ms/frame = "
              f"{batch / (piped['ms'] / 1e3):.3f} frames/s (one CUDA graph "
              f"replay, CUDA events)", flush=True)
        if on_pipeline is not None:
            on_pipeline(piped)
        del piped
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
    ap.add_argument("--pipeline", type=int, default=0, metavar="K",
                    help="also time K forwards captured into one CUDA graph "
                         "(a '#' line; the JSON line stays the loop's)")
    args = ap.parse_args(argv)
    run("prob_gs6400", args.batch, "cuda", args.pipeline)


if __name__ == "__main__":
    main()
