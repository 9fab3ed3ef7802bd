"""``"loop": "frame"``: one client, closed loop. A frame is one
``BEVSegmentor.forward(..., occ_only=True)`` under ``inference_mode`` at
``batch`` samples, from a ring of ``ring`` distinct inputs and their
lifter draws; it ends when its label grid is on the host, and the next
starts then. ``warmup`` frames run in set-up, ``profile`` more after a
traced window. The frame checked is drawn from the seed among the
window's first ``ring`` frames."""
from __future__ import annotations

import gc
import time

import torch

from .. import synth, trace
from ..check import FrameCapture
from . import Window, build_kernels, build_program, peak, profile, sync


def run(cell, seconds, trace_on, t_start) -> Window:
    c, cfg, tr, seed, dev = (cell.c, cell.cfg, cell.traffic, cell.seed,
                             cell.device)
    build_kernels(dev)
    model = build_program(c, cfg, synth.make_state(cell.shapes, c, seed,
                                                   dev), dev)
    batch = tr["batch"]
    ring = synth.samples(c, tr["ring"], seed, dev, labels=False, batch=batch)
    draws = (synth.lifter_draws(c, tr["ring"], seed, dev, batch)
             if c["version"] == 2 else [None] * tr["ring"])
    checked = int(torch.randint(0, tr["ring"], (1,), generator=synth.generator(
        seed, synth.PICK, "cpu")))

    def frame(i):
        s = ring[i % len(ring)]
        with torch.inference_mode():
            out = model(s["imgs"], s["projection_mat"], s["image_wh"],
                        s["occ_xyz"], lifter_draws=draws[i % len(ring)],
                        occ_only=True)["final_occ"]
        return out.cpu()

    for i in range(tr["warmup"]):
        frame(i)
    sync(dev)
    capture = FrameCapture(model)
    spans = None
    if trace_on:
        spans = trace.Spans()
        for m in (model.img_backbone, model.img_neck):
            spans.forward(m, "towers")
        for name in ("lifter", "encoder", "head"):
            spans.forward(getattr(model, name), name)
        for mod in model.modules():
            if type(mod).__name__ == "DeformConv2d":
                spans.forward(mod, "dcn")
    setup_s = time.perf_counter() - t_start
    lat, kept = [], None
    t0 = time.perf_counter()
    i = 0
    # the window lasts ``seconds`` and reaches the checked frame
    while time.perf_counter() - t0 < seconds or i <= checked:
        ts = time.perf_counter()
        if i == checked:
            with capture.on():
                labels = frame(i)
            kept = labels
        else:
            labels = frame(i)
        lat.append(time.perf_counter() - ts)
        i += 1
    window = time.perf_counter() - t0
    frames = len(lat)
    lat_sorted = sorted(lat)
    p95 = lat_sorted[min(frames - 1, int(0.95 * frames))]
    metrics = {"frame_ms": 1e3 * window / frames,
               "frame_p95_ms": 1e3 * p95, "setup_s": setup_s}
    out = Window(metrics=metrics, attempted=frames, failed=0,
                 memory_peak_bytes=0)
    if trace_on:
        out.spans = spans.totals_ms()
        spans.remove()
        out.count, out.wall_s = frames, window
        out.profile = profile(frame, tr["profile"])
    out.memory_peak_bytes = peak(dev)
    out.check = {"capture": capture.data, "sample": ring[checked],
                 "draws": draws[checked], "labels": kept}
    del model, ring
    gc.collect()
    return out
