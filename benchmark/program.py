"""The program's own spans and counters in a ``--trace 1`` run
(``gaussianformer_tpu_torch/utils/profiling.py``), for the per-layer
metrics that read them.

:func:`stats` hands a metric's ``read(ctx)`` the program's ``collect()``
of one program-traced stretch, with its ``count`` of frames or steps, in
``ctx["program"]``. Where the context has none, the first such reader runs
the stretch, after the timed window, the benchmark's own spans and its
profiler stretch, which it leaves as they were: the cell's program and
inputs are made again from the run's ``--workload`` and ``--seed``, the
traffic's ``warmup`` frames (a train cell's ``checked`` steps) run untraced,
then one pass over the ring (``ring`` frames or steps) with the program's
tracing on and no profiler, then ``profile`` more under ``torch.profiler``
with the tracing still on, whose idle device time goes to the innermost
program span (a ``gf/<name>`` range) running at each gap's start, printed
to standard error as ``idle <span> <ms a frame or step>`` lines. A program
without the tracing module, a run without a workload on its command line
or a device other than CUDA gives None, and each reader then nothing."""
from __future__ import annotations

import argparse
import collections
import gc
import importlib.util
import sys
import time
import traceback
from typing import Optional

import torch

from . import synth, trace
from .loops import build_kernels, build_program

NO_SPAN = "none"


def stats(ctx: dict) -> Optional[dict]:
    """``ctx["program"]``, made once by :func:`traced_stretch` for the
    run's cell where the context has none."""
    if "program" not in ctx:
        ctx["program"] = None
        try:
            cell = _run_cell()
            if cell is not None:
                ctx["program"] = traced_stretch(cell)
        except Exception:  # the run's other metrics and its check go on
            traceback.print_exc()
            print("the program-traced stretch failed: its metrics not "
                  "measured", file=sys.stderr)
    return ctx["program"]


def per_call(ctx: dict, loop: str, span: str, key: str):
    """``key`` (``device_ms``, ``host_ms``) of the program's span ``span``
    a frame or step of a ``loop`` cell; None where not measured."""
    if ctx["loop"] != loop:
        return None
    p = stats(ctx)
    s = p and p["spans"].get(span)
    if not s or s[key] is None:
        return None
    return s[key] / p["count"]


def sync_host_ms(ctx: dict, loop: str):
    """Host ms a frame or step in the program's host reads (``sync/*``)."""
    if ctx["loop"] != loop:
        return None
    p = stats(ctx)
    if p is None:
        return None
    return sum(s["host_ms"] for k, s in p["spans"].items()
               if k.startswith("sync/")) / p["count"]


def _program_traces() -> bool:
    return importlib.util.find_spec(
        "gaussianformer_tpu_torch.utils.profiling") is not None


def _run_cell():
    """The cell of this run's command line, or None."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ns, _ = ap.parse_known_args(sys.argv[1:])
    if (ns.workload is None or ns.seed is None or not _program_traces()
            or not torch.cuda.is_available()):
        return None
    from .run import make_cell, spec
    return make_cell(spec(ns.workload)[0], ns.seed, "cuda")


def _frames(cell):
    """(run_one(i), warm-up count) of a frame cell: the frame loop's
    frame, on a program and ring made again from the seed."""
    c, tr, seed, dev = cell.c, cell.traffic, cell.seed, cell.device
    model = build_program(c, cell.cfg, synth.make_state(cell.shapes, c,
                                                        seed, dev), dev)
    ring = synth.samples(c, tr["ring"], seed, dev, labels=False,
                         batch=tr["batch"])
    draws = (synth.lifter_draws(c, tr["ring"], seed, dev, tr["batch"])
             if c["version"] == 2 else [None] * tr["ring"])

    def frame(i):
        s = ring[i % len(ring)]
        with torch.inference_mode():
            out = model(s["imgs"], s["projection_mat"], s["image_wh"],
                        s["occ_xyz"], lifter_draws=draws[i % len(ring)],
                        occ_only=True)["final_occ"]
        return out.cpu()
    return frame, tr["warmup"]


def _steps(cell):
    """(run_one(i), warm-up count) of a train cell: ``train_step`` on a
    program, AdamW and ring made again from the seed."""
    from gaussianformer_tpu_torch.train.optim import build_optimizer
    from gaussianformer_tpu_torch.train.step import build_loss, train_step
    c, tr, seed, dev = cell.c, cell.traffic, cell.seed, cell.device
    model = build_program(c, cell.cfg, synth.make_state(cell.shapes, c,
                                                        seed, dev), dev)
    opt, schedule = build_optimizer(model, cell.cfg, tr["schedule_steps"])
    loss_fn = build_loss(cell.cfg)
    ring = synth.samples(c, tr["ring"], seed, dev, labels=True,
                         batch=tr["batch"])
    gen = synth.generator(seed, synth.DROPOUT, dev)

    def step(i):
        train_step(model, opt, schedule, loss_fn, ring[i % len(ring)], gen)
    return step, tr["checked"]


def traced_stretch(cell) -> Optional[dict]:
    """The program's ``collect()`` over one pass of the cell's ring, with
    ``count`` (its frames or steps), ``wall_s`` (its host time) and
    ``idle`` (idle device ms a frame or step by program span, from the
    profiled frames or steps after it; empty where the profiler recorded
    no device operation or on the CPU)."""
    from gaussianformer_tpu_torch.utils import profiling
    cuda = torch.device(cell.device).type == "cuda"
    build_kernels(cell.device)
    one, warm = (_frames if cell.traffic["loop"] == "frame"
                 else _steps)(cell)
    try:
        for i in range(warm):
            one(i)
        _sync(cuda)
        count = cell.traffic["ring"]
        profiling.enable()
        t0 = time.perf_counter()
        for i in range(count):
            one(warm + i)
        _sync(cuda)
        wall = time.perf_counter() - t0
        profiling.disable()
        out = dict(profiling.collect(), count=count, wall_s=wall, idle={})
        profiled = cell.traffic.get("profile", 0)
        if cuda and profiled:
            out["idle"] = _idle(one, warm + count, profiled, profiling)
            for name, ms in sorted(out["idle"].items(), key=lambda kv:
                                   -kv[1]):
                print(f"idle {name} {ms!r}", file=sys.stderr)
    finally:
        profiling.disable()
        del one
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()


def _idle(one, first: int, count: int, profiling) -> dict:
    """Idle device ms a frame or step by the innermost program span
    running at each gap's start, over ``count`` calls of ``one`` under
    ``torch.profiler`` with the program's tracing on."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    profiling.enable()
    with torch.profiler.profile(activities=act) as prof:
        for i in range(count):
            one(first + i)
        torch.cuda.synchronize()
    profiling.disable()
    return {k: v / count for k, v in idle_by_span(prof).items()}


def idle_by_span(prof) -> dict:
    """Idle device ms between the device operations of a profiler's
    events, by the innermost ``gf/<name>`` host range running at each
    gap's start (:data:`NO_SPAN` outside every one)."""
    dev = sorted(trace._device_events(prof),
                 key=lambda e: e.time_range.start)
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name.startswith("gf/")]
    idle = collections.defaultdict(float)
    if not dev:
        return idle
    end = dev[0].time_range.end
    for e in dev[1:]:
        if e.time_range.start > end:
            inside = [s for s in spans
                      if s.time_range.start <= end <= s.time_range.end]
            name = (min(inside, key=lambda s: s.time_range.elapsed_us())
                    .name[3:] if inside else NO_SPAN)
            idle[name] += (e.time_range.start - end) / 1e3
        end = max(end, e.time_range.end)
    return dict(idle)
