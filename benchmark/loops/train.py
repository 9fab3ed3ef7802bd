"""``"loop": "train"``: the program's ``train_step`` at ``batch`` samples
over a ring of ``ring`` distinct samples, back to back, with one
synchronise at the end of the window. Set-up builds the step (weights,
AdamW in the configuration's groups, its schedule over
``schedule_steps``, the losses) and drives it through its first
``checked`` steps, which the reference follows; the window goes on from
there. ``profile`` more steps run after a traced window."""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from .. import synth, trace
from ..check import FrameCapture, GradCapture, moved
from . import (DrawRecorder, Window, build_kernels, build_program, peak,
               profile, sync)


def run(cell, seconds, trace_on, t_start) -> Window:
    c, cfg, tr, seed, dev = (cell.c, cell.cfg, cell.traffic, cell.seed,
                             cell.device)
    from gaussianformer_tpu_torch.train.optim import build_optimizer
    from gaussianformer_tpu_torch.train.step import build_loss, train_step
    build_kernels(dev)
    model = build_program(c, cfg, synth.make_state(cell.shapes, c, seed,
                                                   dev), dev)
    opt, schedule = build_optimizer(model, cfg, tr["schedule_steps"])
    loss_fn = build_loss(cfg)
    ring = synth.samples(c, tr["ring"], seed, dev, labels=True,
                         batch=tr["batch"])
    gen = synth.generator(seed, synth.DROPOUT, dev)
    names = {p: k for k, p in model.named_parameters()}
    trained = [p for g in opt.param_groups for p in g["params"]]

    sut = {"loss": [], "grad_norm": [], "draws": [], "xyz": []}
    start = {names[p]: p.detach().clone() for p in trained}
    grads = GradCapture(model)
    for s in range(tr["checked"]):
        rec = DrawRecorder(gen)
        capture = FrameCapture(model, detach=True)
        with rec, capture.on(), (grads.on() if s == 0 else
                                 contextlib.nullcontext()):
            m = train_step(model, opt, schedule, loss_fn, ring[s], gen)
        sut["loss"].append(m["loss"].item())
        sut["grad_norm"].append(m["grad_norm"].item())
        sut["draws"].append(rec.draws)
        sut["xyz"].append(capture.data["anchor"][:, :c["num_anchor"], :3]
                          .clone() if c["version"] == 2 else None)
        if s == 0:
            sut["stages"] = capture.data
            sut["grads"] = grads.data
            beta1 = opt.param_groups[0]["betas"][0]
            sut["grad"] = {names[p]: opt.state[p]["exp_avg"].detach()
                           / (1 - beta1) for p in trained
                           if p in opt.state}
    sut["change"] = {names[p]: p.detach() - start[names[p]]
                     for p in trained}
    del start, capture, grads
    sync(dev)
    setup_peak = peak(dev)
    # what the comparison reads waits on the host, so that the window's
    # peak is the program's and its inputs'
    sut = moved(sut, "cpu")

    spans = None
    if trace_on:
        spans = trace.Spans()
        spans.optimizer(opt, "update")
        for mod in model.modules():
            if type(mod).__name__ == "DeformConv2d":
                spans.forward(mod, "dcn")
                spans.backward(mod, "dcn")
        real_loss = loss_fn

        def loss_fn(out, _real=real_loss):
            res = _real(out)
            spans.open("backward")
            return res

        spans.until_step(opt, "backward", "backward")

    setup_s = time.perf_counter() - t_start
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    results = []
    t0 = time.perf_counter()
    i = tr["checked"]
    while time.perf_counter() - t0 < seconds:
        results.append(train_step(model, opt, schedule, loss_fn,
                                  ring[i % len(ring)], gen))
        i += 1
    sync(dev)
    window = time.perf_counter() - t0
    steps = len(results)
    window_peak = peak(dev)
    finite = torch.stack([r["loss"] for r in results]).isfinite()
    failed = int((~finite).sum())
    metrics = {"step_ms": 1e3 * window / steps,
               "train_peak_gib": window_peak / 2 ** 30, "setup_s": setup_s}
    out = Window(metrics=metrics, attempted=steps, failed=failed,
                 memory_peak_bytes=max(window_peak, setup_peak))
    if trace_on:
        out.spans = spans.totals_ms()
        spans.remove()
        out.count, out.wall_s = steps, window

        def one(j):
            train_step(model, opt, schedule, loss_fn,
                       ring[(i + j) % len(ring)], gen)
        out.profile = profile(one, tr["profile"])
    out.check = {"sut": sut, "ring": ring}
    del model, opt, results
    gc.collect()
    return out
