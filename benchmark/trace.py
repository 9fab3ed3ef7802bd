"""Spans and the device trace of a ``--trace 1`` run, recorded from the
benchmark's own files: CUDA events around module calls (forward hooks
and, in a train step, full-backward hooks), around the optimizer's step
(its step hooks) and after the losses, and a ``torch.profiler`` stretch
of a few frames or steps at the end of the run."""
from __future__ import annotations

import collections

import torch


class Spans:
    """CUDA events in pairs, summed per span name (``StageTimer`` of the
    program's ``profile_forward.py``, copied)."""

    def __init__(self):
        self.pairs = collections.defaultdict(list)
        self._open = {}
        self._handles = []

    def _mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def open(self, key):
        self._open[key] = self._mark()

    def close(self, key, name):
        start = self._open.pop(key, None)
        if start is not None:
            self.pairs[name].append((start, self._mark()))

    def forward(self, module, name):
        """A span ``name`` around every forward call of ``module``."""
        key = ("fwd", id(module))
        self._handles += [
            module.register_forward_pre_hook(lambda m, a: self.open(key)),
            module.register_forward_hook(
                lambda m, a, o: self.close(key, name))]

    def backward(self, module, name):
        """A span ``name`` from the gradient of ``module``'s output to
        that of its input."""
        key = ("bwd", id(module))
        self._handles += [
            module.register_full_backward_pre_hook(
                lambda m, g: self.open(key)),
            module.register_full_backward_hook(
                lambda m, gi, go: self.close(key, name))]

    def optimizer(self, opt, name):
        key = ("opt", id(opt))
        self._handles += [
            opt.register_step_pre_hook(lambda o, a, k: self.open(key)),
            opt.register_step_post_hook(
                lambda o, a, k: self.close(key, name))]

    def until_step(self, opt, key, name):
        """Close the span opened as ``key`` under ``name`` when ``opt``'s
        step begins."""
        self._handles.append(opt.register_step_pre_hook(
            lambda o, a, k: self.close(key, name)))

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []

    def totals_ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.pairs.items()}


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.time_range.elapsed_us() > 0]


def _host_ops(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and not e.name.startswith(("cuda", "ProfilerStep"))]


def summarise(prof, wall_s: float) -> dict:
    """From a profiler's events: ``busy_s`` (the union of the device
    operations' intervals), ``window_s`` (``wall_s``, the stretch's host
    time), the ten device operations with the most time and the ten
    longest idle gaps, each named by the innermost host operation running
    at its start. ``busy_s`` is None when the profiler recorded no device
    operation."""
    dev = sorted(_device_events(prof), key=lambda e: e.time_range.start)
    if not dev:
        return {"busy_s": None, "window_s": wall_s}
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0].time_range.start, dev[0].time_range.end
    for e in dev[1:]:
        s, t = e.time_range.start, e.time_range.end
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us()
    host = _host_ops(prof)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = []
    for start, end in gaps[:10]:
        inside = [h for h in host
                  if h.time_range.start <= start <= h.time_range.end]
        what = (min(inside, key=lambda h: h.time_range.elapsed_us()).name
                if inside else "host (no operator)")
        named.append([what, (end - start) / 1e6])
    return {"busy_s": busy / 1e6, "window_s": wall_s,
            "device_ops": [[k, v / 1e6] for k, v in by_name.most_common(10)],
            "idle_gaps": named}
