"""The port's tracing: named spans and counters placed in the program where
its work happens, off unless a caller turns them on.

    from gaussianformer_tpu_torch.utils import profiling
    profiling.enable()
    ...                      # frames or train steps
    profiling.disable()
    stats = profiling.collect()

:func:`span` marks a stretch of the program (``with span("encoder"):``).
While tracing is off it hands back one shared null context: no record, no
event, no profiler call. While it is on, a span records its name, the span
it opened inside, the top-level call (a frame's or a step's outermost span)
it belongs to, its host start and end (``time.perf_counter_ns``), a CUDA
event pair for its device time (not while a CUDA graph is being captured)
and, while a ``torch.profiler`` records, a ``record_function`` range named
``gf/<name>``, so that the profiler's trace shows the program's spans on
the kernels' clock (its ``export_chrome_trace`` is the timeline).

:func:`count` adds to a named counter; a tensor is summed on its device and
read in :func:`collect`, once. :func:`host_read` is the program's one way
to read a device value on the host: a ``sync/<name>`` span and one more
``host_syncs`` while tracing is on; with ``torch.cuda``'s sync debug mode
set it lifts the mode for its own read, so that any other synchronisation
on the path warns or raises.

Spans nest across autograd's device thread: the thread that calls
``backward()`` waits while that thread runs, so one stack serves both.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

_ON = False
_NULL = contextlib.nullcontext()
#: spans recorded since :func:`enable`, in the order they opened
_RECORDS = []
#: the open spans, innermost last
_STACK = []
#: counter name -> a Python number or a tensor on its device
_COUNTERS = {}
_STATE = {"calls": 0, "events": False, "launches": {}}


class _Span:
    __slots__ = ("name", "parent", "call", "t0", "t1", "ev", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _STACK[-1] if _STACK else None
        if self.parent is None:
            _STATE["calls"] += 1
        self.call = _STATE["calls"]
        _STACK.append(self)
        _RECORDS.append(self)
        # a profiler range only where a profiler records: one costs more
        # than the rest of the span
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(
                f"gf/{self.name}")
            self.rf.__enter__()
        self.ev = None
        if _STATE["events"] and not torch.cuda.is_current_stream_capturing():
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        self.t1 = None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev is not None:
            self.ev[1].record()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        # closes the spans opened inside that an exception left open too
        if self in _STACK:
            del _STACK[_STACK.index(self):]
        return False


def span(name: str):
    """A context manager that records the stretch it wraps as ``name``
    while tracing is on, and one shared null context while it is off."""
    if not _ON:
        return _NULL
    return _Span(name)


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor summed on its device) to the
    counter ``name`` while tracing is on. A tensor is not read here; its
    sum is read once, in :func:`collect`. Not counted while a CUDA graph is
    being captured."""
    if not _ON:
        return
    if isinstance(value, torch.Tensor):
        if value.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        # a tensor made outside inference mode, so that a step may add to
        # what a frame counted
        with torch.inference_mode(False), torch.no_grad():
            value = value.detach().sum(dtype=torch.float64
                                       if value.is_floating_point()
                                       else torch.int64)
            _COUNTERS[name] = value + _COUNTERS.get(name, 0)
        return
    _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def host_read(name: str, tensor: torch.Tensor):
    """``tensor``'s value on the host (``.item()``, or ``.tolist()`` for
    more than one element). While tracing is on, inside a ``sync/<name>``
    span and counted in ``host_syncs``. A sync debug mode of
    ``torch.cuda`` is lifted for this read alone."""
    if not _ON:
        return _read(tensor)
    with span(f"sync/{name}"):
        count("host_syncs", 1)
        return _read(tensor)


def _read(tensor: torch.Tensor):
    mode = torch.cuda.get_sync_debug_mode() if tensor.is_cuda else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        return tensor.item() if tensor.numel() == 1 else tensor.tolist()
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


def enable() -> None:
    """Forget what was recorded and trace from here on: CUDA events where
    CUDA is available."""
    global _ON
    from ..kernels import _lib
    _RECORDS.clear()
    _STACK.clear()
    _COUNTERS.clear()
    _STATE.update(calls=0, events=torch.cuda.is_available(),
                  launches=dict(_lib.LAUNCHES))
    _ON = True


def disable() -> None:
    """Stop tracing; what was recorded stays for :func:`collect`."""
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def records() -> list:
    """The spans closed since :func:`enable`, in the order they opened:
    (name, the enclosing span's name or None, the top-level call's number
    from 1, host ms, device ms or None)."""
    if _STATE["events"]:
        torch.cuda.synchronize()
    return [(r.name, r.parent and r.parent.name, r.call,
             (r.t1 - r.t0) / 1e6, _ms(r.ev)) for r in _RECORDS
            if r.t1 is not None]


def _ms(ev) -> Optional[float]:
    return None if ev is None else ev[0].elapsed_time(ev[1])


def collect() -> dict:
    """What was recorded since :func:`enable`, after one synchronise:

    - ``spans``: name -> ``calls``, ``host_ms``, ``self_host_ms``,
      ``device_ms`` and ``self_device_ms`` (the self times less what its
      child spans cover), summed over the calls; the device numbers are
      None where a call has no CUDA events (no CUDA, or recorded during a
      capture);
    - ``counters``: name -> the summed value;
    - ``launches``: kernel -> its launches (``kernels._lib.LAUNCHES``)
      since :func:`enable`;
    - ``calls``: the top-level calls (frames, steps) traced.

    Spans still open are left out."""
    from ..kernels import _lib
    if _STATE["events"] or any(isinstance(v, torch.Tensor) and v.is_cuda
                               for v in _COUNTERS.values()):
        torch.cuda.synchronize()
    done = [r for r in _RECORDS if r.t1 is not None]
    host = {id(r): (r.t1 - r.t0) / 1e6 for r in done}
    dev = {id(r): _ms(r.ev) for r in done}
    child_host, child_dev = {}, {}
    for r in done:
        if r.parent is not None:
            p = id(r.parent)
            child_host[p] = child_host.get(p, 0.0) + host[id(r)]
            if dev[id(r)] is not None:
                child_dev[p] = child_dev.get(p, 0.0) + dev[id(r)]
    spans = {}
    for r in done:
        s = spans.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                      "self_host_ms": 0.0, "device_ms": 0.0,
                                      "self_device_ms": 0.0})
        s["calls"] += 1
        s["host_ms"] += host[id(r)]
        s["self_host_ms"] += host[id(r)] - child_host.get(id(r), 0.0)
        d = dev[id(r)]
        if d is None or s["device_ms"] is None:
            s["device_ms"] = s["self_device_ms"] = None
        else:
            s["device_ms"] += d
            s["self_device_ms"] += d - child_dev.get(id(r), 0.0)
    tensors = [k for k, v in _COUNTERS.items() if isinstance(v, torch.Tensor)]
    read = (torch.stack([_COUNTERS[k].double() for k in tensors]).tolist()
            if tensors else [])
    counters = {k: v for k, v in _COUNTERS.items() if k not in tensors}
    for k, v in zip(tensors, read):
        counters[k] = int(v) if v == int(v) else v
    start = _STATE["launches"]
    launches = {k: n - start.get(k, 0) for k, n in _lib.LAUNCHES.items()
                if n - start.get(k, 0)}
    return {"spans": spans, "counters": counters, "launches": launches,
            "calls": _STATE["calls"]}
