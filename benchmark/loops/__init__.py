"""The traffic generators and what they share. A traffic file
(``traffic/<name>.json``) names its loop (``"loop"``), the module
``loops/<loop>.py``, found by that name, whose ``run(cell, seconds,
trace_on, t_start)`` sets up the program and its inputs from the seed,
warms up, measures for ``seconds``, optionally records spans and a
profiler stretch, and hands back a :class:`Window`; the file's other keys
are that loop's parameters. A new kind of traffic is a new file here.
Loops import the program only inside their functions."""
from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode

from .. import trace


def find(loop: str):
    """The ``run`` of ``loops/<loop>.py``."""
    return importlib.import_module(f"{__name__}.{loop}").run


@dataclasses.dataclass
class Window:
    """What a measured window gives: end-to-end numbers, counts, and what
    the traced run and the comparison read afterwards."""
    metrics: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    spans: Optional[dict] = None
    count: int = 0               # frames or steps in the traced window
    wall_s: float = 0.0          # the traced window's host time
    profile: Optional[dict] = None
    check: Optional[dict] = None


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def peak(dev) -> int:
    if torch.device(dev).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0


def build_kernels(dev):
    """Load the program's kernels (built on first use into its
    checkout's ``_build``) during set-up, not in the window."""
    if torch.device(dev).type == "cuda":
        from gaussianformer_tpu_torch.kernels import _lib
        _lib.lib()


def build_program(c, cfg, state, device):
    """The program's segmentor for the port's config ``cfg``, with the
    benchmark's weights ``state`` (strict: every name must match)."""
    from gaussianformer_tpu_torch.models.segmentor import BEVSegmentor
    with torch.device(device):
        model = BEVSegmentor(cfg)
    model.load_state_dict(state, strict=True)
    return model.eval()


def profile(run_one, count):
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        for i in range(count):
            run_one(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(trace.summarise(prof, wall), count=count)


class DrawRecorder(TorchFunctionMode):
    """Records every random draw made with ``generator`` (kind, result),
    in order: the program's step draws its lifter's and its dropout's
    uniforms so."""

    KINDS = {torch.rand: "rand", torch.randint: "randint",
             torch.randn: "randn"}

    def __init__(self, generator):
        super().__init__()
        self.generator = generator
        self.draws = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in self.KINDS and kwargs.get("generator") is self.generator:
            self.draws.append((self.KINDS[func], out.detach().clone()))
        return out
