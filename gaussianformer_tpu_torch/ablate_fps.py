"""Where the time of a K2 (FPS) step goes on the GPU.

    python -m gaussianformer_tpu_torch.ablate_fps

Builds ``csrc/fps.cu`` as it is and with one phase of a step changed in
the source at a time, and times each build on the lifter's 129,600
seeded random candidates (a fifth masked out, in the wrapper's spatial
order) at S = 4000 and 19,200, beside the latency floor (the exchange
alone, ``gf_fps_step_floor``):

- "no pruning": every warp runs its distance pass every step;
- "pruned after step 1": every warp skips its pass from step 2 on, which
  leaves the pruning test, the block reduction and the cluster exchange
  (wrong indices; it serves only to time).

No cut may skip a barrier or an mbarrier wait: the exchange's buffers
are reused every other step, so a thread that runs ahead re-arms a phase
that others still wait on, and the launch hangs.

The difference between two builds is the time of what was changed, as far
as the compiler schedules the rest alike. Prints the card's name and power
limit and one JSON line. Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from .kernels import _lib, fps

#: (name, source text, its replacement); each text must occur once in
#: ``csrc/fps.cu``
CUTS = (
    ("no pruning",
     "                 : step > 1 && (wkey == 0u ||\n"
     "                                __float_as_uint(dbox) + 1u >= wkey);",
     "                 : false;"),
    ("pruned after step 1",
     "                 : step > 1 && (wkey == 0u ||\n"
     "                                __float_as_uint(dbox) + 1u >= wkey);",
     "                 : step > 1;"),
)
N = 129_600
STEPS = (4000, 19_200)


def _build():
    """One library per build (the source as it is, then each cut alone),
    compiled in parallel; returns [(label, ctypes library)]."""
    src = (_lib.CSRC_DIR / "fps.cu").read_text()
    out = _lib.BUILD_DIR / "ablate_fps"
    out.mkdir(parents=True, exist_ok=True)
    builds = [("as built", src)]
    for name, old, new in CUTS:
        if src.count(old) != 1:
            raise RuntimeError(f"the cut {name!r} no longer matches "
                               f"csrc/fps.cu: update CUTS")
        builds.append((name, src.replace(old, new)))
    procs = []
    for i, (label, text) in enumerate(builds):
        cu = out / f"cut{i}.cu"
        cu.write_text(text)
        so = out / f"libcut{i}.so"
        cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I",
               str(_lib.CSRC_DIR), str(cu), "-o", str(so)]
        procs.append((label, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = []
    P, I = ctypes.c_void_p, ctypes.c_int
    for label, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the build {label!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.gf_fps_forward_ordered.argtypes = [P, P, P, P, I, I, P, I, P]
        lib.gf_fps_forward_ordered.restype = I
        libs.append((label, lib))
    return libs


def _ms(fn, iters: int = 3) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    pts = torch.randn(N, 3, device="cuda", generator=gen) * torch.tensor(
        [25.0, 25.0, 2.0], device="cuda")
    valid = torch.rand(N, device="cuda", generator=gen) > 0.2
    # the wrapper's inputs, as farthest_point_sampling_cuda makes them
    order = fps.spatial_order(pts)
    pts_o = pts[order].contiguous()
    valid_o = valid[order].to(torch.uint8).contiguous()
    seed = torch.argmax(valid.to(torch.int32)).to(torch.int32)
    seed_pos = torch.argmax((order == seed).to(torch.int32)).to(torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card, "n": N}
    for s in STEPS:
        out = torch.empty(s, dtype=torch.int32, device="cuda")
        row = {}
        for label, lib in libs:
            def run(lib=lib):
                code = lib.gf_fps_forward_ordered(
                    pts_o.data_ptr(), valid_o.data_ptr(), order.data_ptr(),
                    seed_pos.data_ptr(), N, s, out.data_ptr(), 0, stream)
                if code:
                    raise RuntimeError(f"{label}: error {code}")
            ms = _ms(run)
            row[label] = {"ms": ms, "us_per_step": ms * 1e3 / s}
        floor = _ms(lambda: fps.fps_step_floor_cuda(s, pts.device))
        row["floor"] = {"ms": floor, "us_per_step": floor * 1e3 / s}
        result[f"s{s}"] = row
        print(f"# S = {s}: {json.dumps(row)}", flush=True)
    print(card)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
