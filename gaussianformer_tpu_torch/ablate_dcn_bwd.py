"""Where the time of K5's input-gradient launch goes on the GPU.

    python -m gaussianformer_tpu_torch.ablate_dcn_bwd

Builds ``csrc/dcn_bwd.cu`` as it is and three times more, each time with
one more phase of ``dcn_bwd_input_kernel`` cut out of the source (the cuts
are cumulative): the owner pass and window flush, then the pixel pass,
then the MMAs, which leaves the loads and the barriers. It times the input
launch of each build, and the weight launch of the first, with CUDA
events on seeded random inputs at the flagship tower's stage-3 and stage-4
shapes: fractional offsets (every corner in the g_x window, as at random
init) and, at stage 3, offsets moved by up to 6 px. The difference between
two builds is the time of the phase cut between them, as far as the
compiler schedules the rest alike. Cut builds compute wrong gradients and
serve only to time. Prints the card's name and power limit and one JSON
line. Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from .kernels import _lib

#: the phases, in the order they are cut: (name, source text, its
#: replacement); each text must occur once in ``csrc/dcn_bwd.cu``
CUTS = (
    ("owner pass and window flush",
     "        if (e >= nmax[j]) continue;  // uniform over the warp",
     "        continue;"),
    ("pixel pass",
     "    {\n      const float sy = (float)(eyy - 1 + tap / 3) + edy;",
     "    if (false) {\n      const float sy = (float)(eyy - 1 + tap / 3)"
     " + edy;"),
    ("MMAs",
     "    for (int kk = 0; kk < KS; kk += 16) {\n      unsigned af[4], bf[4];",
     "    for (int kk = 0; kk < 0; kk += 16) {\n      unsigned af[4], bf[4];"),
)
#: (B, H, W, C, offset range in px) of each case
CASES = ((6, 54, 100, 256, 0.5), (6, 27, 50, 512, 0.5),
         (6, 54, 100, 256, 6.0))


def _build():
    """One library per build (the source as it is, then each cut added),
    compiled in parallel; returns [(label, ctypes library)]."""
    src = (_lib.CSRC_DIR / "dcn_bwd.cu").read_text()
    out = _lib.BUILD_DIR / "ablate_dcn_bwd"
    out.mkdir(parents=True, exist_ok=True)
    builds, label = [("as built", src)], "as built"
    for name, old, new in CUTS:
        if src.count(old) != 1:
            raise RuntimeError(f"the cut of the {name} no longer matches "
                               f"csrc/dcn_bwd.cu: update CUTS")
        src = src.replace(old, new)
        label = f"without the {name}" if label == "as built" else \
            f"{label}, {name}"
        builds.append((label, src))
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
    for label, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the build {label!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.gf_dcn_backward_parts.restype = ctypes.c_int
        libs.append((label, lib))
    return libs


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
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
    P = ctypes.c_void_p
    rows = []
    for b, h, w, c, px in CASES:
        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)
        x = rand(b, h, w, c).bfloat16()
        om = rand(b, h, w, 27)
        om[..., :18] = (torch.rand(b, h, w, 18, device="cuda",
                                   generator=gen) * 2 - 1) * px
        # offset: pixel rows of 27 floats, as sliced from the offset
        # conv's output on the model's path; mask: dense rows of 9
        offset, mask = om[..., :18], torch.sigmoid(om[..., 18:])
        weight = (rand(9 * c, c) * 0.05).bfloat16()
        g_out = rand(b, h, w, c).bfloat16()
        outs = [torch.zeros(b, h, w, c, device="cuda"),
                torch.zeros(b, h, w, 18, device="cuda"),
                torch.zeros(b, h, w, 9, device="cuda"),
                torch.zeros(9 * c, c, device="cuda")]
        stream = P(torch.cuda.current_stream().cuda_stream)

        def launch(lib, parts):
            code = lib.gf_dcn_backward_parts(
                P(x.data_ptr()), P(offset.data_ptr()), 27,
                P(mask.data_ptr()), 9, P(weight.data_ptr()),
                P(g_out.data_ptr()), *(P(t.data_ptr()) for t in outs),
                b, h, w, c, c, parts, stream)
            if code != 0:
                raise RuntimeError(f"gf_dcn_backward_parts returned {code}")
        row = {"shape": [b, h, w, c], "offset_px": px,
               "weight_ms": _ms(lambda: launch(libs[0][1], 2)),
               "input_ms": {label: _ms(lambda lib=lib: launch(lib, 1))
                            for label, lib in libs}}
        rows.append(row)
        print(f"# {row['shape']}, offsets up to {px:g} px: input launch "
              + "; ".join(f"{k} {v:.4f} ms"
                          for k, v in row["input_ms"].items())
              + f"; weight launch {row['weight_ms']:.4f} ms", flush=True)
    print(card)
    print(json.dumps({"card": card, "dcn_bwd_input_ablation": rows}))


if __name__ == "__main__":
    main()
