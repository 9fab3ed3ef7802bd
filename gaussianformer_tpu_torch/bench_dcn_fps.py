"""K1 (DCNv2 forward), K5 (its backward) and K2 (FPS) on the GPU, at the
shapes of the model's path, optionally beside the same kernels built from
another tree's sources in the same process.

    python -m gaussianformer_tpu_torch.bench_dcn_fps [--parent DIR]

On seeded random inputs: K1 and K5 at the flagship tower's stage-3
([6, 54, 100, 256] -> 256) and stage-4 ([6, 27, 50, 512] -> 512) shapes
with offsets in [-0.5, 0.5) px (K1 with its BN + ReLU epilogue, as on the
inference path), with cuDNN's bf16 channels-last 3x3 convolution of the
same shape beside them (``conv_ms``: the dense GEMM's time, a yardstick,
not the same function); K2 on the lifter's 129,600 candidates, a fifth of
them masked out, at S = 4000, 6400 and 19,200 (the three prob configs),
on each cluster size the card takes (through the wrapper, which orders
the points spatially), in the points' own order (``unordered_ms``), and
the latency floor of a step (the exchange alone, ``gf_fps_step_floor``). ``--parent DIR`` compiles
``DIR/*.cu`` (a checkout's ``gaussianformer_tpu_torch/csrc``) into a
second library and times its K1, K5 and K2 (its default cluster) in turns
with this tree's: parent, change, change, parent. Times are CUDA events
over repeated launches after a warm-up. Prints the card's name and power
limit and one JSON line. Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from .kernels import _lib, fps

STAGES = {"stage3": (6, 54, 100, 256, 256), "stage4": (6, 27, 50, 512, 512)}
FPS_N = 129_600
FPS_S = (4000, 6400, 19_200)


def _ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _build_parent(csrc: Path) -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` into a second library, as ``kernels/_lib.py``
    builds the package's own."""
    so = _lib.BUILD_DIR / "bench_parent" / "libparent.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    _lib._compile_and_link(sorted(csrc.glob("*.cu")), so,
                           so.with_suffix(".log"))
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn, types in (
            ("gf_dcn_forward", [P, P, I, P, I, P, P, P, P, I, I, I, I, I, P]),
            ("gf_dcn_backward", [P, P, I, P, I, P, P, P, P, P, P,
                                 I, I, I, I, I, P]),
            ("gf_fps_forward", [P, P, P, I, I, P, P])):
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = I
    return lib


def _call(lib, fn, *args):
    """A C entry point (its argtypes set), tensors passed by address."""
    code = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                              else a for a in args])
    if code != 0:
        raise RuntimeError(f"{fn} returned {code}")


def _dcn_inputs(gen, b, h, w, cin, cout):
    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    x = rand(b, h, w, cin).bfloat16()
    om = rand(b, h, w, 27)
    om[..., :18] = torch.rand(b, h, w, 18, device="cuda",
                              generator=gen) - 0.5
    offset, mask = om[..., :18], torch.sigmoid(om[..., 18:])
    weight = (rand(9 * cin, cout) * 0.05).bfloat16()
    inv, shift = rand(cout).abs() + 0.5, rand(cout)
    g_out = rand(b, h, w, cout).bfloat16()
    return x, offset, mask, weight, inv, shift, g_out


def _dcn_fwd(lib, x, offset, mask, weight, inv, shift, out):
    b, h, w, cin = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: _call(lib, "gf_dcn_forward", x, offset, 27, mask, 27,
                         weight, inv, shift, out, b, h, w, cin,
                         out.shape[-1], stream)


def _dcn_bwd(lib, x, offset, mask, weight, g_out, outs):
    b, h, w, cin = x.shape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        for t in outs:
            t.zero_()
        _call(lib, "gf_dcn_backward", x, offset, 27, mask, 27, weight, g_out,
              *outs, b, h, w, cin, g_out.shape[-1], stream)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree's csrc directory to time beside")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = {"change": _lib.lib()}
    if args.parent is not None:
        libs["parent"] = _build_parent(args.parent)
    order = (["parent", "change", "change", "parent"] if "parent" in libs
             else ["change", "change"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card}

    for stage, (b, h, w, cin, cout) in STAGES.items():
        x, offset, mask, weight, inv, shift, g_out = _dcn_inputs(
            gen, b, h, w, cin, cout)
        out = torch.empty(b, h, w, cout, dtype=torch.bfloat16, device="cuda")
        f32 = dict(dtype=torch.float32, device="cuda")
        outs = [torch.zeros(b, h, w, cin, **f32),
                torch.zeros(b, h, w, 18, **f32),
                torch.zeros(b, h, w, 9, **f32),
                torch.zeros(9 * cin, cout, **f32)]
        row = {"shape": [b, h, w, cin, cout]}
        for who in order:
            lib = libs[who]
            row.setdefault(f"k1_{who}_ms", []).append(_ms(_dcn_fwd(
                lib, x, offset, mask, weight, inv, shift, out), 50))
            row.setdefault(f"k5_{who}_ms", []).append(_ms(_dcn_bwd(
                lib, x, offset, mask, weight, g_out, outs), 20))
        xc = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        wc = weight.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row["conv_ms"] = _ms(lambda: torch.nn.functional.conv2d(
            xc, wc, padding=1), 50)
        row["bound_ms"] = 2.0 * b * h * w * 9 * cin * cout / 989e12 * 1e3
        result[stage] = row
        print(f"# {stage}: {json.dumps(row)}", flush=True)
        del x, offset, mask, weight, g_out, out, outs, xc, wc

    pts = torch.randn(FPS_N, 3, device="cuda", generator=gen) * torch.tensor(
        [25.0, 25.0, 2.0], device="cuda")
    valid = torch.rand(FPS_N, device="cuda", generator=gen) > 0.2
    valid_u8 = valid.to(torch.uint8)
    seed = torch.argmax(valid.to(torch.int32)).to(torch.int32)
    sizes = [cs for cs in (8, 16) if cs <= fps.default_cluster_size()]
    for s in FPS_S:
        out = torch.empty(s, dtype=torch.int32, device="cuda")
        row = {"n": FPS_N, "s": s, "default_cluster": fps.default_cluster_size()}
        ref = fps.farthest_point_sampling_cuda(pts, s, valid)
        for cs in sizes:
            got = fps.farthest_point_sampling_cuda(pts, s, valid, cs)
            if not torch.equal(got, ref):
                raise RuntimeError(f"FPS at cluster {cs} differs")
            row[f"cluster{cs}_ms"] = _ms(
                lambda: fps.farthest_point_sampling_cuda(pts, s, valid, cs),
                3, 1)
            row[f"floor{cs}_ms"] = _ms(
                lambda: fps.fps_step_floor_cuda(s, pts.device, cs), 3, 1)
        stream = torch.cuda.current_stream().cuda_stream
        # this tree's kernel on the points in their own order: no compact
        # warp boxes, so it prunes little
        _call(libs["change"], "gf_fps_forward", pts, valid_u8, seed, FPS_N,
              s, out, stream)
        if not torch.equal(out, ref):
            raise RuntimeError("FPS in the points' own order differs")
        row["unordered_ms"] = _ms(lambda: _call(
            libs["change"], "gf_fps_forward", pts, valid_u8, seed, FPS_N, s,
            out, stream), 3, 1)
        if "parent" in libs:
            _call(libs["parent"], "gf_fps_forward", pts, valid_u8, seed,
                  FPS_N, s, out, stream)
            row["parent_equal"] = bool(torch.equal(out, ref))
            row["parent_ms"] = _ms(lambda: _call(
                libs["parent"], "gf_fps_forward", pts, valid_u8, seed, FPS_N,
                s, out, stream), 3, 1)
        for k in [k for k in row if k.endswith("_ms")]:
            row[k.replace("_ms", "_us_per_step")] = row[k] * 1e3 / s
        result[f"fps_s{s}"] = row
        print(f"# fps S={s}: {json.dumps(row)}", flush=True)
    print(card)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
