"""K4 (the splat forward), K7 (its backward) and their tile binning on the
GPU, on the inputs of the model's own path, optionally beside the same
kernels built from another tree's sources in the same process.

    python -m gaussianformer_tpu_torch.bench_splat [--parent DIR]

For each of the five shipped configs the full-width model
(random weights from seed 0, the synthetic batch) runs one frame under
inference mode and one train step, and the inputs of the splat kernels
are captured (the last splat of the frame, the first backward of the
step). Then, on those inputs, with the bins sized by the path's bound
(the head's): the binning alone (``bins_ms``, one call with no host read
but the eager check of its flag word); K4 through
its wrapper, binning included (``k4_change_ms``, a time a turn), and on
bins built beforehand (``k4_kernel_ms``); K7 through its wrapper on the
forward's bins, as the path calls it (``k7_change_ms``), and its two
launches alone (``k7_tile_ms``, ``k7_fold_ms``); the entries, the COVERS
share, the tiles' mean and largest list lengths, and the AABB pairs. At
Prob-256 also K4 with the threshold label mode and K4 / K7 on per-axis
boxes. ``--parent DIR`` compiles ``DIR/*.cu`` (a checkout's
``gaussianformer_tpu_torch/csrc`` before the tile binning) into a second
library and times its K4 and K7 through their C entry points
(``k4_parent_ms``, ``k7_parent_ms``) in turns with this tree's: parent,
change, change, parent; it also says whether
K4's sums, one_minus and labels are the parent's bits and how far K7's
gradients are from the parent's. Times are CUDA events over repeated calls
after a warm-up. Prints the card's name and power limit and one JSON line.
Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from .configs import get_config
from .data.synthetic import synthetic_batch
from .kernels import _lib, splat
from .models.segmentor import build_segmentor
from .ops import splat as ops_splat
from .train.optim import build_optimizer
from .train.step import build_loss, train_step

CONFIGS = ("prob_gs6400", "prob_gs12800", "prob_gs25600", "gs25600_solid",
           "gs144000")
ITERS = 10


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
    builds the package's own, with the splat entry points of the tree
    before the tile binning."""
    so = _lib.BUILD_DIR / "bench_splat_parent" / "libparent.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    _lib._compile_and_link(sorted(csrc.glob("*.cu")), so,
                           so.with_suffix(".log"))
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pf = ctypes.POINTER(F)
    for fn, types in (
            ("gf_splat_forward", [P, I, P, P, P, I, I, pf, F, I, I, I, P, P,
                                  P, I, F, I, P]),
            ("gf_splat_forward_additive", [P, I, P, P, P, I, I, pf, F, I, I,
                                           I, P, P, P]),
            ("gf_splat_backward", [P, P, P, P, P, P, P, I, I, I, I, I, P, P,
                                   P, P, P]),
            ("gf_splat_backward_additive", [P, P, P, P, P, P, I, I, I, I, I,
                                            P, P, P, P, P, P])):
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = I
    return lib


def _ptr(a):
    return a.data_ptr() if isinstance(a, torch.Tensor) else a


def _call(lib, fn, *args):
    code = getattr(lib, fn)(*[_ptr(a) for a in args])
    if code != 0:
        raise RuntimeError(f"{fn} returned {code}")


def _parent_k4(lib, args, kw):
    """The parent's K4 on the same inputs: outputs and a launcher."""
    points, gdata, box, sem_aug, grid, variant = args
    n, p, ca = points.shape[0], gdata.shape[0], sem_aug.shape[1]
    f32 = dict(dtype=torch.float32, device=points.device)
    acc = torch.empty(n, ca, **f32)
    om = torch.empty(n, **f32)
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    pc = (ctypes.c_float * 3)(*grid.pc_min)
    stream = torch.cuda.current_stream().cuda_stream
    head = (points, n, gdata, box, sem_aug, p, ca - 2, pc,
            ctypes.c_float(grid.grid_size), grid.H, grid.W, grid.D, acc)
    if variant == "additive":
        def run():
            _call(lib, "gf_splat_forward_additive", *head, labels, stream)
        return (acc, None, labels), run

    def run():
        _call(lib, "gf_splat_forward", *head, om, labels,
              int(kw.get("label_mode", "combine") == "threshold"),
              ctypes.c_float(kw.get("thresh", 0.5)),
              int(kw.get("empty_label", 17)), stream)
    return (acc, om, labels), run


def _parent_k7(lib, args):
    points, gdata, opa, sem, box, gl, scalars, grid, variant = args
    p, c = sem.shape
    f32 = dict(dtype=torch.float32, device=points.device)
    outs = (torch.empty(p, 3, **f32), torch.empty(p, **f32),
            torch.empty(p, c, **f32), torch.empty(p, 6, **f32))
    stream = torch.cuda.current_stream().cuda_stream
    if variant == "additive":
        big = torch.zeros(p + 1, dtype=torch.int32, device=points.device)

        def run():
            big.zero_()
            _call(lib, "gf_splat_backward_additive", points, gdata, opa, sem,
                  box, gl, p, c, grid.H, grid.W, grid.D, *outs, big, stream)
        return outs, run

    def run():
        _call(lib, "gf_splat_backward", points, gdata, opa, sem, box, gl,
              scalars, p, c, grid.H, grid.W, grid.D, *outs, stream)
    return outs, run


def _pairs(box, grid) -> int:
    dims = torch.tensor([grid.H, grid.W, grid.D], device=box.device)
    lo = box[:, :3].long().clamp_min(0)
    hi = torch.minimum(box[:, 3:].long(), dims - 1)
    return int((hi - lo + 1).clamp_min(0).prod(-1).sum().item())


def capture(name):
    """The config's splat inputs: K4's (the frame's last splat) and K7's
    (the train step's first backward), with the head's packing inputs."""
    cfg = get_config(name)
    model = build_segmentor(cfg, device="cuda", seed=0)
    g = cfg.grid
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=0,
                            device="cuda")
    calls = {}
    orig = {k: getattr(splat, k) for k in ("splat_accumulate_cuda",
                                           "splat_backward_cuda")}
    orig_pack = ops_splat.pack_gaussians

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] = (a, k)
            return fn(*a, **k)
        return wrapped
    splat.splat_accumulate_cuda = spy("k4", orig["splat_accumulate_cuda"])
    ops_splat.pack_gaussians = spy("pack", orig_pack)
    try:
        with torch.inference_mode():
            gen = torch.Generator(device="cuda").manual_seed(0)
            model(batch["imgs"], batch["projection_mat"], batch["image_wh"],
                  batch["occ_xyz"], generator=gen)
        k4_calls = dict(calls)
        calls.clear()
        splat.splat_accumulate_cuda = orig["splat_accumulate_cuda"]
        ops_splat.pack_gaussians = orig_pack
        first = {}

        def spy_first(key, fn):
            def wrapped(*a, **k):
                first.setdefault(key, (a, k))
                return fn(*a, **k)
            return wrapped
        splat.splat_backward_cuda = spy_first("k7",
                                              orig["splat_backward_cuda"])
        ops_splat.pack_gaussians = spy_first("pack", orig_pack)
        opt, schedule = build_optimizer(model, cfg, 10000)
        gen = torch.Generator(device="cuda").manual_seed(0)
        train_step(model, opt, schedule, build_loss(cfg), batch, gen)
        torch.cuda.synchronize()
    finally:
        for k, fn in orig.items():
            setattr(splat, k, fn)
        ops_splat.pack_gaussians = orig_pack
    del model, batch, opt
    torch.cuda.empty_cache()
    k7_args, k7_kw = first["k7"]
    k4_calls["train_pack"] = first["pack"]
    return cfg, k4_calls, (tuple(t.detach() if isinstance(t, torch.Tensor)
                                 else t for t in k7_args), k7_kw)


def bench_case(tag, k4_args, k4_kw, k7_args, k7_bins, libs, order, iters):
    """Time the binning, K4 and K7 of one case (and the parent's K4 and K7
    in turns); returns its row."""
    points, gdata, box, sem_aug, grid, variant = k4_args
    kw = {k: v for k, v in k4_kw.items() if k != "bins"}
    cap = k4_kw["bins"].capacity     # the path's bound on the entries

    def binned():
        return splat.bin_gaussians_cuda(points, box, grid, cap)
    bins = binned()
    row = dict(case=tag, gaussians=gdata.shape[0],
               aabb_pairs=_pairs(box, grid), capacity=cap, **bins.stats())
    row["bins_ms"] = _ms(binned, iters)
    got4 = splat.splat_accumulate_cuda(*k4_args, **kw)
    row["k4_kernel_ms"] = _ms(lambda: splat.splat_accumulate_cuda(
        *k4_args, **kw, bins=bins), iters)
    if k7_args is not None:
        got7 = splat.splat_backward_cuda(*k7_args, bins=k7_bins)
        row["k7_tile_ms"] = _ms(lambda: splat.splat_backward_cuda(
            *k7_args, bins=k7_bins, parts=splat.TILE_LAUNCH), iters)
        row["k7_fold_ms"] = _ms(lambda: splat.splat_backward_cuda(
            *k7_args, bins=k7_bins, parts=splat.FOLD_LAUNCH), iters)
        row["workspace_mb"] = (k7_bins.capacity * (
            -(-(10 + k7_args[3].shape[1]) // 4) * 4) * 4 / 1e6)
    runs = {"change": (
        lambda: splat.splat_accumulate_cuda(*k4_args, **kw, bins=binned()),
        None if k7_args is None else
        (lambda: splat.splat_backward_cuda(*k7_args, bins=k7_bins)))}
    if "parent" in libs:
        out4, run4 = _parent_k4(libs["parent"], k4_args, kw)
        run4()
        row["k4_parent_bit_equal"] = {
            "acc": bool(torch.equal(out4[0], got4[0])),
            "one_minus": (None if out4[1] is None
                          else bool(torch.equal(out4[1], got4[1]))),
            "labels": bool(torch.equal(out4[2], got4[2]))}
        run7 = None
        if k7_args is not None:
            out7, run7 = _parent_k7(libs["parent"], k7_args)
            run7()
            row["k7_vs_parent_rel_err"] = {
                k: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)
                    ).item() for k, a, b in zip(
                        ("gmu", "gopa", "gsem", "gcov"), got7, out7)}
        runs["parent"] = (run4, run7)
    for who in order:
        r4, r7 = runs[who]
        row.setdefault(f"k4_{who}_ms", []).append(_ms(r4, iters))
        if r7 is not None:
            row.setdefault(f"k7_{who}_ms", []).append(_ms(r7, iters))
    print(f"# {tag}: {json.dumps(row)}", flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree's csrc directory to time beside")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}", flush=True)
    libs = {"change": _lib.lib()}
    if args.parent is not None:
        libs["parent"] = _build_parent(args.parent)
    order = (["parent", "change", "change", "parent"] if "parent" in libs
             else ["change", "change"])
    result = {"card": card, "tile": list(splat.TILE), "rows": []}
    for name in CONFIGS:
        cfg, k4_calls, (k7_args, k7_kw) = capture(name)
        k4_args, k4_kw = k4_calls["k4"]
        k7_bins = k7_kw.get("bins")
        result["rows"].append(bench_case(name, k4_args, k4_kw, k7_args,
                                         k7_bins, libs, order, ITERS))
        if name == "prob_gs25600":
            thr = dict(k4_kw, label_mode="threshold", thresh=0.5)
            result["rows"].append(bench_case(
                f"{name}_threshold", k4_args, thr, None, None, libs, order,
                ITERS))

            def per_axis(key):
                a, k = k4_calls[key]
                return ops_splat.pack_gaussians(
                    *[t.detach() if isinstance(t, torch.Tensor) else t
                      for t in a[:6]], **dict(k, per_axis=True))
            gdata, box, sem_aug = per_axis("pack")
            pa4 = (k4_args[0], gdata, box, sem_aug) + tuple(k4_args[4:])
            box7 = per_axis("train_pack")[1]
            pa7 = k7_args[:4] + (box7,) + k7_args[5:]
            result["rows"].append(bench_case(
                f"{name}_per_axis", pa4, k4_kw, pa7,
                splat.bin_gaussians_cuda(k4_args[0], box7, k4_args[4]), libs,
                order, ITERS))
        del k4_calls, k7_args, k7_kw, k7_bins
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
