"""K3 (the deformable aggregation forward) and K6 (its backward) on the
GPU, on the inputs of the model's own path, optionally beside the same
kernels built from another tree's sources in the same process.

    python -m gaussianformer_tpu_torch.bench_deformable [--parent DIR]
                                                        [--split]

For each of the five shipped configs the full-width model (random weights
from seed 0, the synthetic batch) runs one frame under inference mode and
one train step, and the inputs of the first K3 and the first K6 call are
captured. Then, on those inputs: the in-image (key point, camera) pairs;
K6's bins (``csrc/deformable_bin.cu``): entries, the longest pixel list,
the workspace bytes and the binning's time alone (``bins_ms``); each of
K6's two launches alone on those bins (``k6_points_ms``,
``k6_features_ms``); K3 on the inputs with the anchors reordered by the
camera and image position of their first in-image key point
(``k3_by_image_position_ms``: what such an ordering could gain in the
caches, its sort not counted); K3 (``k3_change_ms``) and K6 through its
wrapper, the
whole call with its binning and everything it allocates
(``k6_change_ms``), a time a turn. ``--parent DIR`` compiles ``DIR/*.cu``
(a checkout's ``gaussianformer_tpu_torch/csrc``) into a second library and
times its K3 and K6 through their C entry points in turns with this
tree's: parent, change, change, parent. The parent's K6 is that of the
tree before the binning (``gf_deformable_backward`` with fp32 gradients
zeroed by the caller); its whole call (``k6_parent_ms``) is what that
tree's wrapper did: the zero fills, the kernel and the cast of the
feature gradients to the maps' dtype. ``--split`` (with ``--parent``)
also splits the parent's K6 call: the zero fills and the cast alone
(``split_fills_cast_ms``), its kernel alone (``split_kernel_ms``) and the
kernel rebuilt from the parent's source with its feature-gradient atomics
cut (``split_no_atomics_ms``) or with its corner gathers cut
(``split_no_gathers_ms``); and this tree's features launch rebuilt with
its g_out row loads cut (``split_no_g_out_rows_ms``, beside
``k6_features_ms``). Times are CUDA events over repeated calls after
a warm-up. Prints the card's name and power limit and one JSON line.
Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import torch

from .configs import get_config
from .data.synthetic import synthetic_batch
from .kernels import _lib, deformable
from .models.segmentor import build_segmentor
from .train.optim import build_optimizer
from .train.step import build_loss, train_step

CONFIGS = ("prob_gs6400", "prob_gs12800", "prob_gs25600", "gs25600_solid",
           "gs144000")
ITERS = 20
# source cuts of K6 (csrc/deformable_bwd.cu), each replacing one statement
# of a kernel: of the parent's (before the binning) or of this tree's
CUTS = {
    "no_atomics": ("parent", "gf::atomic_add_vec<VEC>(gbase + off, share);",
                   ""),
    "no_gathers": ("parent", "gf::load_vec<VEC>(base + off, f);",
                   "for (int e = 0; e < VEC; ++e) f[e] = 1.f;"),
    "no_g_out_rows": ("change",
                      "gf::load_vec<VEC>(gout + (long)an * C + c0, "
                      "rows[buf][i]);",
                      "for (int e = 0; e < VEC; ++e) rows[buf][i][e] = 1.f;"),
}


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


def _bind_parent(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    PP, PI = ctypes.POINTER(P), ctypes.POINTER(I)
    if hasattr(lib, "gf_deformable_forward"):
        lib.gf_deformable_forward.argtypes = [PP, PI, PI, I, I, P, P, P, I,
                                              I, I, I, I, I, P]
        lib.gf_deformable_forward.restype = I
    lib.gf_deformable_backward.argtypes = [PP, PP, PI, PI, I, I, P, P, P, P,
                                           P, I, I, I, I, I, I, P]
    lib.gf_deformable_backward.restype = I
    return lib


def _build(csrc: Path, tag: str, sources=None, bind=_bind_parent):
    """Compile ``csrc/*.cu`` (or ``sources`` of it) into a library of its
    own, as ``kernels/_lib.py`` builds the package's."""
    so = _lib.BUILD_DIR / f"bench_deformable_{tag}" / "libparent.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    files = sorted(csrc.glob("*.cu")) if sources is None else [
        csrc / s for s in sources]
    _lib._compile_and_link(files, so, so.with_suffix(".log"))
    return bind(ctypes.CDLL(str(so)))


def _bind_change(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    PP, PI = ctypes.POINTER(P), ctypes.POINTER(I)
    lib.gf_deformable_backward.argtypes = [PP, PP, PI, PI, I, I, P, P, P, P,
                                           P, P, P, I, I, I, I, I, I, I, P]
    lib.gf_deformable_backward.restype = I
    return lib


def _build_cut(csrc: Path, cut: str) -> ctypes.CDLL:
    """K6 alone (the parent's from ``csrc``, or this tree's), rebuilt with
    one statement of its kernel replaced (``CUTS``)."""
    side, old, new = CUTS[cut]
    if side == "change":
        csrc = _lib.CSRC_DIR
    work = _lib.BUILD_DIR / f"bench_deformable_{cut}" / "csrc"
    if work.exists():
        shutil.rmtree(work)
    shutil.copytree(csrc, work)
    src = work / "deformable_bwd.cu"
    text = src.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"cut {cut}: {old!r} is not one statement of "
                           f"{src}")
    src.write_text(text.replace(old, new))
    return _build(work, cut, ["deformable_bwd.cu"],
                  _bind_change if side == "change" else _bind_parent)


def _change_k6_features(lib, args, bins):
    """This tree's K6 features launch alone from another build of it, on
    the given bins (the wrapper's call, ``parts`` = the features launch)."""
    feats, pts, wts, num_pts, g_out = args
    b, q, cams, _ = pts.shape
    c, g = feats[0].shape[-1], wts.shape[-1]
    ptrs, hs, ws = _level_args(feats)
    g_feats = [torch.empty_like(f) for f in feats]
    gptrs = (ctypes.c_void_p * len(feats))(*[t.data_ptr() for t in g_feats])
    g_pts, g_wts = torch.empty_like(pts), torch.empty_like(wts)
    bf16 = int(feats[0].dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        code = lib.gf_deformable_backward(
            ptrs, gptrs, hs, ws, len(feats), bf16, pts.data_ptr(),
            wts.data_ptr(), g_out.data_ptr(), g_pts.data_ptr(),
            g_wts.data_ptr(), bins.entries.data_ptr(),
            bins.pixel_start.data_ptr(), b, q // num_pts, num_pts, cams, c,
            g, deformable.FEATURES_LAUNCH, stream)
        if code:
            raise RuntimeError(f"gf_deformable_backward: {code}")
    return run


def _level_args(feats):
    n = len(feats)
    return ((ctypes.c_void_p * n)(*[f.data_ptr() for f in feats]),
            (ctypes.c_int * n)(*[f.shape[2] for f in feats]),
            (ctypes.c_int * n)(*[f.shape[3] for f in feats]))


def _parent_k3(lib, args):
    feats, pts, wts, num_pts = args
    b, q, cams, _ = pts.shape
    c, g = feats[0].shape[-1], wts.shape[-1]
    out = torch.empty(b, q // num_pts, c, dtype=torch.float32,
                      device=pts.device)
    ptrs, hs, ws = _level_args(feats)
    bf16 = int(feats[0].dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        code = lib.gf_deformable_forward(
            ptrs, hs, ws, len(feats), bf16, pts.data_ptr(), wts.data_ptr(),
            out.data_ptr(), b, q // num_pts, num_pts, cams, c, g, stream)
        if code:
            raise RuntimeError(f"parent gf_deformable_forward: {code}")
    return out, run


def _parent_k6(lib, args, whole: bool = True):
    """The parent tree's K6 call: fp32 gradients zeroed, the kernel, the
    feature gradients cast to the maps' dtype (``whole``), or the kernel
    alone on buffers allocated once."""
    feats, pts, wts, num_pts, g_out = args
    b, q, cams, _ = pts.shape
    c, g = feats[0].shape[-1], wts.shape[-1]
    ptrs, hs, ws = _level_args(feats)
    bf16 = int(feats[0].dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream

    def alloc():
        return ([torch.zeros(f.shape, dtype=torch.float32, device=f.device)
                 for f in feats], torch.zeros_like(pts),
                torch.zeros_like(wts))

    def launch(g_feats, g_pts, g_wts):
        gptrs = (ctypes.c_void_p * len(feats))(
            *[t.data_ptr() for t in g_feats])
        code = lib.gf_deformable_backward(
            ptrs, gptrs, hs, ws, len(feats), bf16, pts.data_ptr(),
            wts.data_ptr(), g_out.data_ptr(), g_pts.data_ptr(),
            g_wts.data_ptr(), b, q // num_pts, num_pts, cams, c, g, stream)
        if code:
            raise RuntimeError(f"parent gf_deformable_backward: {code}")

    if whole:
        def run():
            g_feats, g_pts, g_wts = alloc()
            launch(g_feats, g_pts, g_wts)
            return [t.to(f.dtype) for t, f in zip(g_feats, feats)], g_pts, \
                g_wts
        return run
    bufs = alloc()
    return lambda: launch(*bufs)


def _fills_cast(args):
    """The parent wrapper's work around its kernel: the zero fills and the
    cast of the feature gradients."""
    feats, pts, wts = args[:3]

    def run():
        g = [torch.zeros(f.shape, dtype=torch.float32, device=f.device)
             for f in feats]
        torch.zeros_like(pts)
        torch.zeros_like(wts)
        return [t.to(f.dtype) for t, f in zip(g, feats)]
    return run


def _by_image_position(k3_args):
    """K3's inputs with the anchors reordered by the camera and image
    position (row band, then u) of their first in-image key point: what an
    ordering for L1 / L2 locality would give, its sort not counted."""
    feats, pts, wts, k = k3_args
    b, q, cams, _ = pts.shape
    p = q // k
    per = pts.reshape(b, p, k * cams, 2)
    inside = ((per > 0) & (per < 1)).all(-1)
    first = inside.float().argmax(-1)                      # [b, p]
    uv = per.gather(2, first[..., None, None].expand(b, p, 1, 2))[:, :, 0]
    key = ((first % cams).float() * 64 + torch.floor(uv[..., 1] * 64)) * 2 \
        + uv[..., 0].clamp(0, 1)
    order = torch.argsort(key, dim=1)
    rows = torch.arange(b, device=pts.device)[:, None]
    pts2 = pts.reshape(b, p, k, cams, 2)[rows, order].reshape(pts.shape)
    wts2 = wts.reshape(b, p, k, *wts.shape[2:])[rows, order].reshape(
        wts.shape)
    return feats, pts2.contiguous(), wts2.contiguous(), k


def capture(name):
    """The config's first K3 call of a frame and first K6 call of a train
    step: (cfg, k3 args, k6 args)."""
    cfg = get_config(name)
    model = build_segmentor(cfg, device="cuda", seed=0)
    g = cfg.grid
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=0,
                            device="cuda")
    first = {}
    orig = {k: getattr(deformable, k) for k in (
        "deformable_aggregation_cuda",
        "deformable_aggregation_backward_cuda")}

    def spy(key, fn):
        def wrapped(*a, **k):
            first.setdefault(key, a)
            return fn(*a, **k)
        return wrapped
    deformable.deformable_aggregation_cuda = spy(
        "k3", orig["deformable_aggregation_cuda"])
    deformable.deformable_aggregation_backward_cuda = spy(
        "k6", orig["deformable_aggregation_backward_cuda"])
    try:
        with torch.inference_mode():
            gen = torch.Generator(device="cuda").manual_seed(0)
            model(batch["imgs"], batch["projection_mat"], batch["image_wh"],
                  batch["occ_xyz"], generator=gen)
        k3 = first.pop("k3")
        opt, schedule = build_optimizer(model, cfg, 10000)
        gen = torch.Generator(device="cuda").manual_seed(0)
        train_step(model, opt, schedule, build_loss(cfg), batch, gen)
        torch.cuda.synchronize()
    finally:
        for k, fn in orig.items():
            setattr(deformable, k, fn)
    del model, batch, opt
    torch.cuda.empty_cache()
    k6 = tuple(t.detach() if isinstance(t, torch.Tensor) else t
               for t in first["k6"])
    return cfg, k3, k6


def bench_case(tag, k3_args, k6_args, libs, order, split, iters):
    """Time K3 and K6 of one config (and the parent's in turns); returns
    its row."""
    pts = k6_args[1]
    inside = ((pts[..., 0] > 0) & (pts[..., 0] < 1) & (pts[..., 1] > 0)
              & (pts[..., 1] < 1)).sum().item()
    row = dict(case=tag, points_shape=list(pts.shape),
               levels=[list(f.shape[2:4]) for f in k6_args[0]],
               inside_pairs=inside)
    feats = k6_args[0]
    shapes = [tuple(f.shape[2:4]) for f in feats]
    bins = deformable.bin_samples_cuda(pts, shapes)
    row.update(bins.stats(), workspace_bytes=bins.workspace_bytes)
    row["bins_ms"] = _ms(lambda: deformable.bin_samples_cuda(pts, shapes),
                         iters)
    for part, bit in (("points", deformable.POINTS_LAUNCH),
                      ("features", deformable.FEATURES_LAUNCH)):
        row[f"k6_{part}_ms"] = _ms(
            lambda: deformable.deformable_aggregation_backward_cuda(
                *k6_args, bins=bins, parts=bit), iters)
    sorted3 = _by_image_position(k3_args)
    row["k3_by_image_position_ms"] = _ms(
        lambda: deformable.deformable_aggregation_cuda(*sorted3), iters)
    del sorted3
    runs = {"change": (
        lambda: deformable.deformable_aggregation_cuda(*k3_args),
        lambda: deformable.deformable_aggregation_backward_cuda(*k6_args))}
    if "parent" in libs:
        out3, run3 = _parent_k3(libs["parent"], k3_args)
        run3()
        got3 = deformable.deformable_aggregation_cuda(*k3_args)
        run6 = _parent_k6(libs["parent"], k6_args)
        p6 = run6()
        got6 = deformable.deformable_aggregation_backward_cuda(*k6_args)
        ref6 = (*p6[0], p6[1], p6[2])
        new6 = (*got6[0], got6[1], got6[2])
        row["k3_vs_parent_max_abs"] = (got3 - out3).abs().max().item()
        row["k6_vs_parent_rel_err"] = [
            ((a.float() - b.float()).abs().max()
             / b.float().abs().max().clamp_min(1e-30)).item()
            for a, b in zip(new6, ref6)]
        runs["parent"] = (run3, run6)
        if split:
            row["split_fills_cast_ms"] = _ms(_fills_cast(k6_args), iters)
            row["split_kernel_ms"] = _ms(
                _parent_k6(libs["parent"], k6_args, whole=False), iters)
            for cut, (side, _, _) in CUTS.items():
                run = (_parent_k6(libs[cut], k6_args, whole=False)
                       if side == "parent" else
                       _change_k6_features(libs[cut], k6_args, bins))
                row[f"split_{cut}_ms"] = _ms(run, iters)
    for who in order:
        r3, r6 = runs[who]
        row.setdefault(f"k3_{who}_ms", []).append(_ms(r3, iters))
        row.setdefault(f"k6_{who}_ms", []).append(_ms(r6, iters))
    print(f"# {tag}: {json.dumps(row)}", flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree's csrc directory to time beside")
    ap.add_argument("--split", action="store_true",
                    help="also split the parent's K6 call (needs --parent)")
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS))
    args = ap.parse_args(argv)
    if args.split and args.parent is None:
        ap.error("--split needs --parent")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}", flush=True)
    libs = {"change": _lib.lib()}
    if args.parent is not None:
        libs["parent"] = _build(args.parent, "parent")
        if args.split:
            for cut in CUTS:
                libs[cut] = _build_cut(args.parent, cut)
    order = (["parent", "change", "change", "parent"] if "parent" in libs
             else ["change", "change"])
    result = {"card": card, "rows": []}
    for name in args.configs:
        _, k3_args, k6_args = capture(name)
        result["rows"].append(bench_case(name, k3_args, k6_args, libs,
                                         order, args.split, ITERS))
        del k3_args, k6_args
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
