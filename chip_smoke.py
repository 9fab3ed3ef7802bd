#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: the prob_gs6400 (GaussianFormer-2)
inference and training step, and the v1 GaussianFormer configs
(gs25600_solid and gs144000, inference and training step).

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits nonzero):

1. build    compile the port's CUDA kernels (csrc/*.cu, nvcc, sm_90a);
2. forward  one warm-up frame of the full prob_gs6400 forward at full
            width (6 x 864 x 1600 images, 6400 Gaussians, 200 x 200 x 16
            grid, random weights from a seed) under inference mode,
            capturing each kernel's inputs; then one counted frame (every
            launch counter set to 0 just before, read just after: 52 DCN,
            1 FPS, 4 deformable, 1 splat launches, no backward kernel) and
            three timed frames;
3. kernels  each forward kernel against its plain PyTorch version on the
            captured inputs, with its tolerance; kernel, plain and bound
            times;
4. small    the tiny config's forward on the GPU (towers without DCN,
            fp32) against the same model run on the CPU;
5. train    the full-width train step (forward with dropout, losses,
            backward, clipping, AdamW) on the same model: one warm-up step
            capturing the backward kernels' inputs, one counted step (the
            forward kernels as in phase 2 plus 52 DCN, 4 deformable and 1
            splat backward launches), three timed steps and one profiled
            step for the device's idle share; finite loss terms and
            gradient norm, trained parameters moved, frozen ones unchanged
            to the bit;
6. backward each backward kernel against its plain backward version on the
            captured inputs and cotangents;
7. small    two tiny-config train steps on the GPU against the CPU;
8. v1       gs25600_solid at full width (25,600 anchors and the empty
            Gaussian, one tower): frames as in phase 2 (26 DCN, no FPS, 4
            deformable, 1 additive splat launch), then gs144000 (144,000
            anchors, no opacities) the same way; the additive splat and the
            deformable aggregation against their plain versions on both
            configs' inputs (the splat's sums per class column, its labels
            where the plain sums have a clear winner and 0 where no
            Gaussian reaches a voxel; with the empty Gaussian, which
            decides the labels at init, once more with its semantics
            zeroed); each config's train step as in phase 5 (plus
            26 DCN, 4 deformable and 1 additive splat backward launches,
            or 4 splats and 4 backwards where gs144000 supervises every
            refine layer; the lifter's bank and the head's empty_scalar
            among the trained leaves) and its backward kernels as in phase
            6, the empty Gaussian's gradient row held on its own and the
            other rows to their own largest value; the tiny
            gs25600_solid forward and two train steps, GPU against CPU.

The second-to-last lines are the card's name and power limit and a JSON
``kernels`` line; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import types

FRAMES = 3
STEPS = 3
NO_LAUNCH = {"dcn": 0, "fps": 0, "deformable": 0, "splat": 0,
             "splat_additive": 0, "dcn_bwd": 0, "deformable_bwd": 0,
             "splat_bwd": 0, "splat_bwd_additive": 0}
EXPECTED_LAUNCHES = {**NO_LAUNCH, "dcn": 52, "fps": 1, "deformable": 4,
                     "splat": 1}
# a train step without checkpointing: the forward's kernels once, and each
# backward kernel once per forward launch
EXPECTED_TRAIN_LAUNCHES = {**EXPECTED_LAUNCHES, "dcn_bwd": 52,
                           "deformable_bwd": 4, "splat_bwd": 1}
# the v1 configs: one tower (26 DCN blocks), no FPS, the additive splat
V1_LAUNCHES = {**NO_LAUNCH, "dcn": 26, "deformable": 4, "splat_additive": 1}
V1_TRAIN_LAUNCHES = {**V1_LAUNCHES, "dcn_bwd": 26, "deformable_bwd": 4,
                     "splat_bwd_additive": 1}
# gs144000 supervises all four refine layers: four splats and backwards
V1_ALL_TRAIN_LAUNCHES = {**V1_TRAIN_LAUNCHES, "splat_additive": 4,
                         "splat_bwd_additive": 4}
# tolerances of the backward kernels against their plain versions: a bf16
# output may differ by a rounding flip of its fp32 sum (two bf16 ulps at the
# top of the range); fp32 gradients summed over thousands of terms in
# another order, with atomics whose order changes from run to run, to 1e-3
# of the largest |ref|
BF16_TOL = 2.0 ** -7
SUM_TOL = 1e-3
# the additive backward kernel walks a box of more voxels than this in
# segments (``csrc/splat_bwd.cu``); among the v1 configs' Gaussians only
# the head's empty one, the last of its table, has such a box
BIG_BOX = 8192
# the tiny train step, GPU against CPU: fp32 sums in another order through
# the whole model and two optimizer steps
TINY_RTOL = 1e-3
# NVIDIA H100 SXM data sheet peaks (dense), for the roofline bounds
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def log(msg):
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
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


class Capture:
    """Record the first inputs each kernel wrapper sees (per shape key)."""

    def __init__(self, modules):
        self.calls = {}
        self._orig = []
        for mod, attr, keyfn in modules:
            fn = getattr(mod, attr)
            self._orig.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, keyfn))

    def _wrap(self, fn, keyfn):
        def wrapped(*args, **kwargs):
            key = keyfn(*args)
            if key not in self.calls:
                # the forward never writes its tensors in place, so the
                # references stay the inputs the kernel saw
                self.calls[key] = (fn, args)
            return fn(*args, **kwargs)
        return wrapped

    def restore(self):
        for mod, attr, fn in self._orig:
            setattr(mod, attr, fn)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from gaussianformer_tpu_torch.kernels import _lib
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 1
    from gaussianformer_tpu_torch.configs import get_config
    from gaussianformer_tpu_torch.data.synthetic import synthetic_batch
    from gaussianformer_tpu_torch.kernels import dcn, deformable, fps, splat
    from gaussianformer_tpu_torch.models.segmentor import build_segmentor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32: matmul=False cudnn=False (fp32 matmuls and convs in "
        f"full fp32)")
    card = gpu_name_and_power()
    log(f"# card: {card}")

    # ---- 1. build
    t0 = time.perf_counter()
    _lib.lib()
    log(f"# build: {time.perf_counter() - t0:.1f} s")
    for line in _lib.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"#   {line.strip()}")
    log(f"# fps cluster size: {_lib.lib().gf_fps_cluster_size()}")

    mods = types.SimpleNamespace(dcn=dcn, fps=fps, deformable=deformable,
                                 splat=splat, lib=_lib)

    # ---- 2. full forward
    cfg = get_config("prob_gs6400")
    model, batch = build(cfg, build_segmentor, synthetic_batch)
    fwd = frame_phase(cfg, model, batch, mods, EXPECTED_LAUNCHES, FRAMES)
    frame_ms, wall_ms = fwd["frame_ms"], fwd["frame_wall_ms"]

    # ---- 3. kernels against their plain versions on the captured inputs
    rows = []
    with torch.inference_mode():
        for key in (("dcn", 256), ("dcn", 512), ("fps",),
                    ("deformable", cfg.total_anchors * 7),
                    ("splat", "prob", cfg.total_anchors)):
            rows.append(check_kernel(key, captured(fwd["calls"], key),
                                     fwd["launches"], mods))
    del fwd["calls"]

    # ---- 4. the tiny config end to end, GPU against CPU
    check_small("prob_gs6400_tiny", get_config, build_segmentor,
                synthetic_batch)

    # ---- 5. the full-width train step
    train = train_phase(cfg, model, batch, mods, EXPECTED_TRAIN_LAUNCHES,
                        STEPS)

    # ---- 6. backward kernels against their plain versions; without
    # autograd, since the captured tensors may require grad (saved inputs
    # of an autograd Function): the plain versions of K5 and K6 enable it
    # on copies of their own
    for key in (("dcn_bwd", 256), ("dcn_bwd", 512),
                ("deformable_bwd", cfg.total_anchors * 7),
                ("splat_bwd", "prob", cfg.total_anchors)):
        with torch.no_grad():
            rows.append(check_backward(key, captured(train["calls"], key),
                                       train["launches"], mods))
    del train["calls"]

    # ---- 7. the tiny train step, GPU against CPU
    check_small_train("prob_gs6400_tiny", get_config, build_segmentor,
                      synthetic_batch)
    del model, batch
    torch.cuda.empty_cache()

    # ---- 8. the v1 configs
    v1 = v1_phase(get_config, build_segmentor, synthetic_batch, mods, rows)

    kernels = [r for r in rows if r.pop("report")]
    log(json.dumps({"card": card, "frame_ms": frame_ms,
                    "frame_wall_ms": wall_ms,
                    **{k: v for k, v in train.items() if k != "launches"},
                    **v1}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def build(cfg, build_segmentor, synthetic_batch):
    """The config's model with random weights from seed 0 and the
    synthetic batch at its input and grid size, on the card."""
    import torch
    t0 = time.perf_counter()
    model = build_segmentor(cfg, device="cuda", seed=0)
    g = cfg.grid
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=0,
                            device="cuda")
    torch.cuda.synchronize()
    log(f"# {cfg.name} setup (weights + batch): "
        f"{time.perf_counter() - t0:.1f} s")
    return model, batch


def capture_specs(mods, backward: bool):
    """(module, wrapper name, key of a call) of the kernels to capture:
    one key per kernel and shape (and splat variant)."""
    if backward:
        return [
            (mods.dcn, "deform_conv2d_backward_cuda",
             lambda x, *a: ("dcn_bwd", x.shape[-1])),
            (mods.deformable, "deformable_aggregation_backward_cuda",
             lambda feats, pts, *a: ("deformable_bwd", pts.shape[1])),
            (mods.splat, "splat_backward_cuda",
             lambda pts, gdata, *a: ("splat_bwd", a[-1], gdata.shape[0])),
        ]
    return [
        (mods.dcn, "deform_conv2d_cuda", lambda x, *a: ("dcn", x.shape[-1])),
        (mods.fps, "farthest_point_sampling_cuda", lambda *a: ("fps",)),
        (mods.deformable, "deformable_aggregation_cuda",
         lambda feats, pts, *a: ("deformable", pts.shape[1])),
        (mods.splat, "splat_accumulate_cuda",
         lambda pts, gdata, *a: ("splat", a[-1], gdata.shape[0])),
    ]


def captured(calls, key):
    if key not in calls:
        raise RuntimeError(f"no captured call for {key}; have {list(calls)}")
    return calls[key]


def frame_phase(cfg, model, batch, mods, expected, frames):
    """The config's full-width forward under inference mode: a warm-up
    frame capturing each kernel's inputs, a counted frame (every launch
    count set to 0 just before, read just after) with the output gates,
    and ``frames`` timed frames. Raises on wrong counts or outputs."""
    import torch
    g = cfg.grid

    def frame(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        with torch.inference_mode():
            return model(batch["imgs"], batch["projection_mat"],
                         batch["image_wh"], batch["occ_xyz"], generator=gen)

    torch.cuda.reset_peak_memory_stats()
    cap = Capture(capture_specs(mods, backward=False))
    t0 = time.perf_counter()
    out = frame(0)
    torch.cuda.synchronize()
    cap.restore()
    log(f"# {cfg.name} warm-up frame: {time.perf_counter() - t0:.2f} s")

    mods.lib.reset_launches()
    out = frame(1)
    torch.cuda.synchronize()
    launches = dict(mods.lib.LAUNCHES)
    log(f"# {cfg.name} launches in one frame: {launches}")
    if launches != expected:
        raise RuntimeError(f"{cfg.name} launch counts {launches} != "
                           f"{expected}")
    occ = out["final_occ"]
    pred = out["pred_occ"][-1]
    if tuple(occ.shape) != (1, g.num_voxels):
        raise RuntimeError(f"final_occ shape {tuple(occ.shape)}")
    if occ.min().item() < 0 or occ.max().item() >= cfg.num_classes:
        raise RuntimeError("final_occ labels outside 0..17")
    if tuple(pred.shape) != (1, g.num_voxels, cfg.num_classes):
        raise RuntimeError(f"pred_occ shape {tuple(pred.shape)}")
    if not torch.isfinite(pred).all():
        raise RuntimeError("pred_occ is not finite")
    hist = torch.bincount(occ.flatten().long(), minlength=cfg.num_classes)
    log(f"# {cfg.name} final_occ label histogram: {hist.tolist()}")
    del out, occ, pred

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(frames):
        frame(2 + i)
    end.record()
    torch.cuda.synchronize()
    frame_ms = start.elapsed_time(end) / frames
    wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"# {cfg.name} forward: {frame_ms:.3f} ms/frame (CUDA events), "
        f"{wall_ms:.3f} ms/frame host wall, {frames} frames, batch 1")
    log(f"# {cfg.name} peak device memory: {peak_gib:.2f} GiB")
    return dict(calls=cap.calls, launches=launches, frame_ms=frame_ms,
                frame_wall_ms=wall_ms, frame_peak_gib=peak_gib)


def v1_phase(get_config, build_segmentor, synthetic_batch, mods, rows):
    """Phase 8: the two v1 configs at full width. Appends their kernel
    rows to ``rows`` and returns the summary numbers."""
    import torch
    summary = {}
    for name in ("gs25600_solid", "gs144000"):
        cfg = get_config(name)
        model, batch = build(cfg, build_segmentor, synthetic_batch)
        p = cfg.num_anchor + int(cfg.with_empty)
        pk = cfg.num_anchor * (len(cfg.fix_scale) + cfg.num_learnable_pts)
        fwd = frame_phase(cfg, model, batch, mods, V1_LAUNCHES, FRAMES)
        with torch.inference_mode():
            for key in (("deformable", pk), ("splat", "additive", p)):
                rows.append(check_kernel(key, captured(fwd["calls"], key),
                                         fwd["launches"], mods, tag=name))
        del fwd["calls"], fwd["launches"]
        summary.update({f"{name}_{k}": v for k, v in fwd.items()})
        expected = (V1_ALL_TRAIN_LAUNCHES if cfg.apply_loss_type == "all"
                    else V1_TRAIN_LAUNCHES)
        train = train_phase(cfg, model, batch, mods, expected, STEPS)
        with torch.no_grad():
            for key in (("deformable_bwd", pk),
                        ("splat_bwd", "additive", p)):
                rows.append(check_backward(
                    key, captured(train["calls"], key), train["launches"],
                    mods, tag=name))
        del train["calls"], train["launches"]
        summary.update({f"{name}_{k}": v for k, v in train.items()})
        del model, batch, train
        torch.cuda.empty_cache()
    check_small("gs25600_solid_tiny", get_config, build_segmentor,
                synthetic_batch)
    check_small_train("gs25600_solid_tiny", get_config, build_segmentor,
                      synthetic_batch)
    return summary


def check_kernel(key, call, launches, mods, tag=""):
    """Kernel vs plain on one captured call; returns its kernels-line row
    (``report`` False for the stage-4 DCN shape, printed but folded into
    the one K1 row, which is measured at the stage-3 shape). ``tag``: the
    config whose shapes these are, where not the flagship's."""
    dcn, fps, deformable, splat = (mods.dcn, mods.fps, mods.deformable,
                                   mods.splat)
    fn, args = call
    name = key[0]
    suffix = f"_{tag}" if tag else ""
    if name == "dcn":
        x, offset, mask, weight, epi = args
        b, h, w, cin = x.shape
        cout = weight.shape[-1]
        got = fn(*args)
        ref = dcn.deform_conv2d_plain(*args)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        # bf16 output (8 significant bits) of a 9*C_in-term fp32 sum whose
        # bf16-rounded samples may differ by one ulp: four bf16 ulps at the
        # top of the output's range
        tol = 2.0 ** -6 * scale
        ms = cuda_ms(lambda: fn(*args), 20)
        plain_ms = cuda_ms(lambda: dcn.deform_conv2d_plain(*args), 2)
        flops = 2.0 * b * h * w * 9 * cin * cout
        nbytes = (x.numel() * 2 + b * h * w * 27 * 4 + weight.numel() * 2
                  + 2 * cout * 4 + b * h * w * cout * 2)
        row = dict(name="deform_conv2d", route="cuda",
                   source="gaussianformer_tpu_torch/csrc/dcn.cu",
                   replaces="gaussianformer_tpu/ops/pallas/dcn_kernel.py:206",
                   launches=launches["dcn"], shape=[b, h, w, cin, cout],
                   report=cin == 256)
    elif name == "fps":
        points, num_samples = args[0], args[1]
        got = fn(*args)
        ref = fps.farthest_point_sampling_plain(*args)
        err = float((got != ref).sum().item())   # indices must be equal
        tol = 0.0
        ms = cuda_ms(lambda: fn(*args), 5)
        plain_ms = cuda_ms(lambda: fps.farthest_point_sampling_plain(*args),
                           1)
        n = points.shape[0]
        flops = float(num_samples) * n * 9        # 3 sub, 3 mul, 2 add, min
        nbytes = n * 12 + num_samples * 4
        row = dict(name="farthest_point_sampling", route="cuda",
                   source="gaussianformer_tpu_torch/csrc/fps.cu",
                   replaces="gaussianformer_tpu/ops/pallas/fps_kernel.py:56",
                   launches=launches["fps"], shape=[n, num_samples],
                   report=True)
    elif name == "deformable":
        feats, pts, wts, num_pts = args
        got = fn(*args)
        ref = deformable.deformable_aggregation_plain(*args)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        # fp32 sums of bf16 features in another order
        tol = 1e-4 * max(scale, 1.0)
        ms = cuda_ms(lambda: fn(*args), 20)
        plain_ms = cuda_ms(
            lambda: deformable.deformable_aggregation_plain(*args), 2)
        c = feats[0].shape[-1]
        inside = ((pts[..., 0] > 0) & (pts[..., 0] < 1) & (pts[..., 1] > 0)
                  & (pts[..., 1] < 1)).sum().item()
        # per in-image (key point, cam) pair: 4 levels x 4 corners x C
        # multiply-adds, plus the corner weights
        flops = inside * len(feats) * (4 * c * 2 + 20)
        nbytes = (sum(f.numel() * f.element_size() for f in feats)
                  + pts.numel() * 4 + wts.numel() * 4 + got.numel() * 4)
        row = dict(name="deformable_aggregation" + suffix, route="cuda",
                   source="gaussianformer_tpu_torch/csrc/deformable.cu",
                   replaces="gaussianformer_tpu/ops/pallas/"
                            "deformable_kernel.py:350",
                   launches=launches["deformable"],
                   shape=[list(pts.shape), [list(f.shape[2:4])
                                            for f in feats]],
                   inside_pairs=inside, report=True)
    elif key[1] == "additive":
        points, gdata, box, sem_aug, grid, variant = args
        got = fn(*args)
        ref = splat.splat_accumulate_plain(*args)
        c = sem_aug.shape[1] - 2
        err, tol = held_additive(f"splat_additive{suffix}", got, ref, c)
        if splat_pairs(points, box[-1:], grid) > BIG_BOX:
            # the last Gaussian is the head's empty one: its whole-grid row
            # can decide every label, so the sums and the label epilogue
            # are held once more with its semantics zeroed, on the labels
            # the other Gaussians give
            sem0 = sem_aug.clone()
            sem0[-1, :c] = 0.0
            args0 = (points, gdata, box, sem0, grid, variant)
            held_additive(f"splat_additive{suffix} (last Gaussian's "
                          f"semantics zeroed)", fn(*args0),
                          splat.splat_accumulate_plain(*args0), c)
            del sem0, args0
        ms = cuda_ms(lambda: fn(*args), 10)
        plain_ms = cuda_ms(lambda: splat.splat_accumulate_plain(*args), 1,
                           warmup=0)
        pairs = splat_pairs(points, box, grid)
        # per (point, Gaussian) pair in the AABB: displacement and
        # quadratic form (~20), exp (~4), C multiply-adds
        flops = pairs * (24 + 2 * c)
        n = points.shape[0]
        nbytes = (n * 12 + gdata.numel() * 4 + box.numel() * 4
                  + sem_aug.numel() * 4 + n * (c + 2 + 1) * 4)
        log(f"# splat_additive{suffix}: {pairs} AABB pairs, "
            f"{gdata.shape[0]} Gaussians")
        row = dict(name="splat_additive" + suffix, route="cuda",
                   source="gaussianformer_tpu_torch/csrc/splat.cu",
                   replaces="gaussianformer_tpu/ops/pallas/"
                            "splat_kernel.py:249",
                   launches=launches["splat_additive"],
                   shape=[n, gdata.shape[0]], aabb_pairs=pairs, report=True)
    else:
        points, gdata, box, sem_aug, grid, variant = args
        got = fn(*args)
        ref = splat.splat_accumulate_plain(*args)
        err = (got[0] - ref[0]).abs().max().item()
        # fp32 sums over up to thousands of Gaussians in another order
        tol = 1e-4 * max(ref[0].abs().max().item(), 1.0)
        err_om = (got[1] - ref[1]).abs().max().item()
        log(f"# splat one_minus max_abs_err {err_om:.3e} (tol 1e-4)")
        if not err_om <= 1e-4:
            raise RuntimeError(f"splat one_minus disagrees: {err_om}")
        agree = (got[2] == ref[2]).float().mean().item()
        log(f"# splat labels agree on {agree:.6f} of voxels "
            f"(required >= 0.999: near-ties may flip)")
        if agree < 0.999:
            raise RuntimeError(f"splat labels agree on only {agree}")
        ms = cuda_ms(lambda: fn(*args), 10)
        plain_ms = cuda_ms(lambda: splat.splat_accumulate_plain(*args), 1)
        pairs = splat_pairs(points, box, grid)
        c = sem_aug.shape[1]
        # per (point, Gaussian) pair in the AABB: displacement and
        # quadratic form (~20), exp (~4), C + 2 multiply-adds, 1-e product
        flops = pairs * (24 + 2 * c + 2)
        n = points.shape[0]
        nbytes = (n * 12 + gdata.numel() * 4 + box.numel() * 4
                  + sem_aug.numel() * 4 + n * (c + 2) * 4)
        row = dict(name="splat_prob_labels", route="cuda",
                   source="gaussianformer_tpu_torch/csrc/splat.cu",
                   replaces="gaussianformer_tpu/ops/pallas/"
                            "splat_kernel.py:249",
                   launches=launches["splat"], shape=[n, gdata.shape[0]],
                   aabb_pairs=pairs, report=True)
    peak = PEAK_BF16 if name == "dcn" else PEAK_FP32
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    row.update(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=None)
    log(f"# {row['name']} {row['shape']}: max_abs_err {err:.3e} "
        f"(tol {tol:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    if not err <= tol:
        raise RuntimeError(f"{row['name']} disagrees with its plain "
                           f"version: {err} > {tol}")
    return row


def held_additive(name, got, ref, c):
    """Hold an additive splat's outputs (acc, None, labels) to the plain
    version's, on the whole grid. Sums: each class column within
    SUM_TOL * max|ref column| (fp32 sums over a voxel's Gaussians in
    another order). Labels: equal wherever the plain version's two largest
    sums differ by more than their columns' tolerances together, and 0
    wherever no Gaussian reaches the voxel. Returns the (error, tolerance)
    of the column nearest its tolerance."""
    acc, ref_acc = got[0][:, :c], ref[0][:, :c]
    col_err = (acc - ref_acc).abs().amax(0)
    col_tol = SUM_TOL * ref_acc.abs().amax(0)
    log(f"# {name} sums per class: max_abs_err "
        + " ".join(f"{e:.1e}" for e in col_err.tolist()) + "; tol "
        + " ".join(f"{t:.1e}" for t in col_tol.tolist()))
    if bool((~(col_err <= col_tol)).any()):
        raise RuntimeError(f"{name}: class sums disagree with the plain "
                           f"version: {col_err.tolist()} against "
                           f"{col_tol.tolist()}")
    top = ref_acc.topk(2, dim=-1)
    gap = top.values[:, 0] - top.values[:, 1]
    clear = gap > col_tol[top.indices].sum(-1)
    wrong = int((got[2][clear] != ref[2][clear]).sum().item())
    uncovered = (ref_acc == 0).all(-1)
    unlabelled = int((got[2][uncovered] != 0).sum().item())
    hist = ref[2][clear].long().bincount(minlength=c).tolist()
    log(f"# {name} labels: {int(clear.sum().item())} voxels with a top-two "
        f"gap above the tolerance (classes {hist}), {wrong} of them differ; "
        f"{int(uncovered.sum().item())} voxels that no Gaussian reaches, "
        f"{unlabelled} of them not labelled 0; "
        f"{int((~clear & ~uncovered).sum().item())} near-ties not held")
    if wrong or unlabelled:
        raise RuntimeError(f"{name}: {wrong} labels differ from the plain "
                           f"version, {unlabelled} unreached voxels are not "
                           f"labelled 0")
    worst = int((col_err / col_tol.clamp_min(1e-30)).argmax().item())
    return col_err[worst].item(), col_tol[worst].item()


def splat_pairs(points, box, grid) -> int:
    """(point, Gaussian) pairs inside the AABBs for this run's data: the
    clipped box volume of each Gaussian (the points are the full grid)."""
    import torch
    dims = torch.tensor([grid.H, grid.W, grid.D], device=box.device)
    lo = box[:, :3].long().clamp_min(0)
    hi = torch.minimum(box[:, 3:].long(), dims - 1)
    ext = (hi - lo + 1).clamp_min(0)
    if points.shape[0] != grid.num_voxels:
        raise RuntimeError("splat points are not the full voxel grid")
    return int(ext.prod(-1).sum().item())


def tiny_setup(name, dev, get_config, build_segmentor, synthetic_batch,
               **changes):
    """A tiny config's model and batch on ``dev`` (fp32 towers without
    DCN, since the DCN kernel takes bf16), from seed 1 on either device,
    and the lifter draws to pass. With the image lifter (version 2) no
    random draw takes effect on either device: top-1 depths of 1-2 m and
    the no-occupancy bin disabled keep every candidate valid."""
    import dataclasses
    import torch
    cfg = dataclasses.replace(get_config(name), stage_with_dcn=(False,) * 4,
                              **changes)
    g = cfg.grid
    model = build_segmentor(cfg, device=dev, seed=1)
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=1,
                            device=dev)
    draws = None
    if cfg.version == 2:
        model.lifter.deterministic_sampling = True
        model.lifter.depth_min, model.lifter.depth_max = 1.0, 2.0
        with torch.no_grad():
            model.lifter.projection[1].bias[-1] = -1e4
        draws = (torch.zeros(1, 6 * 8 * 12, dtype=torch.long, device=dev),
                 torch.zeros(1, 6 * 8 * 12, 3, device=dev))
    else:
        # the bank's reference init has zero features and an empty class
        # at 10: give the Gaussians features and a say in the labels
        with torch.no_grad():
            gen = torch.Generator().manual_seed(2)
            model.lifter.instance_feature.copy_(torch.randn(
                model.lifter.instance_feature.shape, generator=gen))
            if cfg.with_empty:
                model.head.empty_scalar.fill_(0.5)
    return cfg, model, batch, draws


def check_small(name, get_config, build_segmentor, synthetic_batch):
    """The tiny config end to end: the GPU run with the FPS (where the
    config has it), deformable and splat kernels against the CPU run of
    the same weights with the plain versions."""
    import torch
    outs = []
    for dev in ("cpu", "cuda"):
        cfg, model, batch, draws = tiny_setup(
            name, dev, get_config, build_segmentor, synthetic_batch)
        with torch.inference_mode():
            out = model(batch["imgs"], batch["projection_mat"],
                        batch["image_wh"], batch["occ_xyz"],
                        lifter_draws=draws)
        outs.append({k: (v[-1] if isinstance(v, list) else v)
                     for k, v in out.items()
                     if k in ("pred_occ", "bin_logits", "final_occ")
                     and not (isinstance(v, list) and not v)})
    cpu, gpu = outs
    floats = [k for k in cpu if k != "final_occ"]
    # Voxel truncation, integer AABBs and FPS near-ties are discontinuous:
    # last-bit differences between the devices can flip a few voxels, so
    # the gate is the share of values within 1e-3 and of equal labels.
    close = min((gpu[k].float().cpu() - cpu[k].float()).abs().le(1e-3)
                .float().mean().item() for k in floats)
    err = max((gpu[k].float().cpu() - cpu[k].float()).abs().max().item()
              for k in floats)
    agree = (gpu["final_occ"].cpu() == cpu["final_occ"]).float().mean().item()
    kinds = torch.unique(cpu["final_occ"]).numel()
    log(f"# {name} GPU vs CPU: {close:.6f} of {'/'.join(floats)} "
        f"within 1e-3 (max_abs_err {err:.3e}), labels agree on {agree:.6f} "
        f"(both required >= 0.99); {kinds} distinct labels")
    if not (close >= 0.99 and agree >= 0.99):
        raise RuntimeError(f"{name}: GPU and CPU runs disagree")


def train_phase(cfg, model, batch, mods, expected, steps):
    """The full-width train step on ``model``: warm-up (capturing the
    backward kernels' inputs), a counted step, ``steps`` timed steps and a
    profiled step. Raises on wrong launch counts, non-finite metrics, a
    trained parameter that did not move or a frozen one that changed."""
    import torch
    from gaussianformer_tpu_torch.profile_forward import device_busy_ms
    from gaussianformer_tpu_torch.train.optim import (build_optimizer,
                                                      frozen_prefixes,
                                                      param_labels)
    from gaussianformer_tpu_torch.train.step import build_loss, train_step

    # the schedule's length shapes only its cosine part, which the few
    # warm-up steps here never reach
    opt, schedule = build_optimizer(model, cfg, 10000)
    loss_fn = build_loss(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    labels = param_labels(model, frozen_prefixes(cfg))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()

    def step(tag):
        metrics = train_step(model, opt, schedule, loss_fn, batch, gen)
        vals = {k: v.item() for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"train step {tag}: non-finite {vals}")
        return vals

    cap = Capture(capture_specs(mods, backward=True))
    t0 = time.perf_counter()
    vals = step("warm-up")
    torch.cuda.synchronize()
    cap.restore()
    log(f"# {cfg.name} train warm-up step: {time.perf_counter() - t0:.2f} s; "
        f"{vals}")

    mods.lib.reset_launches()
    vals = step("counted")
    torch.cuda.synchronize()
    launches = dict(mods.lib.LAUNCHES)
    log(f"# {cfg.name} launches in one train step: {launches}; {vals}")
    if launches != expected:
        raise RuntimeError(f"{cfg.name} train launch counts {launches} != "
                           f"{expected}")

    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start_ev.record()
    for i in range(steps):
        vals = step(f"timed {i}")
    end_ev.record()
    torch.cuda.synchronize()
    step_ms = start_ev.elapsed_time(end_ev) / steps
    step_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"# {cfg.name} train step: {step_ms:.3f} ms/step (CUDA events), "
        f"{step_wall_ms:.3f} ms/step host wall, {steps} steps, batch 1; "
        f"peak device memory {peak_gib:.2f} GiB; last {vals}")

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        start_ev.record()
        step("profiled")
        end_ev.record()
        torch.cuda.synchronize()
    traced_ms = start_ev.elapsed_time(end_ev)
    busy_ms = device_busy_ms(prof.key_averages())
    # the profiler slows the host far more than the device, so the idle
    # share is the device's busy time against an unprofiled step
    idle = None if busy_ms == 0 else 1.0 - busy_ms / step_ms
    log(f"# {cfg.name} profiled train step: {traced_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms; idle share against the unprofiled "
        f"{step_ms:.3f} ms/step: "
        f"{'not measured' if idle is None else f'{idle:.3f}'}")

    frozen_changed, still = [], []
    for n, prm in model.named_parameters():
        same = torch.equal(prm.detach(), start[n])
        if labels[n] == "frozen" and not same:
            frozen_changed.append(n)
        elif labels[n] != "frozen" and same:
            still.append(n)
    n_frozen = sum(lab == "frozen" for lab in labels.values())
    log(f"# {cfg.name} parameters: {len(labels) - n_frozen} trained leaves "
        f"all moved: "
        f"{not still}; {n_frozen} frozen leaves unchanged to the bit: "
        f"{not frozen_changed}")
    if cfg.version == 1:
        for leaf in ("lifter.anchor", "lifter.instance_feature",
                     "head.empty_scalar"):
            if leaf in labels and labels[leaf] == "frozen":
                raise RuntimeError(f"{leaf} must train in {cfg.name}")
        log(f"# {cfg.name} trains the lifter's bank"
            + (f" and head.empty_scalar (now "
               f"{model.head.empty_scalar.item():.6f})"
               if cfg.with_empty else ""))
    if frozen_changed or still:
        raise RuntimeError(f"frozen leaves changed: {frozen_changed[:5]}; "
                           f"trained leaves that did not move: {still[:5]}")
    del start, opt
    return dict(calls=cap.calls, launches=launches, step_ms=step_ms,
                step_wall_ms=step_wall_ms, train_peak_gib=peak_gib,
                train_idle_share=idle, train_loss=vals)


def _max_err(name, got, ref, tol_rel):
    """Max abs error of ``got`` against ``ref`` and the tolerance
    ``tol_rel * max|ref|``; the dtypes and shapes must agree."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise RuntimeError(f"{name}: {got.dtype}{tuple(got.shape)} against "
                           f"{ref.dtype}{tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs().max().item()
    return err, tol_rel * ref.float().abs().max().item()


def check_backward(key, call, launches, mods, tag=""):
    """Backward kernel vs its plain backward version on one captured call;
    returns its kernels-line row (the stage-4 DCN shape is printed but
    not reported, as for K1). ``tag`` as in :func:`check_kernel`."""
    import torch
    dcn, deformable, splat = mods.dcn, mods.deformable, mods.splat
    fn, args = call
    name = key[0]
    suffix = f"_{tag}" if tag else ""
    if name == "dcn_bwd":
        x, offset, mask, weight, g_out = args
        b, h, w, cin = x.shape
        cout = weight.shape[-1]
        plain = dcn.deform_conv2d_backward_plain
        outs = ("g_x", "g_offset", "g_mask", "g_weight")
        tols = (BF16_TOL, SUM_TOL, SUM_TOL, BF16_TOL)
        m = b * h * w
        # the two contractions g_cols = g_out W^T and g_W = cols^T g_out
        flops = 2 * (2.0 * m * 9 * cin * cout)
        nbytes = (2 * x.numel() + m * 27 * 4 + 2 * weight.numel()
                  + 2 * g_out.numel()                       # inputs
                  + 2 * x.numel() + m * 27 * 4 + 2 * weight.numel())
        peak = PEAK_BF16
        row = dict(name="deform_conv2d_backward", route="cuda",
                   source="gaussianformer_tpu_torch/csrc/dcn_bwd.cu",
                   replaces="gaussianformer_tpu/ops/pallas/"
                            "dcn_kernel.py:463",
                   launches=launches["dcn_bwd"], shape=[b, h, w, cin, cout],
                   report=cin == 256)
    elif name == "deformable_bwd":
        feats, pts, wts, num_pts, g_out = args
        plain = deformable.deformable_aggregation_backward_plain
        outs = tuple(f"g_feature_maps[{i}]" for i in range(len(feats))) + (
            "g_points_2d", "g_weights")
        bf16 = feats[0].dtype == torch.bfloat16
        tols = (BF16_TOL if bf16 else SUM_TOL,) * len(feats) + (SUM_TOL,
                                                               SUM_TOL)
        c = feats[0].shape[-1]
        inside = ((pts[..., 0] > 0) & (pts[..., 0] < 1) & (pts[..., 1] > 0)
                  & (pts[..., 1] < 1)).sum().item()
        # per in-image (key point, cam) pair and level: 4 corners x C of
        # the dot with g_out and of the scattered product, plus the corner
        # weights and their derivatives
        flops = inside * len(feats) * (4 * c * 4 + 40)
        fbytes = sum(f.numel() * f.element_size() for f in feats)
        nbytes = (2 * fbytes + 2 * (pts.numel() * 4 + wts.numel() * 4)
                  + g_out.numel() * 4)
        peak = PEAK_FP32
        row = dict(name="deformable_aggregation_backward" + suffix,
                   route="cuda",
                   source="gaussianformer_tpu_torch/csrc/deformable_bwd.cu",
                   replaces="gaussianformer_tpu/ops/pallas/"
                            "deformable_kernel.py:417",
                   launches=launches["deformable_bwd"],
                   shape=[list(pts.shape), [list(f.shape[2:4])
                                            for f in feats]],
                   inside_pairs=inside, report=True)
    else:
        points, gdata, opa, sem, box, gl, scalars, grid, variant = args
        additive = variant == "additive"
        plain = splat.splat_backward_plain
        outs = ("g_means", "g_opacities", "g_semantics", "g_cov_inv6")
        tols = (SUM_TOL,) * 4
        pairs = splat_pairs(points, box, grid)
        n, c = gl.shape
        p = gdata.shape[0]
        # per (voxel, Gaussian) pair in the AABB: displacement and
        # quadratic form (~18), exp (~4), the C-wide dot and gsem
        # multiply-adds (4C), gpower with its division (~10), the nine
        # moments (~24), gw and the weight (~4); the additive variant has
        # no division and no per-voxel scalars (~50)
        flops = pairs * ((50 if additive else 60) + 4 * c)
        nbytes = (n * 12 + gl.numel() * 4
                  + (0 if additive else scalars.numel() * 4)
                  + gdata.numel() * 4 + opa.numel() * 4 + sem.numel() * 4
                  + box.numel() * 4 + p * (3 + 1 + c + 6) * 4)
        peak = PEAK_FP32
        row = dict(name=("splat_bwd_additive" + suffix if additive
                         else "splat_prob_backward"), route="cuda",
                   source="gaussianformer_tpu_torch/csrc/splat_bwd.cu",
                   replaces="gaussianformer_tpu/ops/pallas/"
                            "splat_bwd_kernel.py:196",
                   launches=launches["splat_bwd_additive" if additive
                                     else "splat_bwd"], shape=[n, p],
                   aabb_pairs=pairs, report=True)
    got = fn(*args)
    ref = plain(*args)
    vol = (splat_pairs(points, box[-1:], grid)
           if name == "splat_bwd" and additive else 0)
    if vol > BIG_BOX:
        # the last Gaussian is the head's empty one, whose box is the whole
        # grid: the kernel sums it in segments with atomics
        parts = []
        for out_name, gt, rf in zip(outs, got, ref):
            e, t = _max_err(out_name, gt[-1], rf[-1], SUM_TOL)
            parts.append(f"{out_name} {e:.3e} (tol {t:.3e}, max|ref| "
                         f"{rf[-1].abs().max().item():.3e})")
            if not e <= max(t, 1e-30):
                raise RuntimeError(f"{row['name']}: the last Gaussian's "
                                   f"{out_name} row disagrees: {e} > {t}")
        log(f"# {row['name']} last Gaussian's row (box of {vol} voxels): "
            + ", ".join(parts))
    if name == "deformable_bwd":
        got = (*got[0], got[1], got[2])
        ref = (*ref[0], ref[1], ref[2])
    errors = {}
    whole = {}
    for out_name, gt, rf, tol_rel in zip(outs, got, ref, tols):
        if vol > BIG_BOX:
            # that row, held above, dwarfs the others: they are held to
            # their own largest value
            whole[out_name] = _max_err(out_name, gt, rf, tol_rel)
            gt, rf = gt[:-1], rf[:-1]
        errors[out_name] = _max_err(out_name, gt, rf, tol_rel)
    if whole:
        log(f"# {row['name']} with the last Gaussian's row (not the gate): "
            + ", ".join(f"{k} {e:.3e} (1e-3 max|ref| {t:.3e})"
                        for k, (e, t) in whole.items()))
    del got, ref
    ms = cuda_ms(lambda: fn(*args), 10)
    plain_ms = cuda_ms(lambda: plain(*args), 1)
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    row.update(max_abs_err=max(e for e, _ in errors.values()),
               errors={k: {"max_abs_err": e, "tol": t}
                       for k, (e, t) in errors.items()},
               ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=None)
    log(f"# {row['name']} {row['shape']}: "
        + ", ".join(f"{k} {e:.3e} (tol {t:.3e})"
                    for k, (e, t) in errors.items())
        + f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    bad = {k: e for k, (e, t) in errors.items() if not e <= t}
    if bad:
        raise RuntimeError(f"{row['name']} disagrees with its plain "
                           f"version: {bad}")
    return row


def check_small_train(name, get_config, build_segmentor, synthetic_batch):
    """Two tiny-config train steps (fp32 towers without DCN, dropout off,
    since the devices draw different numbers) on the GPU, with the
    forward and backward kernels, against the CPU run of the same weights
    with the plain versions: loss terms and gradient norm within
    TINY_RTOL, and at least 99% of the gradient elements within
    TINY_RTOL * (|g_cpu| + RMS of the leaf's g_cpu).

    The spconv grid is one voxel here. The synthetic cameras put many of
    the tiny lifter's candidates exactly on whole metres, the spconv voxel
    boundaries, and the devices' sigmoid round trips of the anchors differ
    in the last bits, so an anchor could change voxel between them; one
    such flip changes every encoder gradient."""
    import torch
    from gaussianformer_tpu_torch.train.optim import build_optimizer
    from gaussianformer_tpu_torch.train.step import build_loss, train_step
    runs = []
    for dev in ("cpu", "cuda"):
        cfg, model, batch, _ = tiny_setup(
            name, dev, get_config, build_segmentor, synthetic_batch,
            attn_drop=0.0, ffn_drop=0.0,
            spconv_grid_size=(100.0, 100.0, 8.0))
        opt, schedule = build_optimizer(model, cfg, 10)
        loss_fn = build_loss(cfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        metrics = [{k: v.item() for k, v in train_step(
            model, opt, schedule, loss_fn, batch, gen).items()}
            for _ in range(2)]
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters() if p.grad is not None}
        runs.append((metrics, grads))
    (m_cpu, g_cpu), (m_gpu, g_gpu) = runs
    worst = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12)
                for a, b in zip(m_cpu, m_gpu) for k in a)
    if set(g_cpu) != set(g_gpu):
        raise RuntimeError("tiny train: the devices' gradient leaves differ")
    within = total = 0
    for n, ref in g_cpu.items():
        tol = TINY_RTOL * (ref.abs() + ref.square().mean().sqrt())
        within += int(((g_gpu[n] - ref).abs() <= tol).sum())
        total += ref.numel()
    share = within / total
    log(f"# {name} train GPU vs CPU: worst relative difference of the loss "
        f"terms and grad_norm over 2 steps {worst:.3e} (required <= "
        f"{TINY_RTOL}); {share:.6f} of {total} gradient elements within "
        f"tolerance (required >= 0.99); GPU step 2 {m_gpu[-1]}")
    if not (worst <= TINY_RTOL and share >= 0.99):
        raise RuntimeError(f"{name} train step: GPU and CPU runs disagree")


if __name__ == "__main__":
    sys.exit(main())
