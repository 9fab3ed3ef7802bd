#!/usr/bin/env python3
"""Drive the PyTorch port's prob_gs6400 inference on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits nonzero):

1. build    compile the port's CUDA kernels (csrc/*.cu, nvcc, sm_90a);
2. forward  one warm-up frame of the full prob_gs6400 forward at full
            width (6 x 864 x 1600 images, 6400 Gaussians, 200 x 200 x 16
            grid, random weights from a seed), capturing each kernel's
            inputs; then one counted frame (every launch counter set to 0
            just before, read just after: 52 DCN, 1 FPS, 4 deformable,
            1 splat launches) and three timed frames;
3. kernels  each kernel against its plain PyTorch version on the captured
            inputs, with its tolerance; kernel, plain and bound times;
4. small    the tiny config end to end on the GPU (towers without DCN,
            fp32) against the same model run on the CPU.

The second-to-last lines are the card's name and power limit and a JSON
``kernels`` line; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

FRAMES = 3
EXPECTED_LAUNCHES = {"dcn": 52, "fps": 1, "deformable": 4, "splat": 1}
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

    # ---- 2. full forward
    cfg = get_config("prob_gs6400")
    t0 = time.perf_counter()
    model = build_segmentor(cfg, device="cuda", seed=0)
    g = cfg.grid
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=0,
                            device="cuda")
    torch.cuda.synchronize()
    log(f"# setup (weights + batch): {time.perf_counter() - t0:.1f} s")

    def frame(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return model(batch["imgs"], batch["projection_mat"],
                     batch["image_wh"], batch["occ_xyz"], generator=gen)

    cap = Capture([
        (dcn, "deform_conv2d_cuda", lambda x, *a: ("dcn", x.shape[-1])),
        (fps, "farthest_point_sampling_cuda", lambda *a: ("fps",)),
        (deformable, "deformable_aggregation_cuda",
         lambda *a: ("deformable",)),
        (splat, "splat_accumulate_cuda", lambda *a: ("splat",)),
    ])
    t0 = time.perf_counter()
    out = frame(0)
    torch.cuda.synchronize()
    cap.restore()
    log(f"# warm-up frame: {time.perf_counter() - t0:.2f} s")

    _lib.reset_launches()
    out = frame(1)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    log(f"# launches in one frame: {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise RuntimeError(f"launch counts {launches} != "
                           f"{EXPECTED_LAUNCHES}")
    occ = out["final_occ"]
    pred = out["pred_occ"][-1]
    if tuple(occ.shape) != (1, g.num_voxels):
        raise RuntimeError(f"final_occ shape {tuple(occ.shape)}")
    if occ.min().item() < 0 or occ.max().item() >= cfg.num_classes:
        raise RuntimeError("final_occ labels outside 0..17")
    if not torch.isfinite(pred).all():
        raise RuntimeError("pred_occ is not finite")
    hist = torch.bincount(occ.flatten().long(), minlength=cfg.num_classes)
    log(f"# final_occ label histogram: {hist.tolist()}")

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(FRAMES):
        frame(2 + i)
    end.record()
    torch.cuda.synchronize()
    frame_ms = start.elapsed_time(end) / FRAMES
    wall_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    log(f"# forward: {frame_ms:.3f} ms/frame (CUDA events), "
        f"{wall_ms:.3f} ms/frame host wall, {FRAMES} frames, batch 1")
    log(f"# peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 3. kernels against their plain versions on the captured inputs
    rows = []
    for key in (("dcn", 256), ("dcn", 512), ("fps",), ("deformable",),
                ("splat",)):
        if key not in cap.calls:
            raise RuntimeError(f"no captured call for {key}")
        rows.append(check_kernel(key, cap.calls[key], launches, cfg,
                                 dcn, fps, deformable, splat))
    del cap

    # ---- 4. the tiny config end to end, GPU against CPU
    check_small(get_config, build_segmentor, synthetic_batch)

    kernels = [r for r in rows if r.pop("report")]
    log(json.dumps({"card": card, "frame_ms": frame_ms,
                    "frame_wall_ms": wall_ms}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def check_kernel(key, call, launches, cfg, dcn, fps, deformable, splat):
    """Kernel vs plain on one captured call; returns its kernels-line row
    (``report`` False for the stage-4 DCN shape, printed but folded into
    the one K1 row, which is measured at the stage-3 shape)."""
    import torch
    fn, args = call
    name = key[0]
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
        row = dict(name="deformable_aggregation", route="cuda",
                   source="gaussianformer_tpu_torch/csrc/deformable.cu",
                   replaces="gaussianformer_tpu/ops/pallas/"
                            "deformable_kernel.py:350",
                   launches=launches["deformable"],
                   shape=[list(pts.shape), [list(f.shape[2:4])
                                            for f in feats]],
                   inside_pairs=inside, report=True)
    else:
        points, gdata, box, sem_aug, grid = args
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


def check_small(get_config, build_segmentor, synthetic_batch):
    """The tiny config end to end (fp32 towers without DCN, since the DCN
    kernel takes bf16): the GPU run with the FPS, deformable and splat
    kernels against the CPU run of the same weights with the plain
    versions."""
    import dataclasses
    import torch
    cfg = dataclasses.replace(get_config("prob_gs6400_tiny"),
                              stage_with_dcn=(False,) * 4)
    g = cfg.grid
    outs = []
    for dev in ("cpu", "cuda"):
        model = build_segmentor(cfg, device=dev, seed=1)
        batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=1,
                                device=dev)
        # no random draw on either device: top-1 depths of 1-2 m and the
        # no-occupancy bin disabled keep every candidate valid
        model.lifter.deterministic_sampling = True
        model.lifter.depth_min, model.lifter.depth_max = 1.0, 2.0
        with torch.no_grad():
            model.lifter.projection[1].bias[-1] = -1e4
        draws = (torch.zeros(1, 6 * 8 * 12, dtype=torch.long, device=dev),
                 torch.zeros(1, 6 * 8 * 12, 3, device=dev))
        out = model(batch["imgs"], batch["projection_mat"],
                    batch["image_wh"], batch["occ_xyz"], lifter_draws=draws)
        outs.append({k: (v[-1] if isinstance(v, list) else v)
                     for k, v in out.items()
                     if k in ("pred_occ", "bin_logits", "final_occ")})
    cpu, gpu = outs
    # Voxel truncation, integer AABBs and FPS near-ties are discontinuous:
    # last-bit differences between the devices can flip a few voxels, so
    # the gate is the share of values within 1e-3 and of equal labels.
    close = min((gpu[k].float().cpu() - cpu[k].float()).abs().le(1e-3)
                .float().mean().item() for k in ("pred_occ", "bin_logits"))
    err = max((gpu[k].float().cpu() - cpu[k].float()).abs().max().item()
              for k in ("pred_occ", "bin_logits"))
    agree = (gpu["final_occ"].cpu() == cpu["final_occ"]).float().mean().item()
    log(f"# tiny config GPU vs CPU: {close:.6f} of pred_occ/bin_logits "
        f"within 1e-3 (max_abs_err {err:.3e}), labels agree on {agree:.6f} "
        f"(both required >= 0.99)")
    if not (close >= 0.99 and agree >= 0.99):
        raise RuntimeError("tiny config: GPU and CPU runs disagree")

if __name__ == "__main__":
    sys.exit(main())
