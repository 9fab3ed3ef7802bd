#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: the GaussianFormer-2 configs
(prob_gs6400, prob_gs12800 and prob_gs25600) and the v1 GaussianFormer
configs (gs25600_solid and gs144000), each its inference and training step;
the prob head's threshold label mode and per-axis splat boxes; the port's
bench, and its train and eval CLIs on a nuScenes-shaped set of files; the
model and loss options no shipped config sets; the CLIs in DDP; the
checkpoint converter and the visualize CLI; the splat's general mode, at
query points that are not the splat grid.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits nonzero):

1. build    compile the port's CUDA kernels (csrc/*.cu, nvcc, sm_90a);
2. forward  one warm-up frame of the full prob_gs6400 forward at full
            width (6 x 864 x 1600 images, 6400 Gaussians, 200 x 200 x 16
            grid, random weights from a seed) under inference mode,
            capturing each kernel's inputs; then one counted frame (every
            launch counter set to 0 just before, read just after: 52 DCN,
            1 FPS, 4 deformable, 1 splat binning and 1 splat launches, 4
            spconv voxel tables and 12 fused spconvs, no backward kernel),
            ten timed frames (as many as the bench's loop) and one profiled
            frame for the device's idle share;
3. kernels  each forward kernel against its plain PyTorch version on the
            captured inputs, with its tolerance; kernel, plain and bound
            times; for K1 also cuDNN's dense bf16 3x3 conv of the same
            shape (conv_ms, a yardstick of the GEMM), for K2 its time a
            selection and its latency floor (the per-step exchange alone,
            as many steps over no points); for K4 its tile bins
            (csrc/splat_bin.cu) against the plain bins, every element
            equal, with their entries, COVERS share, list lengths and time
            (a row of their own; both timed sized by the path's bound, as
            the path bins), K4 timed with its binning and held equal
            on the path's bins, and whether its sums are the plain
            version's bits (informational); for the fused spconv
            (csrc/spconv.cu, at this phase and phase 8's shapes) its voxel
            table equal to the plain one, the bf16 gather form and the
            gather form in fp32 on the same bf16 inputs and the plain
            table, a second call's bits, its voxel table's time, its
            non-empty (anchor, tap) pairs and taps skipped whole, and its
            bound on those pairs beside the bound with every tap dense;
4. small    the tiny config's forward on the GPU (towers without DCN,
            fp32) against the same model run on the CPU;
5. train    the full-width train step (forward with dropout, losses,
            backward, clipping, AdamW) on the same model: one warm-up step
            capturing the backward kernels' inputs, one counted step (the
            forward kernels as in phase 2 but the spconv, whose gather
            form runs under autograd, plus 52 DCN, 4 deformable
            binnings, 4 deformable and 1 splat backward launches), three timed steps and one profiled
            step for the device's idle share; finite loss terms and
            gradient norm, trained parameters moved, frozen ones unchanged
            to the bit;
5b. repeat  two plain full-width train runs of 2 steps from one seed and
            one batch (new models), counted: how many gradient leaves are
            bit-equal after each step and the losses' difference (run after
            phase 7; it decides what phase 15 holds);
6. backward each backward kernel against its plain backward version on the
            captured inputs and cotangents (K7 on the forward's bins, as
            the path runs it: equal to K7 binning on its own, the same bits
            on a second call, each of its two launches timed; K6 timed with
            its pixel binning, the same bits on a second call, its bins
            against the plain bins in a row of their own, each of its two
            launches timed); for K5 also the same bits on a second call,
            the share of corners outside its shared-memory g_x window,
            each of its six launches' time (CUDA events; the fallback bins
            are seven small ones, timed as one), and the stage-3 inputs
            once more with the offsets moved by up to 6 px, so that its
            fallback records run at full width (there too a second call
            gives the same bits);
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
            26 DCN, 4 deformable binnings, 4 deformable and 1 additive splat
            backward launches,
            or 4 binnings, 4 splats and 4 backwards where gs144000
            supervises every refine layer; the lifter's bank and the head's
            empty_scalar among the trained leaves) and its backward kernels
            as in phase 6, the empty Gaussian's gradient row (its box the
            whole grid, an entry in every tile) held on its own and the
            other rows to their own largest value; the tiny
            gs25600_solid forward and two train steps, GPU against CPU;
9. family   prob_gs12800 (Prob-128: 6400 FPS anchors + 6400 random) and
            prob_gs25600 (Prob-256: 19,200 FPS anchors + 6400 random) at
            full width, each as phases 2, 3, 5 and 6 do: frames and train
            steps with the flagship's launch counts, every kernel against
            its plain version on the config's own inputs (K2's 6400 or
            19,200 indices all equal);
10. threshold one Prob-256 frame with combine_geosem off (the same seed):
            K4's threshold label epilogue against the plain labels (equal
            but for near-ties, which are counted), its sums to the prob
            tolerance, and its time beside the combine mode's on the same
            inputs;
11. per-axis K4 and K7 on Prob-256's head inputs packed again with
            per-axis boxes, against their plain versions (printed, not in
            the kernels line: no shipped config runs this path);
12. bench   the port's bench (``gaussianformer_tpu_torch.bench.run``) on
            prob_gs6400 at batch 1 with ``--pipeline 4``, in this process,
            run first (after the build, before phase 2), as a bench process
            of its own would run it: its JSON line, its ``# pipeline(4)``
            line from one CUDA-graph replay of 4 frames whose final_occ
            equals the same 4 frames run eagerly (the same images and
            pre-drawn lifter draws) bit for bit, its launch counts (23
            frames' worth: the loop's 11, the pipeline's 4 warm-up and 4
            captured frames, the 4 eager ones; a replay counts nothing;
            every count set to 0 just before, read just after), and, after
            phase 2, the device busy time of one eager frame of the bench's
            own model and batch (profiled) within 15% of phase 2's profiled
            frame's: device time, which the shared host does not move (the
            loop's ms/frame against phase 2's frame_ms, host time included,
            is printed, not held);
13. entry   the entry points on a 2-frame nuScenes-shaped set of files in a
            temporary directory (six 1600 x 900 PNGs a frame, SurroundOcc
            labels, the infos pkl): the native codec loaded; the train CLI
            (``python -m gaussianformer_tpu_torch.train``'s ``main``) for
            one epoch of prob_gs6400 at batch 1 with two loader workers and
            --iter-resume (2 train steps and the epoch's eval of 2 frames,
            counted as one run); ``latest`` names ckpt_000000002.pt and a
            new Trainer resumes at epoch 1, iteration 2; the eval CLI on
            that checkpoint (2 frames, counted): a finite mIoU and counts
            equal to a direct forward of the same batches with the
            generator seeded as eval seeds it. Wall times of the data, the
            steps and the eval, and the checkpoint's size;
14. options the options no shipped config sets, as the JAX package reaches
            them (the segmentor's ``module_overrides``): gs25600_solid with
            polar refinement ("loop"), ``pts_init`` from 25,600 anchor
            points (``_prepare_anchor_points`` on a seeded synthetic scan),
            ``ffn_pre_norm``, the KITTI column order with the empty label 0,
            and the softmax focal loss with scal, Lovasz and dice; and
            prob_gs6400 with ``ffn_pre_norm``, the KITTI order and the full
            loss stack (every OccupancyLoss switch, BCE, density, depth, the
            pixel loss through its sigmoid). Each a counted frame (launches
            of phase 8 or 2) and a counted train step (of phase 8 or 5),
            every output, loss term and the gradient norm finite, frame and
            step times and peak memory; K4 and K7 against their plain
            versions on the variant's own inputs with the phase 3 and 6
            tolerances (the prob labels equal but for counted near-ties);
            both tiny variants GPU against CPU under phase 4's share gates;
15. ddp     the train CLI under ``python -m torch.distributed.run
            --standalone --nproc_per_node=1`` on phase 13's files, seed and
            flags: its log shows DDP over NCCL, its losses equal phase 13's
            (the loss within 1e-5 and the grad norm within 1e-4 relative,
            at step 1 and, where phase 5b's runs repeat, step 2), rank 0 wrote
            ckpt_000000002.pt and ``latest``; the eval CLI under the same
            launcher on phase 13's checkpoint logs phase 13's counts. The
            card's host has one card: a world of two is held on the CPU
            (gloo, tests/test_torch_port_ddp.py);
16. convert the checkpoint converter (``python -m
            gaussianformer_tpu_torch.convert_checkpoint``'s ``main``,
            ``--strict``) on a reference-named state_dict of the full-width
            flagship with seed-7 weights and the reference's weightless
            entries; the eval CLI on its output directory (phase 13's two
            frames, counted) holds those weights and counts what they count
            evaluated directly;
17. vis     the visualize CLI (``python -m
            gaussianformer_tpu_torch.visualize``'s ``main``) at the
            flagship's full width on one synthetic frame, counted: four
            PNGs, each non-empty and of more than one colour (the card's
            host has no matplotlib: ``utils/vis.py`` draws them with PIL);
18. points  the splat's general mode (``csrc/splat_points_bin.cu``,
            ``splat_points.cu``, ``splat_points_bwd.cu``) at occ_xyz the
            grid twice as fine over the same range (400 x 400 x 32,
            5,120,000 points, 8 a voxel, labels repeated; the head declares
            no grid order): the prob_gs6400 frame (counted: one points
            binning and one general K4 in place of the raster K4) and the
            gs25600_solid frame and train step (general K4 and K7
            additive), timed, outputs and losses finite, trained leaves
            moved; general K4 prob on all the points against its plain
            version (phase 3's tolerance, labels equal but for counted
            near-ties), the points bins against theirs in every element, a
            second call's bits and a CUDA graph of the points binning and
            K4 against the eager call; K4 / K7 additive on every 8th point
            (the empty Gaussian's row on its own); on phase 3's and 6's
            flagship inputs, the grid's points permuted: K7 prob against
            its plain version and the raster K7 (phase 6's tolerance), K4
            with 1% of the points past pc_range against its plain version,
            and, put back in order, against the raster K4; per-axis boxes on
            Prob-256's phase 11 inputs, permuted. Then a LiDAR-like query
            set (``data.synthetic.lidar_points(--seed)``: 10 sweeps of a
            32-beam sensor, about 350,000 points, those past pc_range kept):
            K4 prob (the flagship's tables) and additive and K7 additive
            (gs25600_solid's, seeded cotangents) against their plain
            versions at the tolerances above and a second call's bits,
            with their times and the longest block's share of the launch.

    python3 chip_smoke.py [--seed S]

``--seed`` (default 0) seeds phase 18's LiDAR-like set and its cotangents.

The second-to-last lines are the card's name and power limit and a JSON
``kernels`` line; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

FRAMES = 3
STEPS = 3
# phase 2 times as many frames as the bench's loop, which phase 12 holds
# to it: a frame is partly host time, which moves with the shared host
FLAGSHIP_FRAMES = 10
# the bench's frames in one CUDA graph (phase 12)
PIPELINE = 4
# every key of the port's kernels/_lib.py::LAUNCHES: a counted run's whole
# dict is held to an expected one, so a counter missing here fails them all
NO_LAUNCH = {"dcn": 0, "fps": 0, "deformable": 0, "splat_bin": 0,
             "splat": 0, "splat_additive": 0, "dcn_bwd": 0,
             "deformable_bin": 0, "deformable_bwd": 0, "splat_bwd": 0,
             "splat_bwd_additive": 0, "splat_points_bin": 0,
             "splat_points": 0, "splat_points_additive": 0,
             "splat_points_bwd": 0, "splat_points_bwd_additive": 0,
             "spconv_table": 0, "spconv": 0, "bn_epilogue": 0}
# the splat's tile binning runs once per forward splat; the backward takes
# the forward's bins. A frame's 4 spconv modules build a voxel table each
# for their 3 convs. The frozen-BN epilogue runs 74 times a ResNet-101
# tower (the stem, 33 bn1, the 7 bn2 outside the DCN blocks, 33 block ends)
# and once a SECONDFPN branch
EXPECTED_LAUNCHES = {**NO_LAUNCH, "dcn": 52, "fps": 1, "deformable": 4,
                     "splat_bin": 1, "splat": 1, "spconv_table": 4,
                     "spconv": 12, "bn_epilogue": 2 * 74 + 4}
# a train step without checkpointing: the forward's kernels once, and each
# backward kernel once per forward launch (K6 with its pixel binning); the
# spconv under autograd takes its gather form, the frozen BNs PyTorch's
# passes
EXPECTED_TRAIN_LAUNCHES = {**EXPECTED_LAUNCHES, "dcn_bwd": 52,
                           "deformable_bin": 4, "deformable_bwd": 4,
                           "splat_bwd": 1, "spconv_table": 0, "spconv": 0,
                           "bn_epilogue": 0}
# the v1 configs: one tower (26 DCN blocks), no FPS, the additive splat,
# three one-conv spconv modules
V1_LAUNCHES = {**NO_LAUNCH, "dcn": 26, "deformable": 4, "splat_bin": 1,
               "splat_additive": 1, "spconv_table": 3, "spconv": 3,
               "bn_epilogue": 74}
V1_TRAIN_LAUNCHES = {**V1_LAUNCHES, "dcn_bwd": 26, "deformable_bin": 4,
                     "deformable_bwd": 4, "splat_bwd_additive": 1,
                     "spconv_table": 0, "spconv": 0, "bn_epilogue": 0}
# the frozen BNs (profiling's counters bn_fused, bn_eager) of a frame and of
# a train step, by config version: a ResNet-101 tower's 104 (the stem's,
# three a block, four downsamples'), of which a frame's epilogue applies 78
# (K1 the 26 DCN blocks' bn2), and SECONDFPN's 4 (GaussianFormer-2's
# lifter tower); a step applies every one in PyTorch
BN_FRAME = {2: (2 * 78 + 4, 0), 1: (78, 0)}
BN_STEP = {2: (0, 2 * 104 + 4), 1: (0, 104)}
# gs144000 supervises all four refine layers: four splats and backwards
V1_ALL_TRAIN_LAUNCHES = {**V1_TRAIN_LAUNCHES, "splat_bin": 4,
                         "splat_additive": 4, "splat_bwd_additive": 4}
# phase 18, the query points twice as fine as the splat grid: the splat's
# general mode, one points binning and K4 (and K7) in the general mode in
# place of the raster ones, on the same Gaussian binning
POINTS_LAUNCHES = {**EXPECTED_LAUNCHES, "splat": 0, "splat_points_bin": 1,
                   "splat_points": 1}
POINTS_V1_LAUNCHES = {**V1_LAUNCHES, "splat_additive": 0,
                      "splat_points_bin": 1, "splat_points_additive": 1}
POINTS_V1_TRAIN_LAUNCHES = {**V1_TRAIN_LAUNCHES, "splat_additive": 0,
                            "splat_bwd_additive": 0, "splat_points_bin": 1,
                            "splat_points_additive": 1,
                            "splat_points_bwd_additive": 1}
# phase 18's query points: a grid this many times finer than the splat
# grid on each axis, over the same range
FINER = 2
# phase 18 holds the plain additive versions on every this many points
ADDITIVE_STRIDE = 8
# phase 18 moves this share of the points past pc_range
OUTSIDE_SHARE = 0.01
# tolerances of the backward kernels against their plain versions: a bf16
# output may differ by a rounding flip of its fp32 sum (two bf16 ulps at the
# top of the range); fp32 gradients summed over thousands of terms in
# another order, to 1e-3 of the largest |ref|
BF16_TOL = 2.0 ** -7
SUM_TOL = 1e-3
# a box of more voxels than this is the v1 head's empty Gaussian, the last
# of its table, whose box is the whole grid (an entry in every tile of the
# splat's bins): its rows dwarf the others', so they are held on their own
BIG_BOX = 8192
# K5 once more on the stage-3 inputs with offsets moved by up to this many
# pixels, so that its fallback records run at full width
DCN_PERTURB_PX = 6.0
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


def timed(fn):
    """One call of ``fn`` and its time in ms by CUDA events. A plain version
    is timed by the call that makes its reference: the slow ones take
    seconds (the v1 splat backward 29 s), where a warm-up and a second call
    would only add time."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


class Capture:
    """Record the first inputs each kernel wrapper sees (per shape key):
    ``calls[key] = (wrapper, args, kwargs)``."""

    def __init__(self, modules):
        self.calls = {}
        self._orig = []
        for mod, attr, keyfn in modules:
            fn = getattr(mod, attr)
            self._orig.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, keyfn))

    def _wrap(self, fn, keyfn):
        def wrapped(*args, **kwargs):
            key = keyfn(*args, **kwargs)
            if key not in self.calls:
                # the forward never writes its tensors in place, so the
                # references stay the inputs the kernel saw
                self.calls[key] = (fn, args, kwargs)
            return fn(*args, **kwargs)
        return wrapped

    def restore(self):
        for mod, attr, fn in self._orig:
            setattr(mod, attr, fn)


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on "
                                 "one NVIDIA GPU.")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 18's LiDAR-like query set and its "
                         "cotangents")
    opts = ap.parse_args()
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
    from gaussianformer_tpu_torch.kernels import (bn_epilogue, dcn,
                                                  deformable, fps, spconv,
                                                  splat)
    from gaussianformer_tpu_torch.models.segmentor import build_segmentor
    from gaussianformer_tpu_torch.ops import splat as ops_splat

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32: matmul=False cudnn=False (fp32 matmuls and convs in "
        f"full fp32)")
    card = gpu_name_and_power()
    log(f"# card: {card}")
    t_start = time.perf_counter()

    def mark(phase):
        log(f"# phase {phase} done at {time.perf_counter() - t_start:.1f} s")

    # ---- 1. build
    t0 = time.perf_counter()
    _lib.lib()
    log(f"# build: {time.perf_counter() - t0:.1f} s")
    for line in _lib.BUILD_LOG.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            log(f"#   kernel {kernel_name(entry.group(1))}")
        elif "registers" in line or "spill" in line or line.startswith("=="):
            log(f"#   {line.strip()}")
    log(f"# fps cluster size: {_lib.lib().gf_fps_cluster_size()}")

    mods = types.SimpleNamespace(dcn=dcn, fps=fps, deformable=deformable,
                                 splat=splat, spconv=spconv, lib=_lib,
                                 ops_splat=ops_splat,
                                 bn_epilogue=bn_epilogue)

    # ---- 12. the port's bench, first, as a process of its own runs it
    bench = bench_phase(mods)
    mark(12)

    # ---- 2. full forward
    cfg = get_config("prob_gs6400")
    model, batch = build(cfg, build_segmentor, synthetic_batch)
    fwd = frame_phase(cfg, model, batch, mods, EXPECTED_LAUNCHES,
                      FLAGSHIP_FRAMES)
    frame_ms, wall_ms = fwd["frame_ms"], fwd["frame_wall_ms"]
    check_bench(bench, fwd)
    mark(2)

    # ---- 3. kernels against their plain versions on the captured inputs
    rows = []
    with torch.inference_mode():
        for key in (("dcn", 256), ("dcn", 512), ("fps",),
                    ("deformable", cfg.total_anchors * 7),
                    ("splat", "prob", cfg.total_anchors),
                    ("spconv", cfg.total_anchors)):
            rows.append(check_kernel(key, captured(fwd["calls"], key),
                                     fwd["launches"], mods))
        for key in largest_bn_calls(fwd["calls"]):
            rows.append(check_kernel(key, captured(fwd["calls"], key),
                                     fwd["launches"], mods))
    # the flagship's K4 and K7 inputs, which phase 18 runs again in the
    # general mode
    keep = {"k4": captured(fwd["calls"], ("splat", "prob",
                                          cfg.total_anchors))}
    del fwd["calls"]
    # K1's stage-4 numbers ride on its stage-3 row
    k1 = {r["shape"][3]: r for r in rows if r["name"] == "deform_conv2d"}
    k1[256]["stage4"] = {k: k1[512][k] for k in (
        "shape", "ms", "conv_ms", "bound_ms", "max_abs_err")}
    mark(3)

    # ---- 4. the tiny config end to end, GPU against CPU
    check_small("prob_gs6400_tiny", get_config, build_segmentor,
                synthetic_batch)
    mark(4)

    # ---- 5. the full-width train step
    train = train_phase(cfg, model, batch, mods, EXPECTED_TRAIN_LAUNCHES,
                        STEPS)
    mark(5)

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
    keep["k7"] = captured(train["calls"], ("splat_bwd", "prob",
                                           cfg.total_anchors))
    del train["calls"]
    # K5's stage-4 numbers ride on its stage-3 row
    k5 = {r["shape"][3]: r for r in rows
          if r["name"] == "deform_conv2d_backward"}
    k5[256]["stage4"] = {k: k5[512][k] for k in (
        "shape", "ms", "launch_ms", "bound_ms", "window_outside_share",
        "max_abs_err", "repeat_bit_equal")}
    mark(6)

    # ---- 7. the tiny train step, GPU against CPU
    check_small_train("prob_gs6400_tiny", get_config, build_segmentor,
                      synthetic_batch)
    del model, batch
    torch.cuda.empty_cache()
    mark(7)

    # ---- 5b. two plain train runs: the same bits?
    repeat = repeat_phase(cfg, build_segmentor, synthetic_batch, mods)
    mark("5b")

    # ---- 8. the v1 configs
    v1 = v1_phase(get_config, build_segmentor, synthetic_batch, mods, rows)
    mark(8)

    # ---- 9-11. the GaussianFormer-2 family, the threshold label mode and
    # per-axis boxes
    family = prob_family_phase(get_config, build_segmentor, synthetic_batch,
                               mods, rows, keep)
    mark("9-11")

    root = tempfile.mkdtemp(prefix="gf_entry_")
    try:
        # ---- 13. the train and eval CLIs
        entry = entry_phase(mods, root)
        mark(13)

        # ---- 14. the options no shipped config sets
        options = options_phase(get_config, build_segmentor,
                                synthetic_batch, mods, rows)
        mark(14)

        # ---- 15. the CLIs under torch.distributed.run, DDP over NCCL
        ddp = ddp_phase(entry, root, repeat["repeatable"])
        mark(15)

        # ---- 16. the checkpoint converter, then the eval CLI on its output
        convert = convert_phase(mods, root, entry)
        mark(16)

        # ---- 17. the visualize CLI at full width
        vis = vis_phase(mods, root)
        mark(17)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # ---- 18. the splat's general mode: query points that are not the grid
    points = points_phase(get_config, build_segmentor, synthetic_batch, mods,
                          rows, keep, opts.seed)
    del keep
    mark(18)
    entry = {k: v for k, v in entry.items() if not k.startswith("_")}

    flat = []
    for r in rows:
        flat += [r] + r.pop("extra_rows", [])
    kernels = [r for r in flat if r.pop("report")]
    log(json.dumps({"card": card, "frame_ms": frame_ms,
                    "frame_wall_ms": wall_ms,
                    "frame_idle_share": fwd["frame_idle_share"],
                    **{k: v for k, v in train.items() if k != "launches"},
                    **repeat, **v1, **family, "bench": bench, **entry,
                    **options, **ddp, **convert, **vis, **points}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_name(symbol: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    symbol (``..._ZN..20dcn_bwd_input_kernelILi256EEEv..`` ->
    ``dcn_bwd_input_kernel<256>``); the symbol itself if none ends in
    ``_kernel``."""
    for run in re.finditer(r"\d+", symbol):
        for k in range(len(run.group())):
            n = int(run.group()[k:])
            name = symbol[run.end():run.end() + n]
            if n and name.endswith("_kernel") and name.isidentifier():
                args = re.match(r"I((?:L[a-z]\d+E)+)E", symbol[run.end() + n:])
                if args:
                    name += "<" + ", ".join(
                        re.findall(r"L[a-z](\d+)E", args.group(1))) + ">"
                return name
    return symbol


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
    """(module, function name, key of a call) of the kernels to capture:
    one key per kernel and shape (and splat variant); also the head's
    splat inputs before packing (``ops.splat.pack_gaussians``)."""
    pack = (mods.ops_splat, "pack_gaussians",
            lambda means, *a, **k: ("pack", means.shape[0]))
    if backward:
        return [
            (mods.dcn, "deform_conv2d_backward_cuda",
             lambda x, *a, **k: ("dcn_bwd", x.shape[-1])),
            (mods.deformable, "deformable_aggregation_backward_cuda",
             lambda feats, pts, *a, **k: ("deformable_bwd", pts.shape[1])),
            (mods.splat, "splat_backward_cuda",
             lambda pts, gdata, *a, **k: ("splat_bwd", a[-1],
                                          gdata.shape[0])),
            pack,
        ]
    return [
        (mods.dcn, "deform_conv2d_cuda",
         lambda x, *a, **k: ("dcn", x.shape[-1])),
        (mods.fps, "farthest_point_sampling_cuda", lambda *a, **k: ("fps",)),
        (mods.deformable, "deformable_aggregation_cuda",
         lambda feats, pts, *a, **k: ("deformable", pts.shape[1])),
        (mods.splat, "splat_accumulate_cuda",
         lambda pts, gdata, *a, **k: ("splat", a[-1], gdata.shape[0])),
        (mods.spconv, "submanifold_conv3d_cuda",
         lambda x, *a, **k: ("spconv", x.shape[0])),
        (mods.bn_epilogue, "bn_epilogue_cuda",
         lambda a, bn_a, b=None, bn_b=None: (
             "bn_epilogue", bn_form(b, bn_b), a.numel())),
        pack,
    ]


def bn_form(b, bn_b) -> str:
    """The epilogue's form: a BN and ReLU, or a block's end with the
    identity or the downsample conv's BN'd output."""
    return "relu" if b is None else "identity" if bn_b is None \
        else "downsample"


def largest_bn_calls(calls):
    """The keys of the largest captured epilogue call of each form."""
    keys = [k for k in calls if k[0] == "bn_epilogue"]
    return [max((k for k in keys if k[1] == form), key=lambda k: k[2])
            for form in ("relu", "identity", "downsample")]


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

    def frame(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        with torch.inference_mode():
            return model(batch["imgs"], batch["projection_mat"],
                         batch["image_wh"], batch["occ_xyz"],
                         anchor_points=batch.get("anchor_points"),
                         generator=gen)

    torch.cuda.reset_peak_memory_stats()
    cap = Capture(capture_specs(mods, backward=False))
    t0 = time.perf_counter()
    out = frame(0)
    torch.cuda.synchronize()
    cap.restore()
    log(f"# {cfg.name} warm-up frame: {time.perf_counter() - t0:.2f} s")

    mods.lib.reset_launches()
    with traced_bns(cfg.name, "frame", BN_FRAME[cfg.version]):
        out = frame(1)
    torch.cuda.synchronize()
    launches = dict(mods.lib.LAUNCHES)
    log(f"# {cfg.name} launches in one frame: {launches}")
    if launches != expected:
        raise RuntimeError(f"{cfg.name} launch counts {launches} != "
                           f"{expected}")
    occ = out["final_occ"]
    pred = out["pred_occ"][-1]
    n = math.prod(batch["occ_xyz"].shape[1:4])
    if tuple(occ.shape) != (1, n):
        raise RuntimeError(f"final_occ shape {tuple(occ.shape)}")
    if occ.min().item() < 0 or occ.max().item() >= cfg.num_classes:
        raise RuntimeError("final_occ labels outside 0..17")
    if tuple(pred.shape) != (1, n, cfg.num_classes):
        raise RuntimeError(f"pred_occ shape {tuple(pred.shape)}")
    for key in ("pred_occ", "bin_logits", "density"):
        if out[key] and not torch.isfinite(out[key][-1]).all():
            raise RuntimeError(f"{key} is not finite")
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
    idle, busy = idle_share(lambda: frame(2 + frames), frame_ms,
                            f"{cfg.name} frame")
    return dict(calls=cap.calls, launches=launches, frame_ms=frame_ms,
                frame_wall_ms=wall_ms, frame_peak_gib=peak_gib,
                frame_idle_share=idle, frame_busy_ms=busy)


@contextlib.contextmanager
def traced_bns(name, what, expected):
    """Trace what the block runs (``utils/profiling``) and raise unless its
    counters ``bn_fused`` and ``bn_eager`` read ``expected``."""
    from gaussianformer_tpu_torch.utils import profiling
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
    c = profiling.collect()["counters"]
    got = (c.get("bn_fused", 0), c.get("bn_eager", 0))
    log(f"# {name} frozen BNs in one {what}: bn_fused {got[0]}, bn_eager "
        f"{got[1]}")
    if got != expected:
        raise RuntimeError(f"{name}: bn_fused / bn_eager {got} != "
                           f"{expected}")


def idle_share(run, unprofiled_ms, what):
    """The device's idle share of ``run`` (one frame or step): its busy
    time under ``torch.profiler`` against the unprofiled mean time (the
    profiler slows the host far more than the device); None where the
    profiler recorded no device time. Returns (the share, the busy ms)."""
    busy_ms = device_busy(run)
    idle = None if busy_ms == 0 else 1.0 - busy_ms / unprofiled_ms
    log(f"# {what} profiled: device busy {busy_ms:.3f} ms; idle share "
        f"against the unprofiled {unprofiled_ms:.3f} ms: "
        f"{'not measured' if idle is None else f'{idle:.3f}'}")
    return idle, busy_ms


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
            for key in (("deformable", pk), ("splat", "additive", p),
                        ("spconv", cfg.num_anchor)):
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


def prob_family_phase(get_config, build_segmentor, synthetic_batch, mods,
                      rows, keep):
    """Phases 9-11: Prob-128 and Prob-256 at full width, the threshold
    label mode on a Prob-256 frame and per-axis boxes on Prob-256's head
    inputs. Appends their kernel rows to ``rows`` (the per-axis ones
    printed, not reported), keeps the per-axis K4 and K7 calls in ``keep``
    (for phase 18) and returns the summary numbers."""
    import dataclasses
    import torch
    summary = {}
    fwd_kernels = ("dcn", 256), ("dcn", 512), ("fps",)
    bwd_kernels = ("dcn_bwd", 256), ("dcn_bwd", 512)
    for name in ("prob_gs12800", "prob_gs25600"):
        cfg = get_config(name)
        p = cfg.total_anchors
        model, batch = build(cfg, build_segmentor, synthetic_batch)
        fwd = frame_phase(cfg, model, batch, mods, EXPECTED_LAUNCHES, FRAMES)
        with torch.inference_mode():
            for key in fwd_kernels + (("deformable", p * 7),
                                      ("splat", "prob", p)):
                rows.append(check_kernel(key, captured(fwd["calls"], key),
                                         fwd["launches"], mods, tag=name))
        k2 = next(r for r in rows
                  if r["name"] == f"farthest_point_sampling_{name}")
        if k2["shape"][1] != cfg.num_anchor:
            raise RuntimeError(f"{name}: FPS selected {k2['shape'][1]}, "
                               f"not {cfg.num_anchor}")
        train = train_phase(cfg, model, batch, mods,
                            EXPECTED_TRAIN_LAUNCHES, STEPS)
        with torch.no_grad():
            for key in bwd_kernels + (("deformable_bwd", p * 7),
                                      ("splat_bwd", "prob", p)):
                rows.append(check_backward(
                    key, captured(train["calls"], key), train["launches"],
                    mods, tag=name))
            if name == "prob_gs25600":
                keep["per_axis"] = check_per_axis(fwd["calls"],
                                                  train["calls"], p, mods,
                                                  rows)
        for part in (fwd, train):
            del part["calls"], part["launches"]
        summary.update({f"{name}_{k}": v for k, v in fwd.items()})
        summary.update({f"{name}_{k}": v for k, v in train.items()})
        del model, batch, fwd, train
        torch.cuda.empty_cache()

    # ---- 10. the threshold label mode: Prob-256 with combine_geosem off,
    # the same seed
    cfg = get_config("prob_gs25600")
    cfg = dataclasses.replace(cfg, name=f"{cfg.name}_threshold",
                              combine_geosem=False)
    p = cfg.total_anchors
    model, batch = build(cfg, build_segmentor, synthetic_batch)
    fwd = frame_phase(cfg, model, batch, mods, EXPECTED_LAUNCHES, FRAMES)
    key = ("splat", "prob", p)
    call = captured(fwd["calls"], key)
    with torch.inference_mode():
        row = check_kernel(key, call, fwd["launches"], mods,
                           tag="prob_gs25600")
        fn, args, kw = call
        if kw.get("label_mode") != "threshold":
            raise RuntimeError(f"the {cfg.name} head called K4 with {kw}")
        # the accumulation does not depend on the label mode
        row["combine_ms"] = cuda_ms(lambda: fn(*args), 10)
    log(f"# splat_prob_threshold_prob_gs25600: {row['ms']:.4f} ms, the "
        f"combine mode on the same inputs {row['combine_ms']:.4f} ms")
    rows.append(row)
    del fwd["calls"], fwd["launches"], call, args
    summary.update({f"{cfg.name}_{k}": v for k, v in fwd.items()})
    del model, batch, fwd
    torch.cuda.empty_cache()
    return summary


def counted(mods, what, expected, run):
    """``run()`` with every launch count set to 0 just before and read just
    after; raises unless the counts are ``expected``. Returns its result."""
    import torch
    mods.lib.reset_launches()
    out = run()
    torch.cuda.synchronize()
    launches = dict(mods.lib.LAUNCHES)
    log(f"# {what} launches: {launches}")
    if launches != expected:
        raise RuntimeError(f"{what} launch counts {launches} != {expected}")
    return out


def times(counts, n):
    return {k: v * n for k, v in counts.items()}


def bench_phase(mods):
    """Phase 12: the port's bench on prob_gs6400, batch 1, with its
    ``--pipeline`` of PIPELINE frames in one CUDA graph: the replay's
    final_occ equals, bit for bit, the same frames run eagerly on the same
    images and pre-drawn draws. Counted: the warm-up and the 10 frames of
    the loop, the pipeline's side-stream warm-up and capture (a replay
    launches nothing that counts) and the eager frames compared with it.
    Returns its JSON record with its ms/frame and the pipeline's."""
    import torch
    from gaussianformer_tpu_torch import bench
    piped = {}

    def compare(p):
        # the first eager frame profiled: the device time of the bench's
        # own frame (its model, batch and forward), which phase 2 holds
        eager = []
        piped["frame_busy_ms"] = device_busy(
            lambda: eager.append(p["frame"](0)))
        eager += [p["frame"](i) for i in range(1, PIPELINE)]
        piped["equal"] = [torch_equal(a, b) for a, b in zip(p["outs"], eager)]
        piped["ms"] = p["ms"]
        piped["idle"] = idle_share(p["graph"].replay, p["ms"] * PIPELINE,
                                   f"pipeline({PIPELINE}) replay")[0]
    frames = 1 + bench.ITERS + 3 * PIPELINE
    record, ms = counted(mods, "bench --pipeline", times(EXPECTED_LAUNCHES,
                                                         frames),
                         lambda: bench.run("prob_gs6400", 1, "cuda",
                                           PIPELINE, on_pipeline=compare))
    if record["metric"] != "prob_gs6400_infer_fps_per_chip":
        raise RuntimeError(f"bench metric {record['metric']}")
    log(f"# pipeline({PIPELINE}): {piped['ms']:.3f} ms/frame from one CUDA "
        f"graph replay against the loop's {ms:.3f}; the replay's final_occ "
        f"bit-equal to the eager frames: {piped['equal']}")
    if not all(piped["equal"]):
        raise RuntimeError("the CUDA graph's frames differ from the eager "
                           "ones")
    torch.cuda.empty_cache()
    return dict(record, ms_per_frame=ms, pipeline_frames=PIPELINE,
                pipeline_ms_per_frame=piped["ms"],
                pipeline_idle_share=piped["idle"],
                frame_busy_ms=piped["frame_busy_ms"])


def device_busy(run) -> float:
    """The summed device time of the kernels ``run`` launches, under
    ``torch.profiler``; 0 where the profiler recorded none."""
    import torch
    from gaussianformer_tpu_torch.profile_forward import device_busy_ms
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        run()
        torch.cuda.synchronize()
    return device_busy_ms(prof.key_averages())


def check_bench(bench, fwd):
    """The bench times the flagship frame: the device busy time of its own
    frame (one eager frame of its model and batch, profiled) within 15% of
    phase 2's profiled frame's. Both are device time, which the shared
    host does not move (the bench's launch counts are held in phase 12).
    The loop's ms/frame against phase 2's frame_ms, which include the
    host's share of a frame, is printed beside it."""
    busy, ref = bench["frame_busy_ms"], fwd["frame_busy_ms"]
    if not (busy > 0 and ref > 0):
        raise RuntimeError(f"the profiler recorded no device time (bench "
                           f"{busy} ms, phase 2 {ref} ms)")
    bench["frame_busy_ratio"] = ratio = busy / ref
    ms, frame_ms = bench["ms_per_frame"], fwd["frame_ms"]
    bench["frame_ms_ratio"] = ms / frame_ms
    log(f"# bench: its frame's device busy {busy:.3f} ms against phase 2's "
        f"{ref:.3f} (ratio {ratio:.4f}, required within 15%); its loop "
        f"{ms:.3f} ms/frame against phase 2's {frame_ms:.3f} (ratio "
        f"{ms / frame_ms:.4f}, host time included: not held)")
    if not abs(ratio - 1.0) <= 0.15:
        raise RuntimeError(f"the bench's frame, {busy:.3f} ms of device "
                           f"time, is not phase 2's {ref:.3f} within 15%")


def entry_phase(mods, root):
    """Phase 13: the train and eval CLIs at full width on a nuScenes-shaped
    set of files written under ``root``. Returns the summary numbers and,
    for phase 15, what the run left (``_`` keys)."""
    import os
    import numpy as np
    import torch
    from gaussianformer_tpu_torch import eval as eval_cli
    from gaussianformer_tpu_torch import native
    from gaussianformer_tpu_torch.configs import get_config
    from gaussianformer_tpu_torch.data import DataLoader
    from gaussianformer_tpu_torch.data.synthetic import write_nuscenes_files
    from gaussianformer_tpu_torch.metrics import compute_iou
    from gaussianformer_tpu_torch.train import __main__ as train_cli
    from gaussianformer_tpu_torch.train.runner import Trainer, build_dataset
    from gaussianformer_tpu_torch.utils.checkpoint import latest_checkpoint

    if native.load() is None:
        raise RuntimeError("the native codec did not build or load")
    log(f"# native codec: {native.library_path().name}")
    cfg = get_config("prob_gs6400")
    t0 = time.perf_counter()
    paths = write_nuscenes_files(root, num_samples=2)
    write_s = time.perf_counter() - t0
    work = os.path.join(root, "work")
    files = ["--data-root", paths["data_root"], "--anno-root",
             paths["anno_root"], "--occ-path", paths["occ_path"],
             "--num-workers", "2", "--config", cfg.name,
             "--work-dir", work]

    t0 = time.perf_counter()
    trainer = counted(
        mods, "train CLI (2 steps, the epoch's eval of 2 frames)",
        {k: 2 * (EXPECTED_TRAIN_LAUNCHES[k] + EXPECTED_LAUNCHES[k])
         for k in NO_LAUNCH},
        lambda: train_cli.main(files + [
            "--max-epochs", "1", "--batch-size", "1",
            "--print-freq", "1", "--iter-resume"]))
    train_s = time.perf_counter() - t0
    del trainer
    torch.cuda.empty_cache()
    with open(os.path.join(work, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    for rec in steps:
        if not all(math.isfinite(rec[k]) for k in ("loss", "grad_norm")):
            raise RuntimeError(f"train CLI step {rec}")
    latest = latest_checkpoint(work)
    if latest is None or os.path.basename(latest) != "ckpt_000000002.pt":
        raise RuntimeError(f"latest checkpoint {latest}")
    ckpt_mib = os.path.getsize(latest) / 2**20
    log(f"# train CLI: {len(steps)} steps, data "
        f"{[round(r['data_time'], 3) for r in steps]} s, step "
        f"{[round(r['step_time'], 3) for r in steps]} s (host wall, "
        f"the metrics read in each), losses "
        f"{[round(r['loss'], 4) for r in steps]}; the whole CLI "
        f"{train_s:.1f} s (model build, two loaders' workers, the "
        f"epoch's eval); {os.path.basename(latest)} {ckpt_mib:.1f} MiB")

    loader = DataLoader(build_dataset(
        cfg, "train", data_root=paths["data_root"],
        anno_root=paths["anno_root"], occ_path=paths["occ_path"]), 1)
    resumed = Trainer(cfg, loader, None, work, device="cuda")
    resumed.init_state()
    if not (resumed.try_resume()
            and (resumed.epoch, resumed.global_iter) == (1, 2)):
        raise RuntimeError(f"resume: epoch {resumed.epoch}, iteration "
                           f"{resumed.global_iter}")
    log("# resumed in a new Trainer at epoch 1, iteration 2")
    del resumed, loader
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ev = counted(mods, "eval CLI (2 frames)",
                 times(EXPECTED_LAUNCHES, 2),
                 lambda: eval_cli.main(files + ["--ckpt", latest]))
    eval_s = time.perf_counter() - t0
    miou, occ_iou, _ = compute_iou(ev.last_counts)
    if not (math.isfinite(miou) and math.isfinite(occ_iou)):
        raise RuntimeError(f"eval mIoU {miou}, occupancy IoU {occ_iou}")
    same = bool(np.array_equal(ev.last_counts, direct_counts(ev.model, ev)))
    log(f"# eval CLI: mIoU {miou:.4f}%, occupancy IoU {occ_iou:.4f}% "
        f"(random weights, random labels), {eval_s:.1f} s; its counts "
        f"equal a direct forward's: {same}")
    if not same:
        raise RuntimeError(f"eval counts {ev.last_counts.tolist()} differ "
                           f"from a direct forward's")
    eval_counts = ev.last_counts.tolist()
    del ev
    torch.cuda.empty_cache()
    return dict(_files=files[:8], _latest=latest, _steps=steps,
                _eval_counts=eval_counts, entry_write_s=write_s, entry_train_cli_s=train_s,
                entry_eval_cli_s=eval_s, entry_ckpt_mib=ckpt_mib,
                entry_data_s=[r["data_time"] for r in steps],
                entry_step_s=[r["step_time"] for r in steps],
                entry_miou=miou, entry_occ_iou=occ_iou)


def direct_counts(model, ev):
    """The counts of ``model`` on the eval CLI's (``ev``, its Trainer)
    batches in order, with the generator seeded as eval seeds it: what the
    eval CLI's counts must equal."""
    import torch
    from gaussianformer_tpu_torch.data import DataLoader, ShardedSampler
    from gaussianformer_tpu_torch.metrics import MeanIoU
    metric = MeanIoU()
    gen = torch.Generator(device="cuda").manual_seed(ev.seed)
    direct = DataLoader(ev.val_loader.dataset, 1, sampler=ShardedSampler(
        len(ev.val_loader.dataset), shuffle=False))
    with torch.inference_mode():
        for batch in direct:
            b = {k: v.cuda() for k, v in batch.items()}
            out = model(b["imgs"], b["projection_mat"], b["image_wh"],
                        b["occ_xyz"], b["occ_label"], b["occ_cam_mask"],
                        generator=gen)
            metric.update(out["final_occ"], out["sampled_label"],
                          out["occ_mask"])
    return metric.counts


def repeat_phase(cfg, build_segmentor, synthetic_batch, mods):
    """Phase 5b: two plain full-width train runs of 2 steps, each from a
    new model of seed 0 on one batch with the step's generator seeded 0:
    how many gradient leaves are bit-equal after each step, and the
    losses' difference. Counted as 4 train steps. Returns the summary;
    ``repeatable`` when every leaf and loss is equal at both steps."""
    import torch
    from gaussianformer_tpu_torch.train.optim import build_optimizer
    from gaussianformer_tpu_torch.train.step import build_loss, train_step

    def run():
        model, batch = build(cfg, build_segmentor, synthetic_batch)
        opt, schedule = build_optimizer(model, cfg, 10000)
        loss_fn = build_loss(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        steps = []
        for _ in range(2):
            metrics = train_step(model, opt, schedule, loss_fn, batch, gen)
            steps.append(({k: v.item() for k, v in metrics.items()},
                          {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()
                           if p.grad is not None}))
        del model, opt, batch
        torch.cuda.empty_cache()
        return steps
    first, second = counted(
        mods, "two plain train runs of 2 steps",
        times(EXPECTED_TRAIN_LAUNCHES, 4), lambda: (run(), run()))
    equal, loss_diff, leaves = [], [], 0
    for step, ((ma, ga), (mb, gb)) in enumerate(zip(first, second), 1):
        if set(ga) != set(gb):
            raise RuntimeError("the two runs' gradient leaves differ")
        leaves = len(ga)
        same = [n for n in ga if torch.equal(ga[n], gb[n])]
        equal.append(len(same))
        loss_diff.append(abs(ma["loss"] - mb["loss"]))
        worst = max(((ga[n] - gb[n]).abs().max().item(), n)
                    for n in ga if n not in same) if len(same) < leaves \
            else None
        log(f"# two plain {cfg.name} train runs, step {step}: {len(same)} "
            f"of {leaves} gradient leaves bit-equal; losses {ma['loss']} "
            f"and {mb['loss']} (difference {loss_diff[-1]}), grad norms "
            f"{ma['grad_norm']} and {mb['grad_norm']}"
            + ("" if worst is None else
               f"; largest difference {worst[0]:.3e} in {worst[1]}"))
    repeatable = all(e == leaves for e in equal) and not any(loss_diff)
    del first, second
    torch.cuda.empty_cache()
    return dict(repeat_equal_leaves=equal, repeat_leaves=leaves,
                repeat_loss_diff=loss_diff, repeatable=repeatable)


def convert_phase(mods, root, entry):
    """Phase 16: the checkpoint converter on a reference-named state_dict
    of the full-width flagship (seed-7 weights, which the converter's
    seed-0 template does not hold, with the entries the reference saves
    and the port drops), ``--strict``; then the eval CLI on its output
    directory (``latest``) on phase 13's two frames, counted, against the
    same weights evaluated directly."""
    import os
    import numpy as np
    import torch
    from gaussianformer_tpu_torch import convert_checkpoint
    from gaussianformer_tpu_torch import eval as eval_cli
    from gaussianformer_tpu_torch.configs import get_config
    from gaussianformer_tpu_torch.models.segmentor import build_segmentor
    cfg = get_config("prob_gs6400")
    model = build_segmentor(cfg, device="cuda", seed=7)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    extra = {k[:-len("running_var")] + "num_batches_tracked": torch.tensor(1)
             for k in sd if k.endswith("running_var")}
    for i, op in enumerate(cfg.operation_order):
        if op == "spconv":
            extra[f"encoder.layers.{i}.pc_range"] = torch.tensor(
                cfg.pc_range)
            extra[f"encoder.layers.{i}.grid_size"] = torch.tensor(
                cfg.spconv_grid_size)
    ref_path = os.path.join(root, "reference.pth")
    torch.save({"state_dict": {**sd, **extra}}, ref_path)
    out = os.path.join(root, "converted")
    t0 = time.perf_counter()
    code = convert_checkpoint.main(["--config", cfg.name, "--torch-ckpt",
                                    ref_path, "--out", out, "--strict"])
    convert_s = time.perf_counter() - t0
    if code != 0:
        raise RuntimeError(f"the converter exited {code}")
    t0 = time.perf_counter()
    ev = counted(mods, "eval CLI on the converted checkpoint (2 frames)",
                 times(EXPECTED_LAUNCHES, 2),
                 lambda: eval_cli.main(entry["_files"] + [
                     "--config", cfg.name, "--work-dir", out]))
    eval_s = time.perf_counter() - t0
    held = ev.model.state_dict()
    weights = all(torch_equal(held[k].cpu(), v) for k, v in sd.items())
    same = bool(np.array_equal(ev.last_counts, direct_counts(model, ev)))
    log(f"# converter: {len(sd) + len(extra)} reference entries, "
        f"{len(extra)} dropped, {convert_s:.1f} s; the eval CLI on its "
        f"directory holds the reference's weights: {weights}, and its "
        f"counts equal the same weights evaluated directly: {same} "
        f"({eval_s:.1f} s)")
    if not (weights and same):
        raise RuntimeError("the converted checkpoint is not what the eval "
                           "CLI evaluated")
    del model, ev, held, sd
    torch.cuda.empty_cache()
    return dict(convert_s=convert_s, convert_eval_s=eval_s,
                convert_counts_equal=same)


def vis_phase(mods, root):
    """Phase 17: the visualize CLI at the flagship's full width on one
    synthetic frame, counted: its four PNGs, each non-empty and of more
    than one colour (drawn with matplotlib where it is installed, else with
    PIL, as ``utils/vis.py`` does)."""
    import importlib.util
    import os
    import numpy as np
    from PIL import Image
    from gaussianformer_tpu_torch import visualize
    work = os.path.join(root, "vis")
    t0 = time.perf_counter()
    written = counted(mods, "visualize CLI (1 frame)", EXPECTED_LAUNCHES,
                      lambda: visualize.main([
                          "--config", "prob_gs6400", "--work-dir", work,
                          "--synthetic", "--num-samples", "1"]))
    vis_s = time.perf_counter() - t0
    sizes, colours = [], []
    for path in written:
        px = np.asarray(Image.open(path).convert("RGB"))
        sizes.append(os.path.getsize(path))
        colours.append(len(np.unique(px.reshape(-1, 3), axis=0)))
    renderer = ("matplotlib" if importlib.util.find_spec("matplotlib")
                else "PIL (no matplotlib on this host)")
    log(f"# visualize CLI: {[os.path.basename(p) for p in written]}, "
        f"{sizes} bytes, {colours} colours, drawn with {renderer}, "
        f"{vis_s:.1f} s")
    if len(written) != 4 or min(sizes) == 0 or min(colours) < 2:
        raise RuntimeError(f"the visualize CLI wrote {written}")
    return dict(vis_s=vis_s, vis_bytes=sizes, vis_colours=colours)


# phase 14: the options no shipped config sets, as the JAX package reaches
# them (the dicts of segmentor_cfg(), here the segmentor's module_overrides)
V1_OPTIONS = {"lifter_cfg": {"pts_init": True},
              "encoder_cfg": {"refine_cfg": {"xyz_coordinate": "polar",
                                             "phi_activation": "loop"}},
              "head_cfg": {"dataset_type": "kitti"}}
PROB_OPTIONS = {"head_cfg": {"dataset_type": "kitti"}}
# the FFN's pre-norm, and the empty label of the KITTI column order
OPTION_FIELDS = dict(ffn_pre_norm=True, empty_label=0)


def anchor_points_for(cfg, seed):
    """The v1 lifter's ``pts_init`` anchor points of one sample, [P, 3] in
    [0, 1]^3: a seeded synthetic scan (a ring of returns from 2 to 60 m,
    fewer points than anchors, so the jittered padding runs) through the
    port's ``data.transforms._prepare_anchor_points``."""
    import numpy as np
    from gaussianformer_tpu_torch.data.transforms import \
        _prepare_anchor_points
    rng = np.random.RandomState(seed)
    n = cfg.num_anchor * 4 // 5
    r, a = rng.uniform(2.0, 60.0, n), rng.uniform(0.0, 2 * math.pi, n)
    scan = np.stack([r * np.cos(a), r * np.sin(a),
                     rng.uniform(-3.0, 2.0, n)], -1).astype(np.float32)
    return _prepare_anchor_points(scan, cfg.pc_range, cfg.num_anchor, rng,
                                  0.2)


def options_loss(cfg):
    """The loss stacks of phase 14. v1: the softmax focal loss in place of
    the CE, with sem/geo scal, Lovasz and dice. Prob: OccupancyLoss with
    every switch on (the sigmoid focal loss, scal, dice, ignore_empty, the
    frequency weights), plus BCE, density, depth and the pixel loss through
    its sigmoid."""
    import functools
    from gaussianformer_tpu_torch.configs import MANUAL_CLASS_WEIGHT
    from gaussianformer_tpu_torch.losses import bce
    from gaussianformer_tpu_torch.losses.multi_loss import LossTerm, MultiLoss
    from gaussianformer_tpu_torch.losses.occupancy import (OccupancyLossCfg,
                                                           occupancy_loss)
    occ_keys = ("pred_occ", "sampled_label", "occ_mask", "sampled_xyz")
    common = dict(empty_label=cfg.empty_label, lovasz_ignore=cfg.empty_label,
                  use_focal=True, use_sem_geo_scal=True, use_dice=True)
    if cfg.version == 1:
        occ = OccupancyLossCfg(lovasz_use_softmax=True,
                               manual_class_weight=MANUAL_CLASS_WEIGHT,
                               focal_use_sigmoid=False, **common)
        return MultiLoss([LossTerm("OccupancyLoss", 1.0, functools.partial(
            occupancy_loss, occ), occ_keys)])
    occ = OccupancyLossCfg(ignore_empty=True, **common)
    e = cfg.empty_label
    return MultiLoss([
        LossTerm("OccupancyLoss", 1.0,
                 functools.partial(occupancy_loss, occ), occ_keys),
        LossTerm("BinaryCrossEntropyLoss", 1.0, functools.partial(
            bce.binary_cross_entropy_loss, empty_label=e,
            class_weights=(0.4, 1.6)),
            ("bin_logits", "sampled_label", "occ_mask")),
        LossTerm("DensityLoss", 0.5, functools.partial(
            bce.density_loss, empty_label=e, thresh=0.1),
            ("density", "sampled_label", "occ_mask")),
        LossTerm("OccDepthLoss", 0.3, bce.occ_depth_loss,
                 ("pixel_logits", "pixel_gt")),
        LossTerm("PixelDistributionLoss", 1.0, functools.partial(
            bce.pixel_distribution_loss, use_sigmoid=True),
            ("pixel_logits", "pixel_gt"))])


def options_phase(get_config, build_segmentor, synthetic_batch, mods, rows):
    """Phase 14: two models with the options on at full width, each a
    counted frame and a counted train step with K4 and K7 against their
    plain versions on the model's own inputs; then both tiny variants, GPU
    against CPU. Appends the kernel rows to ``rows`` and returns the
    summary numbers."""
    import dataclasses
    import torch
    summary = {}
    variants = (("gs25600_solid", V1_OPTIONS, V1_LAUNCHES, V1_TRAIN_LAUNCHES),
                ("prob_gs6400", PROB_OPTIONS, EXPECTED_LAUNCHES,
                 EXPECTED_TRAIN_LAUNCHES))
    for base, overrides, fwd_counts, train_counts in variants:
        cfg = dataclasses.replace(get_config(base), name=f"{base}_options",
                                  **OPTION_FIELDS)
        t0 = time.perf_counter()
        model = build_segmentor(cfg, device="cuda", seed=0,
                                module_overrides=overrides)
        g = cfg.grid
        batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=0,
                                device="cuda")
        if cfg.version == 1:
            batch["anchor_points"] = torch.from_numpy(
                anchor_points_for(cfg, 0))[None].cuda()
        torch.cuda.synchronize()
        log(f"# {cfg.name} setup: {time.perf_counter() - t0:.1f} s; "
            f"overrides {overrides}, fields {OPTION_FIELDS}")
        v1 = cfg.version == 1
        p = cfg.num_anchor + 1 if v1 else cfg.total_anchors
        kind = "additive" if v1 else "prob"
        fwd = frame_phase(cfg, model, batch, mods, fwd_counts, 1)
        with torch.inference_mode():
            rows.append(check_kernel(("splat", kind, p), captured(
                fwd["calls"], ("splat", kind, p)), fwd["launches"], mods,
                tag=cfg.name, hold_ties=True))
        del fwd["calls"], fwd["launches"]
        loss_fn = options_loss(cfg)
        train = train_phase(cfg, model, batch, mods, train_counts, 1,
                            loss_fn=loss_fn)
        terms = {t.name for t in loss_fn.terms}
        if not terms <= set(train["train_loss"]):
            raise RuntimeError(f"{cfg.name}: loss terms {terms} missing in "
                               f"{train['train_loss']}")
        with torch.no_grad():
            rows.append(check_backward(("splat_bwd", kind, p), captured(
                train["calls"], ("splat_bwd", kind, p)), train["launches"],
                mods, tag=cfg.name))
        del train["calls"], train["launches"]
        log(f"# {cfg.name}: frame {fwd['frame_ms']:.3f} ms, peak "
            f"{fwd['frame_peak_gib']:.2f} GiB; train step "
            f"{train['step_ms']:.3f} ms, peak {train['train_peak_gib']:.2f} "
            f"GiB; last step {train['train_loss']}")
        summary.update({f"{cfg.name}_{k}": v for k, v in fwd.items()})
        summary.update({f"{cfg.name}_{k}": v for k, v in train.items()})
        del model, batch, fwd, train
        torch.cuda.empty_cache()
    for name, overrides in (("gs25600_solid_tiny", V1_OPTIONS),
                            ("prob_gs6400_tiny", PROB_OPTIONS)):
        check_small(name, get_config, build_segmentor, synthetic_batch,
                    overrides, **OPTION_FIELDS)
    return summary


def run_launched(args, timeout, what):
    """``python -m torch.distributed.run`` with ``args`` in a session of its
    own (the agent and its workers), killed whole if it outlives
    ``timeout`` seconds. Returns its output; raises on a nonzero exit."""
    import os
    import signal
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1"] + args
    log(f"# {what}: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{what} ran past {timeout} s")
    log(f"# {what}: exit {proc.returncode} after "
        f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed:\n{out[-6000:]}")
    return out


def ddp_phase(entry, root, repeatable):
    """Phase 15: the train and eval CLIs under ``torch.distributed.run`` in
    a world of one (NCCL, DDP) on phase 13's files, seed and flags; the
    steps' losses and the eval counts against phase 13's: step 1's, and
    step 2's too where two plain runs repeat their bits (phase 5b)."""
    import os
    from gaussianformer_tpu_torch.utils.checkpoint import latest_checkpoint
    work = os.path.join(root, "work_ddp")
    flags = entry["_files"] + ["--config", "prob_gs6400", "--work-dir", work]
    t0 = time.perf_counter()
    run_launched(["-m", "gaussianformer_tpu_torch.train"] + flags + [
        "--max-epochs", "1", "--batch-size", "1", "--print-freq", "1",
        "--iter-resume"], 900, "train CLI under torch.distributed.run")
    train_s = time.perf_counter() - t0
    with open(os.path.join(work, "train.log")) as f:
        train_log = f.read()
    if "DistributedDataParallel: rank 0 of 1, backend nccl" not in train_log:
        raise RuntimeError("the train CLI did not log DDP over NCCL:\n"
                           + train_log[-3000:])
    with open(os.path.join(work, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    plain = entry["_steps"]
    if len(plain) != 2 or [r["iter"] for r in steps] != [1, 2]:
        raise RuntimeError(f"DDP steps {steps} against {plain}")
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(steps, plain)]
           for k in ("loss", "grad_norm")}
    held = 2 if repeatable else 1
    log(f"# DDP (world of one, NCCL) step losses "
        f"{[r['loss'] for r in steps]} and grad norms "
        f"{[r['grad_norm'] for r in steps]} against phase 13's "
        f"{[r['loss'] for r in plain]} and "
        f"{[r['grad_norm'] for r in plain]}: relative {rel} (required at "
        f"the first {held} step(s): the loss <= 1e-5, the grad norm <= "
        f"1e-4; two plain runs repeat their bits: {repeatable})")
    if not (all(rel["loss"][i] <= 1e-5 and rel["grad_norm"][i] <= 1e-4
                for i in range(held))
            and all(math.isfinite(r[k]) for r in steps
                    for k in ("loss", "grad_norm"))):
        raise RuntimeError(f"DDP steps differ from the plain run: {rel}")
    latest = latest_checkpoint(work)
    if latest is None or os.path.basename(latest) != "ckpt_000000002.pt":
        raise RuntimeError(f"DDP run's latest checkpoint {latest}")
    moved = held_within_two_steps(latest, entry["_latest"])

    ev_work = os.path.join(root, "work_ddp_eval")
    t0 = time.perf_counter()
    run_launched(["-m", "gaussianformer_tpu_torch.eval"]
                 + entry["_files"] + ["--config", "prob_gs6400",
                                      "--work-dir", ev_work,
                                      "--ckpt", entry["_latest"]],
                 600, "eval CLI under torch.distributed.run")
    eval_s = time.perf_counter() - t0
    with open(os.path.join(ev_work, "train.log")) as f:
        found = re.findall(r"val counts .*?: (\[\[.*\]\])", f.read())
    if not found:
        raise RuntimeError("the eval CLI logged no counts")
    counts = json.loads(found[-1])
    same = counts == entry["_eval_counts"]
    log(f"# DDP eval CLI: counts equal phase 13's: {same}; train CLI "
        f"{train_s:.1f} s, eval CLI {eval_s:.1f} s (each with its process "
        f"start); one card on this host, so a world of two runs only on "
        f"the CPU (gloo, tests/test_torch_port_ddp.py)")
    if not same:
        raise RuntimeError(f"DDP eval counts {counts} != phase 13's "
                           f"{entry['_eval_counts']}")
    return dict(ddp_train_cli_s=train_s, ddp_eval_cli_s=eval_s,
                ddp_losses=[r["loss"] for r in steps],
                ddp_grad_norms=[r["grad_norm"] for r in steps],
                ddp_rel=rel, ddp_ckpt=os.path.basename(latest),
                ddp_params_worst_share_of_bound=moved)


def held_within_two_steps(path, plain_path):
    """The DDP run's parameters after its two steps against the plain
    run's: every element within twice the two AdamW steps' largest move
    from the same start, (lr_0 + lr_1)(1 + wd |p|) at the schedule's first
    two lrs (each group's; bias-corrected Adam moves at most 1.0013 lr at
    its second step, hence 2.02), plus fp32 rounding. Returns the largest
    share of that bound used."""
    import torch
    from gaussianformer_tpu_torch.configs import get_config
    from gaussianformer_tpu_torch.train.optim import (BACKBONE,
                                                      cosine_warmup_schedule)
    o = get_config("prob_gs6400").optim
    # the CLI's 2 steps of one epoch
    sched = cosine_warmup_schedule(o.lr, 2, o.warmup_iters, o.min_lr_ratio)
    got = torch.load(path, map_location="cpu", weights_only=True)["model"]
    ref = torch.load(plain_path, map_location="cpu",
                     weights_only=True)["model"]
    worst = 0.0
    for name, r in ref.items():
        if not r.is_floating_point():
            continue
        mult = o.backbone_lr_mult if name.startswith(BACKBONE) else 1.0
        bound = (2.02 * (sched(0) + sched(1)) * mult
                 * (1.0 + o.weight_decay * r.abs()) + 2.0 ** -22 * r.abs())
        share = ((got[name] - r).abs() / bound).max().item()
        worst = max(worst, share)
        if not share <= 1.0:
            raise RuntimeError(f"DDP parameter {name} moved {share:.3f} "
                               f"times two steps' bound from the plain run's")
    log(f"# DDP checkpoint against phase 13's: every element within two "
        f"AdamW steps' move (largest share of the bound {worst:.4f})")
    return worst


def points_phase(get_config, build_segmentor, synthetic_batch, mods, rows,
                 keep, seed):
    """Phase 18: the splat's general mode (K4 and K7 at any query points).
    The flagship frame and the ``gs25600_solid`` train step with
    ``occ_xyz`` the grid twice as fine (5,120,000 points, 8 a voxel, not
    the splat grid): counted, timed, outputs and losses finite; K4 prob on
    all the points and K4 / K7 additive on every ADDITIVE_STRIDE-th against
    their plain versions (the points bins against theirs in every
    element); K4 in a CUDA graph and twice, the same bits. Then, on the
    flagship's phase 3 and 6 inputs (``keep``): K7 prob at the grid's
    points permuted, against its plain version and the raster K7; K4 at
    the permuted points with OUTSIDE_SHARE of them past ``pc_range``
    against its plain version, and without them, put back in order,
    against the raster K4; and per-axis boxes on Prob-256's phase 11
    inputs. Then, at the LiDAR-like points of ``lidar_points(seed)``, K4
    prob and additive and K7 additive (:func:`lidar_case`). Appends the
    kernel rows to ``rows`` (those of no path printed, not reported) and
    returns the summary numbers."""
    import dataclasses
    import torch
    from gaussianformer_tpu_torch.data.synthetic import finer_points
    splat = mods.splat
    summary = {}

    # ---- the flagship frame at the finer points
    cfg = get_config("prob_gs6400")
    p = cfg.total_anchors
    model, batch = build(cfg, build_segmentor, synthetic_batch)
    fine = finer_points(batch, FINER)
    del batch
    cfg = dataclasses.replace(cfg, name="prob_gs6400_finer")
    log(f"# {cfg.name}: occ_xyz {list(fine['occ_xyz'].shape)}, the grid "
        f"{FINER}x finer on each axis over the same range")
    fwd = frame_phase(cfg, model, fine, mods, POINTS_LAUNCHES, FRAMES)
    key = ("splat", "prob", p)
    fn, args, kw = call = captured(fwd["calls"], key)
    with torch.inference_mode():
        rows.append(check_kernel(key, call, fwd["launches"], mods,
                                 tag="prob_gs6400_finer", hold_ties=True))
        lab = {k: v for k, v in kw.items() if k != "bins"}
        held_repeat("splat_points_prob_labels_prob_gs6400_finer",
                    fn(*args, **kw), fn(*args, **kw))
        summary["points_graph_bit_equal"] = held_graph(
            fn, args, lab, kw["bins"].capacity, splat)
    del fwd["calls"], fwd["launches"], call, args, kw
    summary.update({f"{cfg.name}_{k}": v for k, v in fwd.items()})
    del model, fine, fwd
    torch.cuda.empty_cache()

    # ---- K7 prob at the grid's points permuted (phase 6's cotangents)
    fn, args, kw = keep["k7"]
    n = args[0].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(18)
    perm = torch.randperm(n, generator=gen, device="cuda")
    inv = torch.argsort(perm)

    def permuted(a, rows_at=(0, 5, 6)):
        return tuple(t[perm].contiguous() if i in rows_at else t
                     for i, t in enumerate(a))
    pargs = permuted(args)
    pbins = splat.bin_splat_cuda(pargs[0], args[4], args[7],
                                 kw["bins"].capacity, grid_ordered=False)
    with torch.no_grad():
        row7 = check_backward(("splat_bwd", "prob", p),
                              (fn, pargs, {"bins": pbins}),
                              {"splat_points_bwd": 0}, mods,
                              tag="prob_gs6400_permuted")
        held_close("splat_points_prob_backward against the raster K7 "
                   "(unpermuted)", fn(*pargs, bins=pbins), fn(*args, **kw))
    row7["report"] = False
    rows.append(row7)

    # ---- K4 at the grid's points permuted, 1% outside; and put back
    fn, args, kw = keep["k4"]
    lab = {k: v for k, v in kw.items() if k != "bins"}
    points = args[0]
    grid = args[4]
    moved = points[perm].clone()
    k = int(n * OUTSIDE_SHARE)
    lo = torch.tensor(grid.pc_min, device="cuda")
    span = torch.tensor([grid.H, grid.W, grid.D], device="cuda") \
        * grid.grid_size
    side = torch.where(torch.rand(k, generator=gen, device="cuda") < 0.5,
                       -1.0, 1.0)
    moved[:k, 0] += side * (span[0] + 1.0)
    moved[:k] += (torch.rand(k, 3, generator=gen, device="cuda") - 0.5) \
        * span
    outside = ((moved < lo) | (moved >= lo + span)).any(-1)
    with torch.inference_mode():
        margs = (moved.contiguous(),) + args[1:]
        got = fn(*margs, **lab)
        ref, plain_ms = timed(lambda: splat.splat_accumulate_plain(*margs,
                                                                   **lab))
        held_prob(f"splat_points_prob (grid permuted, "
                  f"{int(outside.sum().item())} points outside pc_range)",
                  got, ref, splat)
        back = [t[inv] for t in fn(points[perm].contiguous(), *args[1:],
                                   **lab)]
        held_prob("splat_points_prob (grid permuted) put back, against the "
                  "raster K4", back, fn(*args, **kw), splat)
        summary["points_outside_plain_ms"] = plain_ms
    del got, ref, back, moved, margs

    # ---- per-axis boxes (Prob-256's phase 11 inputs), grid permuted
    (fn4, args4, kw4), (fn7, args7, _) = keep["per_axis"]
    n = args4[0].shape[0]
    perm = torch.randperm(n, generator=gen, device="cuda")
    with torch.inference_mode():
        margs = (args4[0][perm].contiguous(),) + args4[1:]
        lab = {k: v for k, v in kw4.items() if k != "bins"}
        held_prob("splat_points_prob per-axis (Prob-256, grid permuted)",
                  fn4(*margs, **lab),
                  splat.splat_accumulate_plain(*margs, **lab), splat)
    with torch.no_grad():
        pargs = permuted(args7)
        held_close("splat_points_prob_backward per-axis (Prob-256, grid "
                   "permuted) against its plain version", fn7(*pargs),
                   splat.splat_backward_plain(*pargs))
    del margs, pargs

    # ---- the additive train step at the finer points
    cfg = get_config("gs25600_solid")
    p = cfg.num_anchor + int(cfg.with_empty)
    model, batch = build(cfg, build_segmentor, synthetic_batch)
    fine = finer_points(batch, FINER)
    del batch
    cfg = dataclasses.replace(cfg, name="gs25600_solid_finer")
    fwd = frame_phase(cfg, model, fine, mods, POINTS_V1_LAUNCHES, FRAMES)
    train = train_phase(cfg, model, fine, mods, POINTS_V1_TRAIN_LAUNCHES,
                        STEPS)
    tag = f"gs25600_solid_finer_every{ADDITIVE_STRIDE}"
    fn4, args4, kw4 = captured(fwd["calls"], ("splat", "additive", p))
    fn7, args7, kw7 = captured(train["calls"], ("splat_bwd", "additive", p))
    cap = kw4["bins"].capacity
    sub = args4[0][::ADDITIVE_STRIDE].contiguous()
    with torch.inference_mode():
        sub_bins = splat.bin_splat_cuda(sub, args4[2], args4[4], cap,
                                        grid_ordered=False)
        row = check_kernel(("splat", "additive", p),
                           (fn4, (sub,) + args4[1:], {"bins": sub_bins}),
                           fwd["launches"], mods, tag=tag)
        row["path"] = path_time(fn4, args4, kw4, splat)
        rows.append(row)
    with torch.no_grad():
        sub_gl = args7[5][::ADDITIVE_STRIDE].contiguous()
        sub_bins = splat.bin_splat_cuda(sub, args7[4], args7[7], cap,
                                        grid_ordered=False)
        row7 = check_backward(
            ("splat_bwd", "additive", p),
            (fn7, (sub,) + args7[1:5] + (sub_gl,) + args7[6:],
             {"bins": sub_bins}), train["launches"], mods, tag=tag)
        row7["path"] = path_time(fn7, args7, kw7, splat)
        rows.append(row7)
    for part in (fwd, train):
        del part["calls"], part["launches"]
    summary.update({f"{cfg.name}_{k}": v for k, v in fwd.items()})
    summary.update({f"{cfg.name}_{k}": v for k, v in train.items()})
    del model, fine, fwd, train, sub, sub_gl, sub_bins
    torch.cuda.empty_cache()

    # ---- the LiDAR-like query set: the flagship's and the v1 step's tables
    from gaussianformer_tpu_torch.data.synthetic import lidar_points
    t0 = time.perf_counter()
    pts = torch.from_numpy(lidar_points(seed)).cuda()
    n = pts.shape[0]
    grid = keep["k4"][1][4]
    lo = torch.tensor(grid.pc_min, device="cuda")
    span = torch.tensor([grid.H, grid.W, grid.D], device="cuda") \
        * grid.grid_size
    outside = int(((pts < lo) | (pts >= lo + span)).any(-1).sum().item())
    log(f"# LiDAR-like set (seed {seed}): {n} points, {outside} past "
        f"pc_range")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fn, args, kw = keep["k4"]
    lidar = {}
    lidar["k4_prob"] = lidar_case(
        "splat_points_prob (LiDAR-like)", fn, (pts,) + args[1:],
        {k: v for k, v in kw.items() if k != "bins"},
        kw["bins"].capacity, splat)
    lidar["k4_additive"] = lidar_case(
        "splat_points_additive (LiDAR-like)", fn4, (pts,) + args4[1:], {},
        cap, splat)
    c = args7[3].shape[1]
    gl = torch.randn(n, c, generator=gen, device="cuda")
    lidar["k7_additive"] = lidar_case(
        "splat_points_additive_backward (LiDAR-like)", fn7,
        (pts,) + args7[1:5] + (gl, None) + args7[7:], {}, cap, splat)
    lidar["points"], lidar["outside"] = n, outside
    lidar["seconds"] = time.perf_counter() - t0
    log(f"# LiDAR-like set: {lidar['seconds']:.1f} s")
    summary["lidar"] = lidar
    del pts, gl, fn4, args4, kw4, fn7, args7, kw7
    torch.cuda.empty_cache()
    return summary


def lidar_case(name, fn, args, lab, cap, splat) -> dict:
    """One general-mode kernel at the LiDAR-like points (K4 when ``args``
    are K4's six, else K7's nine) on bins sized by the path's bound: held
    against its plain version (K4 prob as :func:`held_prob`, additive as
    :func:`held_additive`; K7 within SUM_TOL of each output's largest
    |ref|, the whole-grid Gaussian's row on its own), a second call's bits
    against the first's; its time, its bound and the longest block's share
    of its launch (K7: of its piece launch). Returns the numbers."""
    import torch
    k4 = len(args) == 6
    box, grid = (args[2], args[4]) if k4 else (args[4], args[7])
    bins = splat.bin_splat_cuda(args[0], box, grid, cap, grid_ordered=False)
    times = {}
    ctx = torch.inference_mode() if k4 else torch.no_grad()
    with ctx:
        got = fn(*args, **lab, bins=bins, block_times=times)
        # (the additive K4 has no one_minus)
        held_repeat(name, [t for t in got if t is not None],
                    [t for t in fn(*args, **lab, bins=bins) if t is not None])
        ms = cuda_ms(lambda: fn(*args, **lab, bins=bins), 5)
        if k4:
            ref, plain_ms = timed(lambda: splat.splat_accumulate_plain(
                *args, **lab))
            if args[5] == "prob":
                held_prob(name, got, ref, splat)
            else:
                held_additive(name, got, ref, args[3].shape[1] - 2)
        else:
            ref, plain_ms = timed(lambda: splat.splat_backward_plain(*args))
            held_close(name + " (all but the whole-grid Gaussian)",
                       [t[:-1] for t in got], [t[:-1] for t in ref])
            held_close(name + " (the whole-grid Gaussian)",
                       [t[-1:] for t in got], [t[-1:] for t in ref])
    pairs = splat_pairs(args[0], box, grid)
    flops, nbytes = (k4_work(*args[:4], pairs, args[5] == "prob") if k4
                     else k7_work(*args[:7], pairs))
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    share = splat.block_share(times["k4" if k4 else "k7"])
    out = dict(ms=ms, plain_ms=plain_ms, aabb_pairs=pairs,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               longest_block_share=share)
    log(f"# {name}: {ms:.4f} ms, plain {plain_ms:.1f} ms, {pairs} AABB "
        f"pairs, bound {out['bound_ms']:.4f} ms ({out['bound_by']}); the "
        f"longest block {share:.4f} of the launch")
    return out


def k4_work(points, gdata, box, sem_aug, pairs, prob: bool):
    """(flops, bytes) of a K4 call: per (point, Gaussian) pair in the AABB,
    displacement and quadratic form (~20), exp (~4) and the C (additive)
    or C + 2 multiply-adds and the 1 - e product (prob); each input read
    once, each output (acc, labels) written once."""
    n = points.shape[0]
    c = sem_aug.shape[1] - (0 if prob else 2)
    flops = pairs * (24 + 2 * c + (2 if prob else 0))
    nbytes = (n * 12 + gdata.numel() * 4 + box.numel() * 4
              + sem_aug.numel() * 4 + n * (c + (2 if prob else 3)) * 4)
    return flops, nbytes


def k7_work(points, gdata, opa, sem, box, gl, scalars, pairs):
    """(flops, bytes) of a K7 call: per (point, Gaussian) pair in the
    AABB, displacement and quadratic form (~18), exp (~4), the C-wide dot
    and gsem multiply-adds (4C), gpower with its division (~10), the nine
    moments (~24), gw and the weight (~4); the additive variant (no
    scalars) has no division and no per-point scalars (~50)."""
    n, c = gl.shape
    p = gdata.shape[0]
    additive = scalars is None
    flops = pairs * ((50 if additive else 60) + 4 * c)
    nbytes = (n * 12 + gl.numel() * 4
              + (0 if additive else scalars.numel() * 4)
              + gdata.numel() * 4 + opa.numel() * 4 + sem.numel() * 4
              + box.numel() * 4 + p * (3 + 1 + c + 6) * 4)
    return flops, nbytes


def path_time(fn, args, kw, splat) -> dict:
    """A K4 or K7 call on the path's own inputs and bins (all the finer
    points, where its row holds the plain version on a subset): its time,
    the AABB pairs it computes and its bound."""
    k4 = len(args) == 6
    grid, box = (args[4], args[2]) if k4 else (args[7], args[4])
    ms = cuda_ms(lambda: fn(*args, **kw), 3)
    pairs = splat_pairs(args[0], box, grid)
    flops, nbytes = (k4_work(*args[:4], pairs, args[5] == "prob") if k4
                     else k7_work(*args[:7], pairs))
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    log(f"# on all {args[0].shape[0]} points (the path's call): "
        f"{ms:.4f} ms, {pairs} AABB pairs, bound {max(t_ops, t_bytes):.4f} "
        f"ms ({'operations' if t_ops >= t_bytes else 'bytes'})")
    return dict(ms=ms, points=args[0].shape[0], aabb_pairs=pairs,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def held_prob(name, got, ref, splat):
    """A prob K4's outputs against a reference's: the sums within 1e-4 of
    the largest |ref| (phase 3's tolerance), one_minus within 1e-4, the
    labels equal but for counted near-ties."""
    err = (got[0] - ref[0]).abs().max().item()
    tol = 1e-4 * max(ref[0].abs().max().item(), 1.0)
    err_om = (got[1] - ref[1]).abs().max().item()
    log(f"# {name}: sums max_abs_err {err:.3e} (tol {tol:.3e}), one_minus "
        f"{err_om:.3e} (tol 1e-4)")
    if not (err <= tol and err_om <= 1e-4):
        raise RuntimeError(f"{name} disagrees: {err} > {tol} or one_minus "
                           f"{err_om}")
    held_combine_labels(name, got, ref, splat)


def held_close(name, got, ref):
    """K7's four outputs against a reference's, each within SUM_TOL of its
    largest |ref| (phase 6's tolerance)."""
    errors = {k: _max_err(k, gt, rf, SUM_TOL) for k, gt, rf in zip(
        ("g_means", "g_opacities", "g_semantics", "g_cov_inv6"), got, ref)}
    log(f"# {name}: " + ", ".join(f"{k} {e:.3e} (tol {t:.3e})"
                                  for k, (e, t) in errors.items()))
    bad = {k: e for k, (e, t) in errors.items() if not e <= t}
    if bad:
        raise RuntimeError(f"{name} disagrees: {bad}")


def held_graph(fn, args, lab, cap, splat) -> bool:
    """One points binning plus K4 (with the Gaussians' binning), captured
    in a CUDA graph and replayed, against the same eager call: the same
    bits. Raises if not."""
    import torch
    points, box, grid = args[0], args[2], args[4]

    def call():
        bins = splat.bin_splat_cuda(points, box, grid, cap,
                                    grid_ordered=False)
        return fn(*args, **lab, bins=bins)
    eager = call()
    splat.DEFERRED_FLAGS.clear()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    splat.check_deferred_flags()
    splat.DEFERRED_FLAGS.clear()
    same = all(a is None and b is None or torch_equal(a, b)
               for a, b in zip(out, eager))
    log(f"# splat general mode in a CUDA graph (points binning + K4 on "
        f"{points.shape[0]} points): the replay bit-equal to the eager "
        f"call {same}")
    if not same:
        raise RuntimeError("the general mode's CUDA graph differs from the "
                           "eager call")
    del graph, out, eager
    return same


def check_per_axis(fwd_calls, train_calls, p, mods, rows):
    """Phase 11: K4 (the frame's) and K7 (the train step's) on Prob-256's
    head inputs packed again with per-axis boxes, against their plain
    versions with the prob rows' tolerances; printed, not reported (no
    shipped config takes this path). Returns the two calls."""
    pack = mods.ops_splat.pack_gaussians

    def per_axis_tables(calls):
        _, args, _ = captured(calls, ("pack", p))
        return pack(*args[:6], per_axis=True)

    gdata, box, sem_aug = per_axis_tables(fwd_calls)
    fn, args, kw = captured(fwd_calls, ("splat", "prob", p))
    # the path's bins are of the isotropic boxes: none are passed
    kw = {k: v for k, v in kw.items() if k != "bins"}
    call4 = call = (fn, (args[0], gdata, box, sem_aug) + args[4:], kw)
    row = check_kernel(("splat", "prob", p), call,
                       {"splat": 0, "splat_bin": 0}, mods,
                       tag="prob_gs25600_per_axis")
    iso = splat_pairs(args[0], args[2], args[4])
    log(f"# per-axis boxes: {row['aabb_pairs']} AABB pairs against "
        f"{iso} isotropic")
    _, box7, _ = per_axis_tables(train_calls)
    fn, args, kw = captured(train_calls, ("splat_bwd", "prob", p))
    call = (fn, args[:4] + (box7,) + args[5:], {})
    row7 = check_backward(("splat_bwd", "prob", p), call, {"splat_bwd": 0},
                          mods, tag="prob_gs25600_per_axis")
    for r in [row, row7] + row.get("extra_rows", []):
        r["report"] = False
    rows += [row, row7]
    return call4, call


def check_kernel(key, call, launches, mods, tag="", hold_ties=False):
    """Kernel vs plain on one captured call; returns its kernels-line row
    (``report`` False for the stage-4 DCN shape, printed but folded into
    the one K1 row, which is measured at the stage-3 shape). ``tag``: the
    config whose shapes these are, where not the flagship's.
    ``hold_ties``: K4's combine-mode labels must also equal the plain ones
    but for counted near-ties."""
    import torch
    dcn, fps, deformable, splat = (mods.dcn, mods.fps, mods.deformable,
                                   mods.splat)
    fn, args, kw = call
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
        # cuDNN's dense bf16 3x3 conv of the same shape, channels-last: the
        # GEMM's time without the sampling (a yardstick, not the function)
        xc = x.permute(0, 3, 1, 2)
        wc = weight.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        conv_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
            xc, wc, padding=1), 20)
        flops = 2.0 * b * h * w * 9 * cin * cout
        nbytes = (x.numel() * 2 + b * h * w * 27 * 4 + weight.numel() * 2
                  + 2 * cout * 4 + b * h * w * cout * 2)
        row = dict(name="deform_conv2d" + suffix, route="cuda",
                   source="gaussianformer_tpu_torch/csrc/dcn.cu",
                   replaces="gaussianformer_tpu/ops/pallas/dcn_kernel.py:206",
                   launches=launches["dcn"], shape=[b, h, w, cin, cout],
                   conv_ms=conv_ms, report=cin == 256)
    elif name == "fps":
        points, num_samples = args[0], args[1]
        got = fn(*args)
        ref, plain_ms = timed(
            lambda: fps.farthest_point_sampling_plain(*args))
        err = float((got != ref).sum().item())   # indices must be equal
        tol = 0.0
        ms = cuda_ms(lambda: fn(*args), 5)
        # the latency floor: the kernel's per-step exchange alone, run as
        # many times over no points
        floor_ms = cuda_ms(lambda: fps.fps_step_floor_cuda(
            num_samples, points.device), 5)
        n = points.shape[0]
        flops = float(num_samples) * n * 9        # 3 sub, 3 mul, 2 add, min
        nbytes = n * 12 + num_samples * 4
        row = dict(name="farthest_point_sampling" + suffix, route="cuda",
                   source="gaussianformer_tpu_torch/csrc/fps.cu",
                   replaces="gaussianformer_tpu/ops/pallas/fps_kernel.py:56",
                   launches=launches["fps"], shape=[n, num_samples],
                   us_per_step=ms * 1e3 / num_samples, floor_ms=floor_ms,
                   floor_us_per_step=floor_ms * 1e3 / num_samples,
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
    elif name == "spconv":
        row, err, tol, ms, plain_ms, flops, nbytes = check_spconv(
            fn, args, launches, mods, suffix)
    elif name == "bn_epilogue":
        row, err, tol, ms, plain_ms, flops, nbytes = check_bn_epilogue(
            fn, args, key[1], launches, mods, suffix)
    elif key[1] == "additive":
        points, gdata, box, sem_aug, grid, variant = args
        cap = path_capacity(kw)
        general = splat_mode(points, box, grid, cap, mods)
        pre = "splat_points_" if general else "splat_"
        got = fn(*args)
        held_given_bins(f"{pre}additive{suffix}", got, fn(*args, **kw))
        ref, plain_ms = timed(lambda: splat.splat_accumulate_plain(*args))
        log_bit_equal(f"{pre}additive{suffix}", got, ref)
        c = sem_aug.shape[1] - 2
        err, tol = held_additive(f"{pre}additive{suffix}", got, ref, c)
        if splat_pairs(points, box[-1:], grid) > BIG_BOX:
            # the last Gaussian is the head's empty one: its whole-grid row
            # can decide every label, so the sums and the label epilogue
            # are held once more with its semantics zeroed, on the labels
            # the other Gaussians give
            sem0 = sem_aug.clone()
            sem0[-1, :c] = 0.0
            args0 = (points, gdata, box, sem0, grid, variant)
            held_additive(f"{pre}additive{suffix} (last Gaussian's "
                          f"semantics zeroed)", fn(*args0),
                          splat.splat_accumulate_plain(*args0), c)
            del sem0, args0
        # the kernel's time includes its binning, sized as the path's
        # bins are (the call builds its own)
        ms = cuda_ms(lambda: fn(*args, bins=splat.bin_splat_cuda(
            points, box, grid, cap)), 10)
        pairs = splat_pairs(points, box, grid)
        # per (point, Gaussian) pair in the AABB: displacement and
        # quadratic form (~20), exp (~4), C multiply-adds
        flops, nbytes = k4_work(points, gdata, box, sem_aug, pairs, False)
        n = points.shape[0]
        log(f"# {pre}additive{suffix}: {pairs} AABB pairs, "
            f"{gdata.shape[0]} Gaussians")
        row = dict(name=f"{pre}additive{suffix}", route="cuda",
                   source="gaussianformer_tpu_torch/csrc/"
                          + ("splat_points.cu" if general else "splat.cu"),
                   replaces="gaussianformer_tpu/ops/pallas/"
                            "splat_kernel.py:249",
                   launches=launches[f"{pre}additive"],
                   shape=[n, gdata.shape[0]], aabb_pairs=pairs, report=True,
                   extra_rows=[
                       check_points_bins(points, grid, suffix, launches,
                                         mods, True) if general else
                       check_bins(points, box, grid, suffix, launches, mods,
                                  True, cap)])
    else:
        points, gdata, box, sem_aug, grid, variant = args
        # the path hands K4 its bins; timed and checked here building its own
        kw, path_kw = ({k: v for k, v in kw.items() if k != "bins"}, kw)
        cap = path_capacity(path_kw)
        general = splat_mode(points, box, grid, cap, mods)
        pre = "splat_points_" if general else "splat_"
        got = fn(*args, **kw)
        held_given_bins(f"{pre}prob{suffix}", got, fn(*args, **path_kw))
        ref, plain_ms = timed(
            lambda: splat.splat_accumulate_plain(*args, **kw))
        log_bit_equal(f"{pre}prob{suffix}", got, ref)
        err = (got[0] - ref[0]).abs().max().item()
        # fp32 sums over up to thousands of Gaussians in another order
        tol = 1e-4 * max(ref[0].abs().max().item(), 1.0)
        err_om = (got[1] - ref[1]).abs().max().item()
        log(f"# splat one_minus max_abs_err {err_om:.3e} (tol 1e-4)")
        if not err_om <= 1e-4:
            raise RuntimeError(f"splat one_minus disagrees: {err_om}")
        mode = kw.get("label_mode", "combine")
        if mode == "threshold":
            held_threshold_labels(f"splat_prob_threshold{suffix}", got, ref,
                                  kw["thresh"], kw["empty_label"], splat)
        else:
            agree = (got[2] == ref[2]).float().mean().item()
            log(f"# splat labels agree on {agree:.6f} of voxels "
                f"(required >= 0.999: near-ties may flip)")
            if agree < 0.999:
                raise RuntimeError(f"splat labels agree on only {agree}")
            if hold_ties:
                held_combine_labels(f"{pre}prob_labels{suffix}", got, ref,
                                    splat)
        ms = cuda_ms(lambda: fn(*args, **kw, bins=splat.bin_splat_cuda(
            points, box, grid, cap)), 10)
        pairs = splat_pairs(points, box, grid)
        flops, nbytes = k4_work(points, gdata, box, sem_aug, pairs, True)
        n = points.shape[0]
        row = dict(name=pre + ("prob_labels" if mode == "combine"
                               else "prob_threshold") + suffix, route="cuda",
                   source="gaussianformer_tpu_torch/csrc/"
                          + ("splat_points.cu" if general else "splat.cu"),
                   replaces="gaussianformer_tpu/ops/pallas/"
                            "splat_kernel.py:249",
                   launches=launches["splat_points" if general else "splat"],
                   shape=[n, gdata.shape[0]], aabb_pairs=pairs, report=True,
                   extra_rows=[
                       check_points_bins(points, grid, suffix, launches,
                                         mods, mode == "combine")
                       if general else
                       check_bins(points, box, grid, suffix, launches, mods,
                                  mode == "combine", cap)])
        log(f"# {row['name']}: {pairs} AABB pairs, {gdata.shape[0]} "
            f"Gaussians")
    peak = PEAK_BF16 if name in ("dcn", "spconv") else PEAK_FP32
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    row.update(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=None)
    extra = ""
    if name == "dcn":
        extra = f", cuDNN dense conv {row['conv_ms']:.4f} ms"
    elif name == "spconv":
        extra = (f"; dense-tap bound {row['dense_bound_ms']:.4f} ms; table "
                 f"{row['table_ms']:.4f} ms (equal to plain); {row['pairs']} "
                 f"pairs "
                 f"({row['pair_share']:.4f} of the dense taps), "
                 f"{row['taps_skipped']} of {row['tiles'] * row['taps']} "
                 f"(tile, tap) pairs skipped; fp32 gather form "
                 f"{row['fp32_err']:.3e} (tol {row['fp32_tol']:.3e})")
    elif name == "bn_epilogue":
        extra = (f"; {row['bound_share']:.3f} of the bytes bound; bit-equal "
                 f"to plain on {row['bit_equal_share']:.6f} of elements")
    elif name == "fps":
        extra = (f"; {row['us_per_step']:.4f} us a selection, latency floor "
                 f"{row['floor_ms']:.4f} ms ({row['floor_us_per_step']:.4f} "
                 f"us a step)")
    log(f"# {row['name']} {row['shape']}: max_abs_err {err:.3e} "
        f"(tol {tol:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}){extra}")
    if not err <= tol:
        raise RuntimeError(f"{row['name']} disagrees with its plain "
                           f"version: {err} > {tol}")
    return row


def check_bn_epilogue(fn, args, form, launches, mods, suffix):
    """The frozen-BN epilogue on one captured call (the largest of its
    form): against its plain version (the same fp32 arithmetic, one rounding
    to bf16: at most a rounding flip, BF16_TOL of max|ref|), with the share
    of elements bit-equal to it, and a second call's bits. Its bytes: the
    conv's output (and the residual) read once, the output written once;
    3-6 fp32 operations an element. Returns check_kernel's (row, err, tol,
    ms, plain_ms, flops, nbytes)."""
    got = fn(*args)
    held_repeat(f"bn_epilogue_{form}{suffix}", [got], [fn(*args)])
    ref, plain_ms = timed(lambda: mods.bn_epilogue.bn_epilogue_plain(*args))
    err = (got.float() - ref.float()).abs().max().item()
    tol = BF16_TOL * ref.float().abs().max().item()
    bit_equal = (got == ref).float().mean().item()
    del ref
    ms = cuda_ms(lambda: fn(*args), 20)
    a = args[0]
    n = a.numel()
    tensors = 1 if form == "relu" else 2
    nbytes = (tensors + 1) * n * 2
    flops = n * {"relu": 3, "identity": 4, "downsample": 6}[form]
    row = dict(name=f"bn_epilogue_{form}{suffix}", route="cuda",
               source="gaussianformer_tpu_torch/csrc/bn_epilogue.cu",
               replaces="none (the JAX package leaves the BN, residual and "
                        "ReLU to XLA's fusion into the convs)",
               launches=launches["bn_epilogue"], shape=list(a.shape),
               bit_equal_share=bit_equal, repeat_bit_equal=True,
               bound_share=nbytes / PEAK_BYTES * 1e3 / ms, report=True)
    return row, err, tol, ms, plain_ms, flops, nbytes


def check_spconv(fn, args, launches, mods, suffix):
    """The fused submanifold conv on one captured call: the voxel table the
    path built (``gf_spconv_table``) and one built again by the kernel, each
    equal to ``spconv.voxel_table_plain`` of the call's coordinates; the
    conv against the bf16 gather form on the plain table
    (``spconv.submanifold_conv3d_table_plain``, which rounds each 25-tap
    chunk's product to bf16, five roundings of 2^-8 of a chunk: 2^-5
    max|ref|) and the gather form in fp32 on the same bf16 inputs (the
    kernel's own arithmetic in another order: 1e-3 max|ref|); a second
    call's bits, its voxel table's time and its counters. The operations
    counted are the non-empty (anchor, tap) pairs' (``spconv_pairs``); the
    row also gives the bound with every tap dense. Returns check_kernel's
    (row, err, tol, ms, plain_ms, flops, nbytes)."""
    import torch
    from gaussianformer_tpu_torch.utils import profiling
    sp = mods.spconv
    x, coords, table, grid_shape, weight, bias = args
    p, cin = x.shape
    cout, k = weight.shape[0], weight.shape[1]
    taps = k ** 3
    plain_table = sp.voxel_table_plain(coords, grid_shape)
    for which, t in (("the path's", table),
                     ("a new", sp.voxel_table_cuda(coords, grid_shape))):
        if not torch.equal(t, plain_table):
            raise RuntimeError(
                f"submanifold_conv3d{suffix}: {which} voxel table differs "
                f"from voxel_table_plain in "
                f"{(t != plain_table).sum().item()} voxels")
    plain_args = (x, coords, plain_table, grid_shape, weight, bias)
    got = fn(*args)
    held_repeat("submanifold_conv3d" + suffix, [got], [fn(*args)])
    ref, plain_ms = timed(
        lambda: sp.submanifold_conv3d_table_plain(*plain_args))
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    tol = 2.0 ** -5 * scale
    ref32 = sp.submanifold_conv3d_table_plain(
        x.bfloat16().float(), coords, plain_table, grid_shape,
        weight.bfloat16().float(), bias, compute_dtype=torch.float32)
    fp32_err = (got - ref32).abs().max().item()
    fp32_tol = 1e-3 * ref32.abs().max().item()
    if not fp32_err <= fp32_tol:
        raise RuntimeError(f"submanifold_conv3d{suffix} disagrees with the "
                           f"fp32 gather form: {fp32_err} > {fp32_tol}")
    del ref, ref32
    ms = cuda_ms(lambda: fn(*args), 20)
    table_ms = cuda_ms(lambda: sp.voxel_table_cuda(coords, grid_shape), 20)
    profiling.enable()
    try:
        fn(*args)
        counters = profiling.collect()["counters"]
    finally:
        profiling.disable()
    tiles = -(-p // sp.block_rows(p, cout))
    flops = 2.0 * counters["spconv_pairs"] * cin * cout
    dense_flops = 2.0 * p * taps * cin * cout
    nbytes = (p * cin * 2 + weight.numel() * 2 + table.numel() * 4
              + coords.numel() * 4 + p * cout * 4)
    row = dict(name="submanifold_conv3d" + suffix, route="cuda",
               source="gaussianformer_tpu_torch/csrc/spconv.cu",
               replaces="none (gaussianformer_tpu/ops/sparse_conv.py leaves "
                        "the gather and matmuls to XLA)",
               launches=launches["spconv"],
               table_launches=launches["spconv_table"],
               shape=[p, cin, cout, k], taps=taps, tiles=tiles,
               pairs=counters["spconv_pairs"],
               pair_share=counters["spconv_pairs"] / (p * taps),
               taps_skipped=counters["spconv_taps_skipped"],
               table_ms=table_ms, fp32_err=fp32_err, fp32_tol=fp32_tol,
               dense_bound_ms=dense_flops / PEAK_BF16 * 1e3,
               table_equal=True, repeat_bit_equal=True, report=True)
    return row, err, tol, ms, plain_ms, flops, nbytes


def splat_mode(points, box, grid, cap, mods) -> bool:
    """Whether K4 and K7 take their general mode at ``points`` (the bins
    their own call builds carry the points' bins)."""
    return mods.splat.bin_splat_cuda(points, box, grid, cap).points \
        is not None


def check_points_bins(points, grid, suffix, launches, mods, report):
    """The points binning of the splat's general mode
    (``csrc/splat_points_bin.cu``) against its plain version, every element
    equal (the sorted order, each voxel's first place and the work items);
    its time (CUDA events), the work items, the largest tile and voxel.
    Returns its kernels-line row."""
    splat = mods.splat
    got = splat.bin_points_cuda(points, grid)
    ref, plain_ms = timed(lambda: splat.bin_points_plain(points, grid))
    names = ("order", "voxel_start", "items")
    err = float(sum(
        getattr(got, k).numel() if getattr(got, k).shape !=
        getattr(ref, k).shape else
        int((getattr(got, k) != getattr(ref, k)).sum().item())
        for k in names))
    stats = got.stats()
    ms = cuda_ms(lambda: splat.bin_points_cuda(points, grid), 10)
    # each input read once (the points), each output written once (the
    # order, each voxel's first place, the items)
    k = math.prod(splat.tile_counts(grid)) * splat.TILE_VOXELS
    nbytes = (points.shape[0] * (12 + 4)
              + ((k + 1) + stats["item_bound"] + 1) * 4)
    row = dict(name="splat_points_bins" + suffix, route="cuda",
               source="gaussianformer_tpu_torch/csrc/splat_points_bin.cu",
               replaces="gaussianformer_tpu/ops/pallas/splat_kernel.py:334",
               launches=launches["splat_points_bin"],
               shape=[points.shape[0]], **stats, max_abs_err=err, tol=0.0,
               ms=ms, plain_ms=plain_ms, bound_ms=nbytes / PEAK_BYTES * 1e3,
               bound_by="bytes", library_ms=None, report=report)
    log(f"# {row['name']}: {stats['points']} points in "
        f"{stats['tiles_with_points']} tiles (largest {stats['max_tile_points']}"
        f", largest voxel {stats['max_voxel_points']}), {stats['items']} "
        f"work items (bound {stats['item_bound']}); "
        f"{err:.0f} elements differ from the plain bins; binning {ms:.4f} "
        f"ms, plain {plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
        f"(bytes)")
    if err:
        raise RuntimeError(f"{row['name']}: the points bins differ from the "
                           f"plain version's")
    return row


def path_capacity(kw):
    """The entries the path's bins (``kw["bins"]``, where the path handed
    K4 its bins) have room for: the bound the head sizes them by."""
    bins = kw.get("bins")
    return None if bins is None else bins.capacity


def held_given_bins(name, got, on_path_bins):
    """K4 on the bins the path built gives the bits of K4 building its
    own."""
    if not all(a is None and b is None or torch_equal(a, b)
               for a, b in zip(got, on_path_bins)):
        raise RuntimeError(f"{name}: K4 on the path's bins differs from K4 "
                           f"on its own")


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def log_bit_equal(name, got, ref):
    """Informational: whether K4's sums (and one_minus) are the plain
    version's bits (the plain version sums each voxel's Gaussians in
    another order, as dense products)."""
    log(f"# {name} sums bit-equal to the plain version's: "
        f"acc {torch_equal(got[0], ref[0])}"
        + ("" if got[1] is None else
           f", one_minus {torch_equal(got[1], ref[1])}"))


def check_bins(points, box, grid, suffix, launches, mods, report,
               cap=None):
    """The splat's tile bins (``csrc/splat_bin.cu``) against their plain
    version on the path's boxes, every tensor equal (the first
    ``tile_start[-1]`` of the entries and slots), and the flag word against
    the plain one; their time (CUDA events, the eager call's one read of
    the flag word included), the entries, the COVERS share and the tiles'
    mean and largest list lengths. ``cap``: the path's bound on the
    entries, which sizes the bins as on the path (None: by the boxes' own
    tiles, one more host read). Returns its kernels-line row."""
    splat = mods.splat
    got = splat.bin_gaussians_cuda(points, box, grid, cap)
    ref, plain_ms = timed(lambda: splat.bin_gaussians_plain(box, grid))
    names = ("tile_start", "tile_items", "entries", "slot", "gauss_start")
    e = got.num_entries

    def held(k):
        # the card's entries and slots have room for the bound; the
        # first e are the bins
        t = getattr(got, k)
        return t[:e] if k in ("entries", "slot") else t
    err = float(sum(
        held(k).numel() if held(k).shape != getattr(ref, k).shape
        else int((held(k) != getattr(ref, k)).sum().item())
        for k in names))
    flags = int(got.flags.item())
    plain_flags = splat.bin_flags_plain(points, box, grid, got.capacity)
    err += float(flags != plain_flags)
    stats = got.stats()
    ms = cuda_ms(lambda: splat.bin_gaussians_cuda(points, box, grid, cap),
                 10)
    p = box.shape[0]
    # each input read once (the boxes, the points for the raster check),
    # each output written once (Gaussian and tile starts, entries, slots)
    t = stats["tiles"]
    nbytes = p * 24 + points.shape[0] * 12 + ((p + 1) + 2 * e + (t + 1)) * 4
    row = dict(name="splat_bins" + suffix, route="cuda",
               source="gaussianformer_tpu_torch/csrc/splat_bin.cu",
               replaces="gaussianformer_tpu/ops/pallas/splat_kernel.py:343",
               launches=launches["splat_bin"], shape=[points.shape[0], p],
               **stats, capacity=got.capacity, max_abs_err=err, tol=0.0,
               ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
               library_ms=None, report=report)
    log(f"# {row['name']}: {e} entries over {t} tiles of "
        f"{'x'.join(map(str, splat.TILE))} voxels (room for "
        f"{got.capacity}), COVERS share "
        f"{stats['covers_share']:.4f}, list length mean "
        f"{stats['mean_list']:.1f} max {stats['max_list']}; flag word "
        f"{flags} (plain {plain_flags}); "
        f"{err:.0f} elements differ from the plain bins; binning "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{row['bound_ms']:.4f} ms (bytes)")
    if err:
        raise RuntimeError(f"{row['name']}: the bins differ from the plain "
                           f"version's")
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


def held_threshold_labels(name, got, ref, thresh, empty_label, splat):
    """Hold the prob splat's threshold-mode labels to the plain version's:
    equal wherever the plain occupancy is more than 1e-6 from ``thresh``
    and, above it, the plain top-two normalised semantics differ by more
    than 1e-6 (fp32 sums in another order may flip the others). Prints how
    many voxels that leaves out."""
    logits, bins, _ = splat.postprocess_prob(ref[0], ref[1])
    top = logits.topk(2, dim=-1).values
    near = ((bins - thresh).abs() < 1e-6) | (
        (bins > thresh) & (top[:, 0] - top[:, 1] < 1e-6))
    wrong = int((got[2][~near] != ref[2][~near]).sum().item())
    occupied = (bins > thresh).float().mean().item()
    empty = (ref[2] == empty_label).float().mean().item()
    log(f"# {name} labels: {int(near.sum().item())} of {near.numel()} voxels "
        f"excluded as near-ties, {wrong} of the others differ; occupancy "
        f"above {thresh} in {occupied:.4f} of voxels, label {empty_label} "
        f"in {empty:.4f}")
    if wrong:
        raise RuntimeError(f"{name}: {wrong} labels differ from the plain "
                           f"version")


def held_combine_labels(name, got, ref, splat):
    """Hold the prob splat's combine-mode labels to the plain version's:
    equal wherever the plain combined scores' top two differ by more than
    1e-6 (fp32 sums in another order may flip the others), which are
    counted."""
    logits, bins, _ = splat.postprocess_prob(ref[0], ref[1])
    top = splat.combine_geosem(logits, bins).topk(2, dim=-1).values
    near = top[:, 0] - top[:, 1] <= 1e-6
    wrong = int((got[2][~near] != ref[2][~near]).sum().item())
    log(f"# {name} labels: {int(near.sum().item())} of {near.numel()} voxels "
        f"excluded as near-ties, {wrong} of the others differ")
    if wrong:
        raise RuntimeError(f"{name}: {wrong} labels differ from the plain "
                           f"version")


def splat_pairs(points, box, grid) -> int:
    """(point, Gaussian) pairs inside the AABBs for this run's data: for
    each box, the points whose voxel (``SplatGridSpec.voxelize``) it holds,
    from a 3-D prefix sum of the points' count a voxel (for the raster
    grid, the clipped box volume)."""
    import torch
    dev = box.device
    h, w, d = grid.H, grid.W, grid.D
    vox = grid.voxelize(points)
    cnt = torch.bincount((vox[:, 0] * w + vox[:, 1]) * d + vox[:, 2],
                         minlength=h * w * d).reshape(h, w, d)
    pre = torch.zeros(h + 1, w + 1, d + 1, dtype=torch.int64, device=dev)
    pre[1:, 1:, 1:] = cnt.cumsum(0).cumsum(1).cumsum(2)
    dims = torch.tensor([h, w, d], device=dev)
    lo = box[:, :3].long().clamp_min(0)
    hi = torch.minimum(box[:, 3:].long(), dims - 1)
    meets = (lo <= hi).all(-1)
    lo = torch.minimum(lo, dims)
    hi = torch.where(meets[:, None], hi + 1, lo)
    total = 0
    for corner in range(8):
        pick = [(hi if corner >> a & 1 else lo)[:, a] for a in range(3)]
        sign = (-1) ** (3 - bin(corner).count("1"))
        total = total + sign * pre[pick[0], pick[1], pick[2]]
    return int(torch.where(meets, total, 0).sum().item())


def tiny_setup(name, dev, get_config, build_segmentor, synthetic_batch,
               overrides=None, **changes):
    """A tiny config's model and batch on ``dev`` (fp32 towers without
    DCN, since the DCN kernel takes bf16), from seed 1 on either device,
    and the lifter draws to pass; ``overrides``: the model's
    ``module_overrides`` (with the v1 lifter's ``pts_init``, the batch
    gets anchor points). With the image lifter (version 2) no random draw
    takes effect on either device: top-1 depths of 1-2 m and the
    no-occupancy bin disabled keep every candidate valid."""
    import dataclasses
    import torch
    cfg = dataclasses.replace(get_config(name), stage_with_dcn=(False,) * 4,
                              **changes)
    g = cfg.grid
    model = build_segmentor(cfg, device=dev, seed=1,
                            module_overrides=overrides)
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=1,
                            device=dev)
    if getattr(model.lifter, "pts_init", False):
        batch["anchor_points"] = torch.from_numpy(
            anchor_points_for(cfg, 1))[None].to(dev)
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


def check_small(name, get_config, build_segmentor, synthetic_batch,
                overrides=None, **changes):
    """The tiny config end to end (with ``overrides`` and ``changes`` as
    :func:`tiny_setup` takes them): the GPU run with the FPS (where the
    config has it), deformable and splat kernels against the CPU run of
    the same weights with the plain versions."""
    import torch
    outs = []
    for dev in ("cpu", "cuda"):
        cfg, model, batch, draws = tiny_setup(
            name, dev, get_config, build_segmentor, synthetic_batch,
            overrides, **changes)
        with torch.inference_mode():
            out = model(batch["imgs"], batch["projection_mat"],
                        batch["image_wh"], batch["occ_xyz"],
                        anchor_points=batch.get("anchor_points"),
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


def train_phase(cfg, model, batch, mods, expected, steps, loss_fn=None):
    """The full-width train step on ``model``: warm-up (capturing the
    backward kernels' inputs), a counted step, ``steps`` timed steps and a
    profiled step, with the config's loss stack or ``loss_fn``. Raises on
    wrong launch counts, non-finite metrics, a trained parameter that did
    not move or a frozen one that changed."""
    import torch
    from gaussianformer_tpu_torch.train.optim import (build_optimizer,
                                                      frozen_prefixes,
                                                      param_labels)
    from gaussianformer_tpu_torch.train.step import build_loss, train_step

    # the schedule's length shapes only its cosine part, which the few
    # warm-up steps here never reach
    opt, schedule = build_optimizer(model, cfg, 10000)
    loss_fn = loss_fn or build_loss(cfg)
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
    with traced_bns(cfg.name, "train step", BN_STEP[cfg.version]):
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

    idle, _ = idle_share(lambda: step("profiled"), step_ms,
                         f"{cfg.name} train step")

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
    fn, args, kw = call
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
        row = dict(name="deform_conv2d_backward" + suffix, route="cuda",
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
        general = (kw["bins"].points is not None if kw.get("bins")
                   else splat_mode(points, box, grid, None, mods))
        pre = "splat_points_" if general else "splat_"
        plain = splat.splat_backward_plain
        outs = ("g_means", "g_opacities", "g_semantics", "g_cov_inv6")
        tols = (SUM_TOL,) * 4
        pairs = splat_pairs(points, box, grid)
        n, p = gl.shape[0], gdata.shape[0]
        flops, nbytes = k7_work(*args[:7], pairs)
        peak = PEAK_FP32
        row = dict(name=pre + ("bwd_additive" if additive
                               else "prob_backward") + suffix, route="cuda",
                   source="gaussianformer_tpu_torch/csrc/"
                          + ("splat_points_bwd.cu" if general
                             else "splat_bwd.cu"),
                   replaces="gaussianformer_tpu/ops/pallas/"
                            "splat_bwd_kernel.py:196",
                   launches=launches.get(
                       ("splat_points_bwd" if general else "splat_bwd")
                       + ("_additive" if additive else ""), 0),
                   shape=[n, p], aabb_pairs=pairs, report=True)
    got = fn(*args)
    if name == "dcn_bwd":
        # no float atomics: a second call gives the same bits
        row["repeat_bit_equal"] = held_repeat(
            f"deform_conv2d_backward {list(args[0].shape)}", got, fn(*args))
    if name == "splat_bwd":
        # K7 on the forward's bins (as the path runs it) and on its own;
        # twice, as it has no atomics: the same bits each time
        row.update(splat_backward_extras(fn, args, kw, got, mods))
    elif name == "deformable_bwd":
        row.update(deformable_backward_extras(fn, args, got, launches, mods,
                                              suffix))
    ref, plain_ms = timed(lambda: plain(*args))
    vol = (splat_pairs(points, box[-1:], grid)
           if name == "splat_bwd" and additive else 0)
    if vol > BIG_BOX:
        # the last Gaussian is the head's empty one, whose box is the whole
        # grid (an entry in every tile): its row dwarfs the others
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
    # K7 timed on the forward's bins, as the path runs it
    ms = cuda_ms(lambda: fn(*args, **kw), 10)
    if name == "dcn_bwd":
        row.update(dcn_backward_extras(fn, args, mods))
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


def splat_backward_extras(fn, args, kw, got, mods) -> dict:
    """K7's numbers beside its row: on the forward's bins (``kw``, the
    path's call) it must give the bits of ``got`` (K7 binning on its own),
    and the same bits again; each launch's time alone (the tile launch, the
    fold) and the workspace's size."""
    splat = mods.splat
    on_path = fn(*args, **kw)
    again = fn(*args, **kw)
    same = all(torch_equal(a, b) for a, b in zip(got, on_path))
    repeat = all(torch_equal(a, b) for a, b in zip(on_path, again))
    bins = kw.get("bins")
    if bins is None:
        bins = splat.bin_splat_cuda(args[0], args[4], args[7])
    kwb = {**kw, "bins": bins}
    launch = {part: cuda_ms(lambda: fn(*args, **kwb, parts=bit), 10)
              for part, bit in (("tile", splat.TILE_LAUNCH),
                                ("fold", splat.FOLD_LAUNCH))}
    c = args[3].shape[1]
    work_mb = bins.capacity * (-(-(10 + c) // 4) * 4) * 4 / 1e6
    log(f"# splat backward: on the forward's bins equal to binning its own "
        f"{same}, a second call bit-equal {repeat}; tile launch "
        f"{launch['tile']:.4f} ms, fold {launch['fold']:.4f} ms; "
        f"{bins.num_entries} entries, workspace {work_mb:.1f} MB (room "
        f"for {bins.capacity} entries)")
    if not (same and repeat):
        raise RuntimeError("K7 is not deterministic across its bins or "
                           "calls")
    return dict(launch_ms=launch, entries=bins.num_entries,
                workspace_mb=work_mb, forward_bins=kw.get("bins") is not None)


def deformable_backward_extras(fn, args, got, launches, mods,
                               suffix) -> dict:
    """K6's numbers beside its row: a second call must give the bits of
    the first (no atomics); its pixel bins (``csrc/deformable_bin.cu``)
    against the plain bins, every element equal, with their entries,
    longest list, workspace and time (a row of their own); each of its two
    launches timed alone on those bins."""
    deformable = mods.deformable
    feats, pts = args[0], args[1]

    def flat(out):
        return list(out[0]) + [out[1], out[2]]
    repeat = all(torch_equal(a, b) for a, b in zip(flat(got),
                                                    flat(fn(*args))))
    shapes = [tuple(f.shape[2:4]) for f in feats]
    bins = deformable.bin_samples_cuda(pts, shapes)
    ref, plain_ms = timed(lambda: deformable.bin_samples_plain(pts, shapes))
    e = bins.num_entries
    differ = abs(e - ref.num_entries) + int(
        (bins.pixel_start != ref.pixel_start).sum().item())
    if e == ref.num_entries:
        differ += int((bins.entries[:e] != ref.entries).sum().item())
    del ref
    stats = bins.stats()
    ms = cuda_ms(lambda: deformable.bin_samples_cuda(pts, shapes), 10)
    launch = {part: cuda_ms(lambda: fn(*args, bins=bins, parts=bit), 10)
              for part, bit in (("points", deformable.POINTS_LAUNCH),
                                ("features", deformable.FEATURES_LAUNCH))}
    # each input read once (the points), each output written once (the
    # entries and the pixels' starts)
    nbytes = pts.numel() * 4 + e * 4 + (stats["pixels"] + 1) * 4
    bins_row = dict(
        name="deformable_bins" + suffix, route="cuda",
        source="gaussianformer_tpu_torch/csrc/deformable_bin.cu",
        replaces="gaussianformer_tpu/ops/pallas/deformable_kernel.py:417",
        launches=launches["deformable_bin"], shape=list(pts.shape), **stats,
        workspace_bytes=bins.workspace_bytes, max_abs_err=float(differ),
        tol=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=None, report=True)
    log(f"# {bins_row['name']}: {e} entries over {stats['pixels_used']} of "
        f"{stats['pixels']} pixels, longest list {stats['longest_list']}, "
        f"mean {stats['mean_list']:.1f}; workspace "
        f"{bins.workspace_bytes / 1e6:.1f} MB; {differ} elements differ "
        f"from the plain bins; binning {ms:.4f} ms, plain {plain_ms:.3f} "
        f"ms, bound {bins_row['bound_ms']:.4f} ms (bytes)")
    log(f"# deformable_aggregation_backward{suffix}: a second call "
        f"bit-equal {repeat}; points launch {launch['points']:.4f} ms, "
        f"features launch {launch['features']:.4f} ms")
    if differ:
        raise RuntimeError(f"{bins_row['name']}: the bins differ from the "
                           f"plain version's")
    if not repeat:
        raise RuntimeError("K6 is not deterministic across calls")
    return dict(repeat_bit_equal=repeat, launch_ms=launch,
                extra_rows=[bins_row])


def held_repeat(name, got, again) -> bool:
    """Raise unless two calls' outputs are the same bits."""
    same = all(torch_equal(a, b) for a, b in zip(got, again))
    log(f"# {name}: a second call bit-equal {same}")
    if not same:
        raise RuntimeError(f"{name}: a second call gave other bits")
    return same


#: K5's launches, in the order they run (``parts`` bits of the wrapper)
DCN_BWD_LAUNCHES = ("input", "weight", "om_sum", "fallback_bins", "g_x",
                    "w_sum")


def graph_ms(fn, iters: int = 10) -> float:
    """The device time of ``fn`` (launches on buffers it does not
    allocate), by CUDA events around a CUDA graph of ``iters`` calls, so
    that the host's time to enqueue a small launch does not count."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dcn_launches(dcn, args, iters: int = 10) -> dict:
    """Each of K5's launches' device time per call, run alone on a
    workspace and outputs that a whole call filled (``graph_ms``): the
    input launch, the weight launch, the g_offset / g_mask sums over the
    chunks, the fallback records' bins (seven small launches), g_x and the
    splits' sum of g_W."""
    import torch
    x, weight = args[0], args[3]
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    out = (torch.empty(b, h, w, cin, **f32), torch.empty(b, h, w, 18, **f32),
           torch.empty(b, h, w, 9, **f32), torch.empty(9 * cin, cout, **f32))
    ws = dcn.backward_workspace(x, cout)
    dcn.deform_conv2d_backward_cuda(*args, workspace=ws, out=out)
    bits = (dcn.INPUT_LAUNCH, dcn.WEIGHT_LAUNCH, dcn.OM_LAUNCH,
            dcn.BINS_LAUNCH, dcn.GX_LAUNCH, dcn.WSUM_LAUNCH)
    return {name: graph_ms(lambda bit=bit: dcn.deform_conv2d_backward_cuda(
        *args, parts=bit, workspace=ws, out=out), iters)
        for name, bit in zip(DCN_BWD_LAUNCHES, bits)}


def log_launches(launch) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in launch.items())


def dcn_backward_extras(fn, args, mods) -> dict:
    """K5's numbers beside its row: the share of in-image corners outside
    the kernel's shared-memory g_x window (they become fallback records, as
    do the corners past a full bucket) and each launch's time; at stage 3
    also the same with the offsets moved by uniform(-DCN_PERTURB_PX,
    DCN_PERTURB_PX) pixels, held to the plain version with the row's
    tolerances and to a second call's bits."""
    import torch
    dcn = mods.dcn
    x, offset, mask, weight, g_out = args
    share, corners = dcn.window_outside_share(offset)
    launch = dcn_launches(dcn, args)
    extras = dict(window_outside_share=share, launch_ms=launch)
    log(f"# deform_conv2d_backward {list(x.shape)}: {share:.6f} of "
        f"{corners} in-image corners outside the g_x window; launches (ms) "
        f"{log_launches(launch)}")
    if x.shape[-1] != 256:
        return extras
    gen = torch.Generator(device=offset.device).manual_seed(5)
    moved = offset.float() + (torch.rand(
        offset.shape, generator=gen, device=offset.device) * 2 - 1
        ) * DCN_PERTURB_PX
    pargs = (x, moved.contiguous(), mask, weight, g_out)
    got = fn(*pargs)
    repeat = held_repeat(f"deform_conv2d_backward {list(x.shape)}, offsets "
                         f"moved by up to {DCN_PERTURB_PX:g} px", got,
                         fn(*pargs))
    ref = dcn.deform_conv2d_backward_plain(*pargs)
    errors = {k: _max_err(k, gt, rf, tol) for k, gt, rf, tol in zip(
        ("g_x", "g_offset", "g_mask", "g_weight"), got, ref,
        (BF16_TOL, SUM_TOL, SUM_TOL, BF16_TOL))}
    del got, ref
    share, corners = dcn.window_outside_share(moved)
    ms = cuda_ms(lambda: fn(*pargs), 10)
    launch = dcn_launches(dcn, pargs)
    log(f"# deform_conv2d_backward {list(x.shape)}, offsets moved by up to "
        f"{DCN_PERTURB_PX:g} px: {share:.6f} of {corners} in-image corners "
        f"outside the g_x window; "
        + ", ".join(f"{k} {e:.3e} (tol {t:.3e})"
                    for k, (e, t) in errors.items())
        + f"; kernel {ms:.4f} ms (launches: {log_launches(launch)})")
    bad = {k: e for k, (e, t) in errors.items() if not e <= t}
    if bad:
        raise RuntimeError(f"deform_conv2d_backward with moved offsets "
                           f"disagrees with its plain version: {bad}")
    extras["moved_offsets"] = dict(
        px=DCN_PERTURB_PX, window_outside_share=share, ms=ms,
        launch_ms=launch, max_abs_err=max(e for e, _ in errors.values()),
        errors={k: {"max_abs_err": e, "tol": t}
                for k, (e, t) in errors.items()},
        repeat_bit_equal=repeat)
    return extras


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
