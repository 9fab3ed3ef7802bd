"""The splat's general mode on the GPU (``bench_splat --points``): the
points binning, K4 and K7 at query points that are not the splat grid,
optionally beside another tree's general-mode kernels in the same process.
See ``bench_splat.py`` for the command line and what it prints."""
from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from . import bench_splat
from .configs import get_config
from .data.synthetic import finer_points, lidar_points, synthetic_batch
from .kernels import _lib, splat
from .models.segmentor import build_segmentor
from .train.optim import build_optimizer
from .train.step import build_loss, train_step

ITERS = 10
#: NVIDIA H100 SXM data sheet peaks (dense fp32, HBM3), for the bounds
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
#: the designs whose lanes are modelled: K4's points a work group (the
#: parent: a block's work item; this tree: a warp's two rounds of 32) and
#: K7's (the parent: a warp walks a whole work item; this tree: a warp
#: walks the runs of one piece of an entry's box)
K4_GROUP = {"parent": splat.TILE_VOXELS, "change": 64}


def _ms(fn, iters=ITERS):
    return bench_splat._ms(fn, iters)


def capture(name, frame_batch, step_batch=None):
    """The K4 call of one inference frame at ``frame_batch`` and the first
    K7 call of a train step at ``step_batch`` (where given), of the
    config's full-width model with random weights from seed 0."""
    cfg = get_config(name)
    model = build_segmentor(cfg, device="cuda", seed=0)
    calls = {}
    orig4, orig7 = splat.splat_accumulate_cuda, splat.splat_backward_cuda

    def spy4(*a, **k):
        calls["k4"] = (a, k)
        return orig4(*a, **k)

    def spy7(*a, **k):
        calls.setdefault("k7", (a, k))
        return orig7(*a, **k)
    try:
        splat.splat_accumulate_cuda = spy4
        with torch.inference_mode():
            b = frame_batch
            model(b["imgs"], b["projection_mat"], b["image_wh"],
                  b["occ_xyz"],
                  generator=torch.Generator(device="cuda").manual_seed(0))
        splat.splat_accumulate_cuda = orig4
        if step_batch is not None:
            splat.splat_backward_cuda = spy7
            opt, schedule = build_optimizer(model, cfg, 10000)
            train_step(model, opt, schedule, build_loss(cfg), step_batch,
                       torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
    finally:
        splat.splat_accumulate_cuda = orig4
        splat.splat_backward_cuda = orig7
    del model
    torch.cuda.empty_cache()

    def detached(call):
        a, k = call
        return tuple(t.detach() if isinstance(t, torch.Tensor) else t
                     for t in a), k
    return {k: detached(v) for k, v in calls.items()}


def batches(name, finer: bool):
    cfg = get_config(name)
    g = cfg.grid
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=0,
                            device="cuda")
    return finer_points(batch, 2) if finer else batch


# ---------------------------------------------------------------------------
# the parent's general-mode entry points


def build_parent(csrc):
    """Compile another tree's ``csrc/*.cu`` into a library of its own and
    bind its general-mode entry points (the points binning with its tile
    order, K4 on work items, K7 a block per tile, and the raster fold)."""
    so = _lib.BUILD_DIR / "bench_splat_points_parent" / "libparent.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    _lib._compile_and_link(sorted(csrc.glob("*.cu")), so,
                           so.with_suffix(".log"))
    lib = ctypes.CDLL(str(so))
    P, I, F, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
    FP = ctypes.POINTER(F)
    for fn, types in (
            ("gf_splat_points_bin_sizes", [L, I, I, I, ctypes.POINTER(L)]),
            ("gf_splat_points_bin", [P, L, FP, F, I, I, I, P, P, P, P, P,
                                     P]),
            ("gf_splat_points_forward", [P, FP, F, I, I, I, P, P, P, I, P, P,
                                         P, I, P, P, P, P, P, I, F, I, P]),
            ("gf_splat_points_forward_additive", [P, FP, F, I, I, I, P, P, P,
                                                  I, P, P, P, I, P, P, P, P,
                                                  P]),
            ("gf_splat_points_backward", [P, FP, F, I, I, I, P, P, P, P, P,
                                          P, P, P, P, I, P, P, P, P, P]),
            ("gf_splat_points_backward_additive", [P, FP, F, I, I, I, P, P,
                                                   P, P, P, P, P, P, I, P, P,
                                                   P, P, P]),
            ("gf_splat_backward", [P, P, P, P, P, P, P, I, I, I, I, I, P, P,
                                   P, P, P, P, P, P, P, P, I, P]),
            ("gf_splat_backward_additive", [P, P, P, P, P, P, I, I, I, I, I,
                                            P, P, P, P, P, P, P, P, P, P, I,
                                            P])):
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = I
    return lib


def _check(code, fn):
    if code != 0:
        raise RuntimeError(f"{fn} returned {code}")


def _pc(grid):
    return (ctypes.c_float * 3)(*grid.pc_min), float(grid.grid_size)


def parent_bins(lib, points, grid):
    """The parent's points bins: (order, start, items, tile_order, I)."""
    n = points.shape[0]
    sizes = (ctypes.c_longlong * 2)()
    _check(lib.gf_splat_points_bin_sizes(n, grid.H, grid.W, grid.D, sizes),
           "gf_splat_points_bin_sizes")
    tiles = int(np.prod(splat.tile_counts(grid)))
    i32 = dict(dtype=torch.int32, device=points.device)
    ws = torch.empty(sizes[0], **i32)
    order = torch.empty(n, **i32)
    start = torch.empty(tiles + 1, **i32)
    items = torch.empty(sizes[1] + 1, **i32)
    tile_order = torch.empty(tiles, **i32)
    pc, gs = _pc(grid)

    def run():
        _check(lib.gf_splat_points_bin(
            points.data_ptr(), n, pc, gs, grid.H, grid.W, grid.D,
            ws.data_ptr(), order.data_ptr(), start.data_ptr(),
            items.data_ptr(), tile_order.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "gf_splat_points_bin")
    run()
    return (order, start, items, tile_order, int(sizes[1])), run


def parent_k4(lib, args, lab, gbins, pbins):
    """The parent's K4 on its points bins and this tree's Gaussian bins
    (``splat_bin.cu`` is the same): outputs and a launcher."""
    points, gdata, box, sem_aug, grid, variant = args
    n, ca = points.shape[0], sem_aug.shape[1]
    f32 = dict(dtype=torch.float32, device=points.device)
    acc = torch.empty(n, ca, **f32)
    om = torch.empty(n, **f32)
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    order, start, items, _, bound = pbins
    pc, gs = _pc(grid)
    stream = torch.cuda.current_stream().cuda_stream
    head = (points.data_ptr(), pc, gs, grid.H, grid.W, grid.D,
            order.data_ptr(), start.data_ptr(), items.data_ptr(), bound,
            gdata.data_ptr(), box.data_ptr(), sem_aug.data_ptr(), ca - 2,
            gbins.tile_start.data_ptr(), gbins.entries.data_ptr(),
            acc.data_ptr())
    if variant == "additive":
        def run():
            _check(lib.gf_splat_points_forward_additive(
                *head, labels.data_ptr(), stream), "parent K4")
        return (acc, None, labels), run

    def run():
        _check(lib.gf_splat_points_forward(
            *head, om.data_ptr(), labels.data_ptr(),
            int(lab.get("label_mode", "combine") == "threshold"),
            float(lab.get("thresh", 0.5)), int(lab.get("empty_label", 17)),
            stream), "parent K4")
    return (acc, om, labels), run


def parent_k7(lib, args, gbins, pbins):
    """The parent's K7 (its tile launch, then the raster fold of the same
    ``splat_bwd.cu``) on its points bins and this tree's Gaussian bins:
    outputs and a launcher."""
    points, gdata, opa, sem, box, gl, scalars, grid, variant = args
    p, c = sem.shape
    f32 = dict(dtype=torch.float32, device=points.device)
    outs = (torch.empty(p, 3, **f32), torch.empty(p, **f32),
            torch.empty(p, c, **f32), torch.empty(p, 6, **f32))
    work = torch.empty(gbins.capacity, -(-(10 + c) // 4) * 4, **f32)
    order, start, _, tile_order, _ = pbins
    pc, gs = _pc(grid)
    stream = torch.cuda.current_stream().cuda_stream
    prob = variant == "prob"
    scal = (scalars.data_ptr(),) if prob else ()
    tables = (gdata.data_ptr(), opa.data_ptr(), sem.data_ptr(),
              box.data_ptr(), gl.data_ptr())
    tile = (points.data_ptr(), pc, gs, grid.H, grid.W, grid.D,
            order.data_ptr(), start.data_ptr(), tile_order.data_ptr(),
            *tables, *scal, c, gbins.tile_start.data_ptr(),
            gbins.entries.data_ptr(), gbins.slot.data_ptr(),
            work.data_ptr(), stream)
    fold = (points.data_ptr(), *tables, *scal, p, c, grid.H, grid.W, grid.D,
            gbins.tile_start.data_ptr(), gbins.tile_items.data_ptr(),
            gbins.entries.data_ptr(), gbins.slot.data_ptr(),
            gbins.gauss_start.data_ptr(), work.data_ptr(),
            *[o.data_ptr() for o in outs], splat.FOLD_LAUNCH, stream)

    def run():
        if prob:
            _check(lib.gf_splat_points_backward(*tile), "parent K7")
            _check(lib.gf_splat_backward(*fold), "parent fold")
        else:
            _check(lib.gf_splat_points_backward_additive(*tile),
                   "parent K7")
            _check(lib.gf_splat_backward_additive(*fold), "parent fold")
    return outs, run


# ---------------------------------------------------------------------------
# counts: pairs, bounds, and each design's lanes


def voxel_counts(points, grid):
    """The points' voxels [N, 3] and the count a voxel [H, W, D]."""
    vox = grid.voxelize(points)
    cnt = torch.bincount((vox[:, 0] * grid.W + vox[:, 1]) * grid.D
                         + vox[:, 2], minlength=grid.num_voxels)
    return vox, cnt.reshape(grid.H, grid.W, grid.D)


def box_counts(cnt, lo, hi):
    """Points inside each box [lo, hi] (voxels, inclusive, already clipped
    to the grid; empty where lo > hi), from a 3-D prefix sum."""
    h, w, d = cnt.shape
    pre = torch.zeros(h + 1, w + 1, d + 1, dtype=torch.int64,
                      device=cnt.device)
    pre[1:, 1:, 1:] = cnt.cumsum(0).cumsum(1).cumsum(2)
    meets = (lo <= hi).all(-1)
    hi1 = torch.where(meets[:, None], hi + 1, lo)
    total = torch.zeros(lo.shape[0], dtype=torch.int64, device=cnt.device)
    for corner in range(8):
        pick = [(hi1 if corner >> a & 1 else lo)[:, a] for a in range(3)]
        sign = (-1) ** (3 - bin(corner).count("1"))
        total = total + sign * pre[pick[0], pick[1], pick[2]]
    return torch.where(meets, total, 0)


def entry_boxes(gbins, box, grid):
    """Each entry's tile and its Gaussian's box clipped to the tile."""
    e = gbins.num_entries
    dev = box.device
    lengths = (gbins.tile_start[1:] - gbins.tile_start[:-1]).long()
    tile = torch.repeat_interleave(torch.arange(lengths.shape[0],
                                                device=dev), lengths)
    g = (gbins.entries[:e] & 0x7FFFFFFF).long()
    nt = splat.tile_counts(grid)
    t3 = torch.stack([tile // (nt[1] * nt[2]), tile // nt[2] % nt[1],
                      tile % nt[2]], -1)
    size = torch.tensor(splat.TILE, device=dev)
    dims = torch.tensor([grid.H, grid.W, grid.D], device=dev)
    t_lo = t3 * size
    t_hi = torch.minimum(t_lo + size, dims) - 1
    b = box[g].long()
    return tile, torch.maximum(b[:, :3], t_lo), torch.minimum(b[:, 3:], t_hi)


def pairs_of(points, box, grid):
    """(point, Gaussian) pairs inside the AABBs, this run's data."""
    _, cnt = voxel_counts(points, grid)
    dims = torch.tensor([grid.H, grid.W, grid.D], device=box.device)
    lo = torch.minimum(box[:, :3].long().clamp_min(0), dims)
    hi = torch.minimum(box[:, 3:].long(), dims - 1)
    return int(box_counts(cnt, lo, hi).sum().item())


def group_lanes(points, grid, gbins, box, design):
    """K4's (or the parent's K7's) tested pairs and skipped share: the
    sorted points cut into groups (a tile's run in the design's order, cut
    into work items of TILE_VOXELS and those into K4_GROUP[design]); every
    entry of the group's tile whose box misses the group's voxel bounds
    (and does not cover the tile) is skipped by the group whole, every
    other is tested against each of its points. Returns (tested pairs,
    groups x entries, skipped)."""
    vox = grid.voxelize(points)
    nt = splat.tile_counts(grid)
    tv = [vox[:, a] // splat.TILE[a] for a in range(3)]
    tile = (tv[0] * nt[1] + tv[1]) * nt[2] + tv[2]
    code = ((vox[:, 0] % 8) * 8 + vox[:, 1] % 8) * 16 + vox[:, 2] % 16
    key = tile * (splat.TILE_VOXELS if design == "change" else 1) + (
        code if design == "change" else 0)
    order = torch.sort(key, stable=True).indices
    st = tile[order]
    # place of each sorted point in its tile, its item, its group
    first = torch.searchsorted(st, st, side="left")
    local = torch.arange(st.shape[0], device=st.device) - first
    size = K4_GROUP[design]
    gid_local = local // size
    new = torch.ones_like(st, dtype=torch.bool)
    new[1:] = (st[1:] != st[:-1]) | (gid_local[1:] != gid_local[:-1])
    gid = torch.cumsum(new.long(), 0) - 1
    groups = int(gid[-1].item()) + 1 if gid.numel() else 0
    v = vox[order].long()
    big = torch.full((groups, 3), 1 << 20, device=v.device,
                     dtype=torch.long)
    lo = big.scatter_reduce(0, gid[:, None].expand(-1, 3), v, "amin")
    hi = (-big).scatter_reduce(0, gid[:, None].expand(-1, 3), v, "amax")
    gcount = torch.bincount(gid, minlength=groups)
    gtile = torch.zeros(groups, dtype=torch.long, device=v.device)
    gtile[gid] = st
    ts = gbins.tile_start.long()
    ent_tile, elo, ehi = entry_boxes(gbins, box, grid)
    covers = gbins.entries[:gbins.num_entries] < 0
    n_ent = (ts[gtile + 1] - ts[gtile])
    tested = skipped = total = 0
    chunk = max(1, (1 << 24) // max(int(n_ent.max().item()), 1))
    for g0 in range(0, groups, chunk):
        sl = slice(g0, g0 + chunk)
        ne = n_ent[sl]
        rep = torch.repeat_interleave(torch.arange(ne.shape[0],
                                                   device=v.device), ne)
        off = torch.arange(rep.shape[0], device=v.device) - \
            torch.repeat_interleave(torch.cumsum(ne, 0) - ne, ne)
        e = ts[gtile[sl]][rep] + off
        miss = ((ehi[e] < lo[sl][rep]) | (elo[e] > hi[sl][rep])).any(-1) \
            & ~covers[e]
        tested += int((gcount[sl][rep] * (~miss)).sum().item())
        skipped += int(miss.sum().item())
        total += int(rep.shape[0])
    return tested, total, skipped


def piece_lanes(points, grid, gbins, box, variant):
    """This tree's K7: each entry's in-box points n_e (its box's runs), cut
    into pieces at the level the kernel takes (``points_piece_level``); a
    warp walks a piece in rounds of 32. Returns (lane slots, entries,
    entries with no point, the piece size)."""
    _, cnt = voxel_counts(points, grid)
    _, elo, ehi = entry_boxes(gbins, box, grid)
    n_e = box_counts(cnt, elo, ehi)
    level = splat.points_piece_level(n_e, gbins.capacity, variant)
    piece = (int(n_e.max().item()) + 1 if level == splat.POINTS_LEVELS - 1
             else splat.POINTS_PIECE << level)
    full = n_e // piece
    rest = n_e - full * piece
    slots = full * (-(-piece // 32) * 32) + (-(-rest // 32)) * 32
    return (int(slots.sum().item()), int(n_e.shape[0]),
            int((n_e == 0).sum().item()), piece)


# ---------------------------------------------------------------------------
# the cases


def k4_bound(points, gdata, box, sem_aug, pairs, prob):
    n = points.shape[0]
    c = sem_aug.shape[1] - (0 if prob else 2)
    flops = pairs * (24 + 2 * c + (2 if prob else 0))
    nbytes = (n * 12 + gdata.numel() * 4 + box.numel() * 4
              + sem_aug.numel() * 4 + n * (c + (2 if prob else 3)) * 4)
    return _bound(flops, nbytes)


def k7_bound(points, gdata, opa, sem, box, gl, scalars, pairs):
    n, c = gl.shape
    p = gdata.shape[0]
    additive = scalars is None
    flops = pairs * ((50 if additive else 60) + 4 * c)
    nbytes = (n * 12 + gl.numel() * 4
              + (0 if additive else scalars.numel() * 4)
              + gdata.numel() * 4 + opa.numel() * 4 + sem.numel() * 4
              + box.numel() * 4 + p * (3 + 1 + c + 6) * 4)
    return _bound(flops, nbytes)


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def kernel_ms(fn, calls: int = 3) -> dict:
    """Device time a call of each CUDA kernel that ``fn`` launches (ms), by
    torch.profiler over ``calls`` calls after a warm-up."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or getattr(
            ev, "cuda_time_total", 0)
        if t <= 0:
            continue
        key = ev.key.replace("(anonymous namespace)::", "")
        m = re.search(r"(\w+)(<[^()]*>)?\(", key)
        name = (m.group(1) + (m.group(2) or "")) if m else ev.key[:60]
        out[name] = out.get(name, 0.0) + t / calls / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:12])


def graph_ms(fn, iters: int = 10) -> float:
    """The device time of a call of ``fn``: CUDA events around a CUDA graph
    of ``iters`` calls, so that the host's time to enqueue its launches
    does not count (as ``chip_smoke.py::graph_ms``)."""
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


def _diff(a, b):
    return (a.float() - b.float()).abs().max().item()


def turns(row, key, runs, order):
    for who in order:
        if who in runs:
            row.setdefault(f"{key}_{who}_ms", []).append(_ms(runs[who]))


def k4_case(tag, args, kw, parent, order):
    """The points binning and K4 of one case."""
    points, gdata, box, sem_aug, grid, variant = args
    lab = {k: v for k, v in kw.items() if k != "bins"}
    cap = kw["bins"].capacity if kw.get("bins") is not None else None
    bins = gbins = splat.bin_splat_cuda(points, box, grid, cap,
                                        grid_ordered=False)
    pairs = pairs_of(points, box, grid)
    row = dict(case=tag, kernel=f"K4 {variant}", points=points.shape[0],
               gaussians=gdata.shape[0], pairs=pairs,
               entries=gbins.num_entries,
               **k4_bound(points, gdata, box, sem_aug, pairs,
                          variant == "prob"))
    for design in ("parent", "change"):
        tested, total, skipped = group_lanes(points, grid, gbins, box,
                                             design)
        row[f"lane_efficiency_{design}"] = pairs / max(tested, 1)
        row[f"skipped_whole_{design}"] = skipped / max(total, 1)
    got = splat.splat_accumulate_cuda(*args, **lab, bins=bins)
    runs_bin = {"change": lambda: splat.bin_points_cuda(points, grid)}
    runs_k4 = {"change": lambda: splat.splat_accumulate_cuda(
        *args, **lab, bins=bins)}
    runs_both = {"change": lambda: splat.splat_accumulate_cuda(
        *args, **lab, bins=splat.bin_splat_cuda(points, box, grid, cap,
                                                grid_ordered=False))}
    if parent is not None:
        pbins, run_pbin = parent_bins(parent, points, grid)
        pout, run_p4 = parent_k4(parent, args, lab, gbins, pbins)
        run_p4()
        row["k4_max_diff_to_parent"] = _diff(got[0], pout[0])
        row["k4_labels_differ_from_parent"] = int(
            (got[2] != pout[2]).sum().item())
        runs_bin["parent"] = run_pbin
        runs_k4["parent"] = run_p4

        def both():
            # the Gaussians' binning alone, as the parent's path ran it
            splat._bin_gaussians(None, box, grid, cap)
            run_pbin()
            run_p4()
        runs_both["parent"] = both
    turns(row, "bins", runs_bin, order)
    turns(row, "k4", runs_k4, order)
    turns(row, "k4_both_binnings", runs_both, order)
    for who in order[:len(runs_bin)]:
        row.setdefault(f"bins_graph_{who}_ms", []).append(
            graph_ms(runs_bin[who]))
    row["bins_kernels_ms"] = kernel_ms(runs_bin["change"])
    times = {}
    splat.splat_accumulate_cuda(*args, **lab, bins=bins, block_times=times)
    row["k4_longest_block_share"] = splat.block_share(times["k4"])
    n = points.shape[0]
    row["bins_bound_ms"] = (n * 16 + splat.points_items_bound(n, grid) * 4
                            ) / PEAK_BYTES * 1e3
    print(f"# {tag}: {json.dumps(row)}", flush=True)
    return row


def k7_case(tag, args, kw, parent, order, raster=None):
    """K7 of one case (and the raster K7 on the same cotangents, where
    ``raster`` gives its call)."""
    points, gdata, opa, sem, box, gl, scalars, grid, variant = args
    cap = kw["bins"].capacity if kw.get("bins") is not None else None
    bins = gbins = splat.bin_splat_cuda(points, box, grid, cap,
                                        grid_ordered=False)
    pairs = pairs_of(points, box, grid)
    row = dict(case=tag, kernel=f"K7 {variant}", points=points.shape[0],
               gaussians=gdata.shape[0], pairs=pairs,
               entries=gbins.num_entries,
               **k7_bound(points, gdata, opa, sem, box, gl, scalars, pairs))
    tested, total, skipped = group_lanes(points, grid, gbins, box, "parent")
    row["lane_efficiency_parent"] = pairs / max(tested, 1)
    row["skipped_whole_parent"] = skipped / max(total, 1)
    slots, entries, empty, piece = piece_lanes(points, grid, gbins, box,
                                               variant)
    row["lane_efficiency_change"] = pairs / max(slots, 1)
    row["skipped_whole_change"] = empty / max(entries, 1)
    row["piece_points"] = piece
    got = splat.splat_backward_cuda(*args, bins=bins)
    runs = {"change": lambda: splat.splat_backward_cuda(*args, bins=bins)}
    tile_runs = {"change": lambda: splat.splat_backward_cuda(
        *args, bins=bins, parts=splat.TILE_LAUNCH)}
    if parent is not None:
        pbins, _ = parent_bins(parent, points, grid)
        pout, run_p7 = parent_k7(parent, args, gbins, pbins)
        run_p7()
        row["k7_rel_diff_to_parent"] = {
            k: _diff(a, b) / max(b.abs().max().item(), 1e-30)
            for k, a, b in zip(("gmu", "gopa", "gsem", "gcov"), got, pout)}
        runs["parent"] = run_p7
    turns(row, "k7", runs, order)
    turns(row, "k7_tile", tile_runs, order)
    row["k7_kernels_ms"] = kernel_ms(runs["change"])
    times = {}
    splat.splat_backward_cuda(*args, bins=bins, block_times=times)
    row["k7_longest_block_share"] = splat.block_share(times["k7"])
    again = splat.splat_backward_cuda(*args, bins=bins)
    row["k7_repeat_bit_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(got, again))
    if raster is not None:
        row["raster_k7_ms"] = [_ms(raster) for _ in range(2)]
    print(f"# {tag}: {json.dumps(row)}", flush=True)
    return row


def main(args):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}", flush=True)
    _lib.lib()
    parent = build_parent(args.parent) if args.parent is not None else None
    order = (["parent", "change", "change", "parent"] if parent is not None
             else ["change", "change"])
    result = {"card": card, "seed": args.seed, "rows": []}
    rows = result["rows"]
    # the flagship: a frame at the finer points, a train step at its grid
    flag = capture("prob_gs6400", batches("prob_gs6400", True),
                   batches("prob_gs6400", False))
    v1 = capture("gs25600_solid", batches("gs25600_solid", True),
                 batches("gs25600_solid", True))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    with torch.inference_mode():
        if "finer" in args.points:
            rows.append(k4_case("prob_gs6400_finer", *flag["k4"], parent,
                                order))
            rows.append(k4_case("gs25600_solid_finer", *v1["k4"], parent,
                                order))
            rows.append(k7_case("gs25600_solid_finer", *v1["k7"], parent,
                                order))
            a7, kw7 = flag["k7"]
            n = a7[0].shape[0]
            perm = torch.randperm(n, generator=gen, device="cuda")
            pa = tuple(t[perm].contiguous() if i in (0, 5, 6) else t
                       for i, t in enumerate(a7))
            rows.append(k7_case(
                "prob_gs6400_permuted", pa, kw7, parent, order,
                raster=lambda: splat.splat_backward_cuda(*a7, **kw7)))
        if "lidar" in args.points:
            pts = torch.from_numpy(lidar_points(args.seed)).cuda()
            n = pts.shape[0]
            for name, calls in (("prob_gs6400", flag),
                                ("gs25600_solid", v1)):
                a4, kw4 = calls["k4"]
                rows.append(k4_case(f"{name}_lidar", (pts,) + a4[1:],
                                    {"bins": kw4.get("bins")}, parent,
                                    order))
                a7, kw7 = calls["k7"]
                c = a7[3].shape[1]
                gl = torch.randn(n, c, generator=gen, device="cuda")
                sc = (torch.randn(n, 3, generator=gen, device="cuda")
                      if a7[6] is not None else None)
                rows.append(k7_case(f"{name}_lidar",
                                    (pts,) + a7[1:5] + (gl, sc) + a7[7:],
                                    {"bins": kw7.get("bins")}, parent,
                                    order))
    print(card)
    print(json.dumps(result), flush=True)
    return 0
