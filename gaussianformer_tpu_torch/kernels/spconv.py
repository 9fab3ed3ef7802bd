"""The submanifold sparse 3D conv of the frame path, fused.

Kernels: ``csrc/spconv.cu``: ``gf_spconv_table`` (the voxel -> anchor
table) and ``gf_spconv_forward`` (gather and matmul in one kernel). They
replace no TPU kernel: ``gaussianformer_tpu/ops/sparse_conv.py`` leaves the
gather and the matmuls to XLA, and the port's gather form
(``ops/sparse_conv.py``) writes every tap's neighbour rows to device memory.
Plain versions: :func:`voxel_table_plain` and :func:`tap_neighbors_plain`
(the kernels' neighbour rule: the highest anchor index of a voxel wins) and
:func:`submanifold_conv3d_table_plain`, the gather form on that rule.

The kernel runs where :func:`why_not_fused` finds nothing against it: bf16
compute, no gradient wanted, C_in and C_out multiples of 32, an odd k up
to 5, CUDA tensors. Anywhere else (every train step, the fp32 tiny configs, the CPU)
``SparseConv3DModule`` keeps the gather form.
"""
from __future__ import annotations

import torch

from ..device import constant
from ..ops.sparse_conv import submanifold_conv3d
from ..utils import profiling
from . import _lib

def voxel_table_plain(coords, grid_shape):
    """int32 [X * Y * Z]: the highest index of the anchors in each voxel,
    -1 where none is. ``coords`` [P, 3] voxel coordinates in the grid."""
    X, Y, Z = grid_shape
    c = coords.long()
    flat = (c[:, 0] * Y + c[:, 1]) * Z + c[:, 2]
    table = torch.full((X * Y * Z,), -1, dtype=torch.int32,
                       device=coords.device)
    table.scatter_reduce_(0, flat, torch.arange(
        c.shape[0], dtype=torch.int32, device=coords.device), reduce="amax")
    return table


def tap_neighbors_plain(coords, table, grid_shape, k: int):
    """[P, k^3] int64: the table's anchor at each tap's voxel (taps in
    ``(kx k + ky) k + kz`` order, as the weights), -1 outside the grid or
    where the voxel is empty."""
    X, Y, Z = grid_shape
    dev = coords.device
    r = k // 2
    rng = torch.arange(-r, r + 1, device=dev)
    offs = torch.stack(torch.meshgrid(rng, rng, rng, indexing="ij"),
                       dim=-1).reshape(-1, 3)
    nb = coords.long()[:, None, :] + offs[None]
    dims = constant((X, Y, Z), torch.int64, dev)
    inside = ((nb >= 0) & (nb < dims)).all(-1)
    flat = (nb[..., 0] * Y + nb[..., 1]) * Z + nb[..., 2]
    found = table[flat.clamp(0, X * Y * Z - 1)].long()
    return torch.where(inside, found, torch.full_like(found, -1))


def submanifold_conv3d_table_plain(features, coords, table, grid_shape,
                                   weight, bias=None,
                                   compute_dtype=torch.bfloat16):
    """What :func:`submanifold_conv3d_cuda` computes, in the gather form of
    ``ops/sparse_conv.py`` (which rounds each chunk of 25 taps' product to
    ``compute_dtype``, where the kernel sums every tap in fp32)."""
    nb = tap_neighbors_plain(coords, table, grid_shape, weight.shape[1])
    nb = torch.where(nb < 0, torch.full_like(nb, features.shape[0]), nb)
    return submanifold_conv3d(features, nb, weight, bias,
                              compute_dtype=compute_dtype)


def why_not_fused(features, weights, biases, compute_dtype):
    """Why the fused kernel cannot run convs of these ``weights`` ([C_out,
    k, k, k, C_in] each) and ``biases`` (None or [C_out]) on ``features``:
    "dtype", "grad", "shape" or "device"; None where it can."""
    if compute_dtype != torch.bfloat16:
        return "dtype"
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (features, *weights, *biases)):
        return "grad"
    for w in weights:
        cout, k, _, _, cin = w.shape
        if cin % 32 or cout % 32 or k % 2 == 0 or k > 5:
            return "shape"
    if not features.is_cuda:
        return "device"
    return None


def _grid(name, grid_shape):
    X, Y, Z = (int(s) for s in grid_shape)
    if min(X, Y, Z) < 1 or X * Y * Z >= 2 ** 31:
        raise ValueError(f"{name}: grid {grid_shape} out of range")
    return X, Y, Z


def voxel_table_cuda(coords, grid_shape):
    """Launch ``gf_spconv_table``: ``coords`` int32 [P, 3] on the card ->
    the int32 table of :func:`voxel_table_plain`."""
    name = "spconv_table"
    _lib.require_cuda(name, coords=coords)
    _lib.require_dtype(name, "coords", coords, torch.int32)
    if coords.dim() != 2 or coords.shape[1] != 3:
        raise ValueError(f"{name}: coords must be [P, 3]")
    X, Y, Z = _grid(name, grid_shape)
    table = torch.empty(X * Y * Z, dtype=torch.int32, device=coords.device)
    code = _lib.lib().gf_spconv_table(coords.data_ptr(), coords.shape[0], X,
                                      Y, Z, table.data_ptr(),
                                      _lib.stream_ptr(coords))
    _lib.check(code, name)
    _lib.LAUNCHES["spconv_table"] += 1
    return table


def block_rows(p: int, cout: int) -> int:
    """The anchor rows of a block the kernel takes for ``p`` anchors and
    ``cout`` channels on this card (``gf_spconv_block_rows``)."""
    return _lib.lib().gf_spconv_block_rows(p, cout)


def submanifold_conv3d_cuda(features, coords, table, grid_shape, weight,
                            bias=None):
    """Launch ``gf_spconv_forward``: ``features`` [P, C_in] (cast to bf16,
    as the gather form's ``compute_dtype``), ``coords`` int32 [P, 3],
    ``table`` from :func:`voxel_table_cuda`, ``weight`` [C_out, k, k, k,
    C_in] (cast to bf16), ``bias`` [C_out] or None -> fp32 [P, C_out].
    While tracing is on, counts ``spconv_pairs`` (the non-empty (anchor,
    tap) pairs) and ``spconv_taps_skipped`` (the (row tile, tap) pairs
    skipped whole, a tile being :func:`block_rows` anchors), summed on the
    card."""
    name = "submanifold_conv3d"
    p, cin = features.shape
    cout, k = weight.shape[0], weight.shape[1]
    if tuple(weight.shape) != (cout, k, k, k, cin):
        raise ValueError(f"{name}: weight has shape {tuple(weight.shape)}")
    X, Y, Z = _grid(name, grid_shape)
    x = features.to(torch.bfloat16).contiguous()
    w = weight.to(torch.bfloat16).contiguous()
    b = None if bias is None else bias.float().contiguous()
    _lib.require_cuda(name, x=x, coords=coords, table=table, w=w, b=b)
    _lib.require_dtype(name, "coords", coords, torch.int32)
    _lib.require_dtype(name, "table", table, torch.int32)
    if tuple(coords.shape) != (p, 3) or table.numel() != X * Y * Z:
        raise ValueError(f"{name}: coords must be [P, 3] and the table "
                         f"[X * Y * Z]")
    if b is not None and b.shape != (cout,):
        raise ValueError(f"{name}: bias must be [C_out]")
    out = torch.empty(p, cout, dtype=torch.float32, device=x.device)
    stats = None
    if profiling.enabled():
        stats = torch.empty(-(-p // block_rows(p, cout)), 2,
                            dtype=torch.int32, device=x.device)
    code = _lib.lib().gf_spconv_forward(
        x.data_ptr(), coords.data_ptr(), table.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(), p, cin, cout, k, X, Y,
        Z, _lib.stream_ptr(x))
    _lib.check(code, name)
    _lib.LAUNCHES["spconv"] += 1
    if stats is not None:
        profiling.count("spconv_pairs", stats[:, 0])
        profiling.count("spconv_taps_skipped", stats[:, 1])
    return out

