"""The fused submanifold conv's CPU side (``kernels/spconv.py``): its
neighbour rule (a voxel table where the highest anchor index wins, looked up
by tap) against ``ops/sparse_conv.py::neighbor_anchors``, the dispatch
between the kernel and the gather form, and the wiring of the kernel's
route through ``SparseConv3DModule`` with the kernel calls replaced by their
plain versions. The kernels themselves are held to their plain versions on
the card (``tests/test_torch_port_cuda.py``)."""
import numpy as np
import pytest
import torch

from gaussianformer_tpu_torch.kernels import spconv
from gaussianformer_tpu_torch.models.encoder.modules import (
    SparseConv3DModule, SubMConv3d)
from gaussianformer_tpu_torch.ops.coords import cartesian
from gaussianformer_tpu_torch.ops.sparse_conv import (neighbor_anchors,
                                                      submanifold_conv3d,
                                                      voxel_indices)

PC_RANGE = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
GRID = (12, 10, 6)


def _coords(case, p, seed=0):
    rng = np.random.default_rng(seed)
    X, Y, Z = GRID
    if case == "random":
        c = rng.integers(0, (X, Y, Z), size=(p, 3))
    elif case == "shared":
        # many anchors in few voxels: every voxel is shared
        cells = rng.integers(0, (X, Y, Z), size=(7, 3))
        c = cells[rng.integers(0, 7, size=p)]
    else:
        # corners and edges: every coordinate at 0 or the grid's last
        c = rng.integers(0, 2, size=(p, 3)) * (np.array(GRID) - 1)
        c[::3, 1] = rng.integers(0, Y, size=len(c[::3]))
    return torch.from_numpy(c)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("case", ["random", "shared", "border"])
def test_neighbour_rule_matches_neighbor_anchors(k, case):
    p = 300
    coords = _coords(case, p)
    table = spconv.voxel_table_plain(coords, GRID)
    got = spconv.tap_neighbors_plain(coords, table, GRID, k)
    want = neighbor_anchors(coords, GRID, k)
    want = torch.where(want == p, torch.full_like(want, -1), want)
    assert got.shape == (p, k ** 3)
    assert torch.equal(got, want)


def test_voxel_table_keeps_the_highest_index():
    coords = torch.tensor([[1, 2, 3], [0, 0, 0], [1, 2, 3], [4, 9, 5],
                           [1, 2, 3], [0, 0, 0]])
    table = spconv.voxel_table_plain(coords, GRID)
    X, Y, Z = GRID
    flat = lambda c: (c[0] * Y + c[1]) * Z + c[2]  # noqa: E731
    assert table.dtype == torch.int32 and table.shape == (X * Y * Z,)
    assert table[flat((1, 2, 3))] == 4
    assert table[flat((0, 0, 0))] == 5
    assert table[flat((4, 9, 5))] == 3
    assert int((table >= 0).sum()) == 3


def test_neighbour_rule_on_clamped_anchors():
    """Anchors outside pc_range are clamped into the grid by
    ``voxel_indices``; the rule still equals ``neighbor_anchors`` there."""
    gen = torch.Generator().manual_seed(3)
    lo = torch.tensor(PC_RANGE[:3])
    span = torch.tensor(PC_RANGE[3:]) - lo
    xyz = lo + (torch.rand(200, 3, generator=gen) * 1.4 - 0.2) * span
    coords, shape = voxel_indices(xyz, PC_RANGE, (10.0, 10.0, 2.0))
    table = spconv.voxel_table_plain(coords, shape)
    got = spconv.tap_neighbors_plain(coords, table, shape, 5)
    want = neighbor_anchors(coords, shape, 5)
    assert torch.equal(got, torch.where(want == 200,
                                        torch.full_like(want, -1), want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_table_plain_conv_is_the_gather_form(dtype):
    gen = torch.Generator().manual_seed(1)
    p, cin, cout = 150, 32, 64
    coords = _coords("shared", p, seed=2)
    feats = torch.randn(p, cin, generator=gen)
    w = torch.randn(cout, 3, 3, 3, cin, generator=gen) * 0.1
    bias = torch.randn(cout, generator=gen)
    table = spconv.voxel_table_plain(coords, GRID)
    got = spconv.submanifold_conv3d_table_plain(feats, coords, table, GRID,
                                                w, bias, compute_dtype=dtype)
    want = submanifold_conv3d(feats, neighbor_anchors(coords, GRID, 3), w,
                              bias, compute_dtype=dtype)
    assert torch.equal(got, want)


def _conv_args(cin=128, cout=128, k=5, requires_grad=False):
    w = torch.zeros(cout, k, k, k, cin, requires_grad=requires_grad)
    b = torch.zeros(cout, requires_grad=requires_grad)
    return w, b


@pytest.mark.parametrize("case,want", [
    ("fused", None), ("fp32", "dtype"), ("grad_weight", "grad"),
    ("grad_features", "grad"), ("no_grad_mode", None),
    ("c_in_48", "shape"), ("c_out_40", "shape"), ("k_4", "shape"),
    ("c_out_288", None), ("c_in_512", None),
    ("cpu", "device")])
def test_why_not_fused(case, want):
    """The dispatch rule, case by case (the device last, so that the CPU
    reaches each other reason)."""
    feats = torch.zeros(10, 128)
    w, b = _conv_args(requires_grad=case in ("grad_weight",
                                             "no_grad_mode"))
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    if case == "grad_features":
        feats.requires_grad_(True)
    if case == "c_in_48":
        w, b = _conv_args(cin=48)
        feats = torch.zeros(10, 48)
    if case == "c_out_40":
        w, b = _conv_args(cout=40)
    if case == "c_out_288":
        w, b = _conv_args(cout=288)
    if case == "c_in_512":
        w, b = _conv_args(cin=512)
        feats = torch.zeros(10, 512)
    if case == "k_4":
        w, b = _conv_args(k=4)

    class Cuda(torch.Tensor):
        """A CPU tensor that reports itself on the card, so that the rule's
        other conditions can be reached here."""
        @property
        def is_cuda(self):
            return case != "cpu"

    feats = feats.as_subclass(Cuda)
    with torch.set_grad_enabled(case != "no_grad_mode"):
        assert spconv.why_not_fused(feats, [w], [b], dtype) == want


def _module(multi, dtype, seed=0):
    torch.manual_seed(seed)
    m = SparseConv3DModule(in_channels=32, embed_channels=32,
                           pc_range=PC_RANGE, grid_size=(10.0, 10.0, 2.0),
                           dtype=dtype, use_multi_layer=multi)
    for c in m.modules():
        if isinstance(c, SubMConv3d):
            torch.nn.init.normal_(c.weight, std=0.05)
            if c.bias is not None:
                torch.nn.init.normal_(c.bias, std=0.1)
    return m


def _inputs(b=2, p=70, seed=0):
    gen = torch.Generator().manual_seed(seed)
    feat = torch.randn(b, p, 32, generator=gen)
    # anchors in [0, 1] logit-free space; a few share voxels
    anchor = torch.rand(b, p, 11, generator=gen)
    anchor[:, ::5, :3] = anchor[:, 1::5, :3][:, :anchor[:, ::5].shape[1]]
    return feat, anchor


def _gather_forward(m, instance_feature, anchor):
    """The module's forward as the gather form runs it."""
    xyz = cartesian(anchor[..., :3], m.pc_range)
    coords, shape = voxel_indices(xyz, m.pc_range, m.grid_size)
    outs = []
    for bi in range(instance_feature.shape[0]):
        nb = neighbor_anchors(coords[bi], shape, m.kernel_size)
        x = instance_feature[bi]
        if m.use_multi_layer:
            for i in range(0, len(m.layer), 3):
                x = submanifold_conv3d(x, nb, m.layer[i].weight,
                                       m.layer[i].bias,
                                       compute_dtype=m.layer[i].dtype)
                x = torch.relu(m.layer[i + 1](x))
        else:
            x = submanifold_conv3d(x, nb, m.layer.weight, m.layer.bias,
                                   compute_dtype=m.layer.dtype)
        outs.append(x)
    return m.output_proj(torch.stack(outs))


@pytest.mark.parametrize("multi", [True, False])
@pytest.mark.parametrize("case", ["cpu_inference", "grad", "fp32"])
def test_module_keeps_the_gather_bits(multi, case):
    """On the CPU, under autograd and in fp32 the module runs the gather
    form, bit for bit, and its gradients flow."""
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    m = _module(multi, dtype)
    feat, anchor = _inputs()
    if case == "grad":
        feat.requires_grad_(True)
        got = m(feat, anchor)
        got.sum().backward()
        convs = [c for c in m.modules() if isinstance(c, SubMConv3d)]
        assert feat.grad is not None
        assert all(c.weight.grad is not None for c in convs)
        want = _gather_forward(m, feat, anchor)
    else:
        with torch.inference_mode():
            got = m(feat, anchor)
            want = _gather_forward(m, feat, anchor)
    assert torch.equal(got, want)


@pytest.mark.parametrize("multi", [True, False])
def test_module_fused_route_builds_one_table_a_call(monkeypatch, multi):
    """The kernel's route with its two launches replaced by their plain
    versions: one table per batch element shared by every conv of the call,
    int32 coordinates, and the gather form's bits."""
    calls = {"table": 0, "conv": 0}

    def table(coords, shape):
        assert coords.dtype == torch.int32 and coords.is_contiguous()
        calls["table"] += 1
        return spconv.voxel_table_plain(coords, shape)

    def conv(x, coords, tab, shape, weight, bias=None):
        calls["conv"] += 1
        return spconv.submanifold_conv3d_table_plain(x, coords, tab, shape,
                                                     weight, bias)

    monkeypatch.setattr(spconv, "why_not_fused", lambda *a: None)
    monkeypatch.setattr(spconv, "voxel_table_cuda", table)
    monkeypatch.setattr(spconv, "submanifold_conv3d_cuda", conv)
    m = _module(multi, torch.bfloat16, seed=4)
    feat, anchor = _inputs(b=2, seed=5)
    with torch.inference_mode():
        got = m(feat, anchor)
        want = _gather_forward(m, feat, anchor)
    assert calls == {"table": 2, "conv": 2 * (3 if multi else 1)}
    assert torch.equal(got, want)
