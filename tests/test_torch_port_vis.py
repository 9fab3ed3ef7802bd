"""The port's renderers (``gaussianformer_tpu_torch/utils/vis.py``, its own
copy of ``gaussianformer_tpu/utils/vis.py``) against the JAX package's on
identical numpy input: the same pixels, each rendered to a PNG at the
renderers' fixed dpi and read back. The visualize CLI
(``python -m gaussianformer_tpu_torch.visualize``) runs the tiny config on
synthetic frames on the CPU and writes its four files a frame."""
import os

import matplotlib.image
import numpy as np
import pytest

from gaussianformer_tpu.utils import vis as jax_vis

from gaussianformer_tpu_torch import visualize
from gaussianformer_tpu_torch.utils import vis


def _pixels(path):
    return matplotlib.image.imread(path)


def _gaussians(n=40, seed=0):
    rng = np.random.RandomState(seed)
    means = np.stack([rng.uniform(-50, 50, n), rng.uniform(-50, 50, n),
                      rng.uniform(-5, 3, n)], -1).astype(np.float32)
    scales = rng.uniform(0.5, 6.0, (n, 3)).astype(np.float32)
    rots = rng.standard_normal((n, 4)).astype(np.float32)
    sem = rng.standard_normal((n, 18)).astype(np.float32)
    opa = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    return means, scales, rots, sem, opa


@pytest.mark.parametrize("view", ["topdown", "scatter3d"])
def test_save_occ_pixels_match_jax(tmp_path, view):
    rng = np.random.RandomState(1)
    occ = np.full((40, 40, 8), 17, np.int64)
    mask = rng.rand(*occ.shape) < 0.15
    occ[mask] = rng.randint(0, 17, mask.sum())
    a = vis.save_occ(str(tmp_path / "port.png"), occ, view=view, title="t")
    b = jax_vis.save_occ(str(tmp_path / "jax.png"), occ, view=view,
                         title="t")
    got, ref = _pixels(a), _pixels(b)
    assert got.shape == ref.shape and np.array_equal(got, ref)
    assert len(np.unique(got.reshape(-1, got.shape[-1]), axis=0)) > 2


def test_save_gaussian_topdown_pixels_match_jax(tmp_path):
    means, scales, _, sem, opa = _gaussians()
    a = vis.save_gaussian_topdown(str(tmp_path / "port.png"), means, scales,
                                  sem, opacities=opa)
    b = jax_vis.save_gaussian_topdown(str(tmp_path / "jax.png"), means,
                                      scales, sem, opacities=opa)
    assert np.array_equal(_pixels(a), _pixels(b))


def test_save_gaussian_pixels_match_jax(tmp_path):
    """The 3D ellipsoids: the port turns the quaternions into rotations
    with its own ``ops/rotation.py``, the JAX package with its jnp twin."""
    means, scales, rots, sem, opa = _gaussians(n=30, seed=2)
    a = vis.save_gaussian(str(tmp_path / "port.png"), means, scales, rots,
                          sem, opacities=opa)
    b = jax_vis.save_gaussian(str(tmp_path / "jax.png"), means, scales,
                              rots, sem, opacities=opa)
    assert np.array_equal(_pixels(a), _pixels(b))


def test_visualize_cli_writes_four_files_a_frame(tmp_path):
    work = str(tmp_path / "work")
    written = visualize.main(["--config", "prob_gs6400_tiny", "--work-dir",
                              work, "--synthetic", "--num-samples", "2",
                              "--device", "cpu"])
    names = sorted(os.listdir(os.path.join(work, "vis")))
    assert names == sorted(f"frame{i:04d}_{s}.png" for i in range(2)
                           for s in ("pred", "gt", "gaussians",
                                     "gaussians3d"))
    assert sorted(map(os.path.basename, written)) == names
    for path in written:
        px = _pixels(path)
        assert len(np.unique(px.reshape(-1, px.shape[-1]), axis=0)) > 1, path


def test_renderers_without_matplotlib(tmp_path, monkeypatch):
    """On a host without matplotlib (the card's) the same views are drawn
    with PIL and numpy: the top-down occupancy is each column's colour, 4
    pixels a voxel; the isometric views and the ellipses are PNGs of more
    than one colour."""
    monkeypatch.setattr(vis, "_pyplot", lambda: None)
    rng = np.random.RandomState(3)
    occ = np.full((40, 30, 8), 17, np.int64)
    mask = rng.rand(*occ.shape) < 0.1
    occ[mask] = rng.randint(0, 17, mask.sum())
    top = _pixels(vis.save_occ(str(tmp_path / "top.png"), occ))
    want = np.repeat(np.repeat(np.rot90(vis._topdown(occ, 17)), 4, 0), 4, 1)
    assert top.shape == want.shape
    assert np.abs(top - want).max() <= 0.5 / 255 + 1e-6
    means, scales, rots, sem, opa = _gaussians()
    for path in (vis.save_occ(str(tmp_path / "iso.png"), occ,
                              view="scatter3d"),
                 vis.save_gaussian_topdown(str(tmp_path / "ell.png"), means,
                                           scales, sem, opacities=opa),
                 vis.save_gaussian(str(tmp_path / "3d.png"), means, scales,
                                   rots, sem, opacities=opa)):
        px = _pixels(path)
        assert len(np.unique(px.reshape(-1, px.shape[-1]), axis=0)) > 2, path
