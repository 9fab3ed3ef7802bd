"""The port's input pipeline against the JAX package's, on the CPU: the
native codec, the transforms, the nuScenes dataset on a tiny set written
to ``tmp_path``, the sampler and the loader. With the same numpy seeds
every array must be equal, dtypes included (the SurroundOcc loader's
labels: equal values, int32 where JAX's are int64 before the dataset's
cast). With worker processes the loader must give the same samples, and
each worker its own augmentations."""
import os
import shutil

import numpy as np
import pytest
import torch

from gaussianformer_tpu import native as jnative
from gaussianformer_tpu.data import dataset as jdataset
from gaussianformer_tpu.data import loader as jloader
from gaussianformer_tpu.data import transforms as JT
from gaussianformer_tpu.data.synthetic import \
    SyntheticOccDataset as JaxSynthetic

from gaussianformer_tpu_torch import native
from gaussianformer_tpu_torch.data import (DataLoader, NuScenesDataset,
                                           ShardedSampler,
                                           SyntheticOccDataset)
from gaussianformer_tpu_torch.data import transforms as T
from gaussianformer_tpu_torch.data.synthetic import write_nuscenes_files

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
# the tiny set's images and the augmentation of the dataset tests
IMAGE = (90, 160)
SHIPPED_AUG = dict(H=90, W=160, final_dim=(64, 96), resize_lim=(1.0, 1.0),
                   rot_lim=(0.0, 0.0), rand_flip=True)
WIDE_AUG = dict(H=90, W=160, final_dim=(64, 96), resize_lim=(0.8, 1.2),
                bot_pct_lim=(0.0, 0.1), rot_lim=(-5.4, 5.4), rand_flip=True)


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def codec(request, monkeypatch):
    """The port's codec with its native library, then its numpy path."""
    if request.param:
        assert native.load() is not None, "g++ build of the codec failed"
    else:
        monkeypatch.setattr(native, "load", lambda: None)
    return request.param


def test_decode_occupancy_matches_numpy_and_jax(codec):
    rng = np.random.RandomState(0)
    k = 700
    rec = np.stack([rng.randint(-2, 22, k), rng.randint(0, 20, k),
                    rng.randint(0, 9, k), rng.randint(0, 18, k)], -1)
    label, mask = native.decode_occupancy(rec, (20, 20, 8), 17)
    ok = ((rec[:, 0] >= 0) & (rec[:, 0] < 20) & (rec[:, 2] < 8))
    ref = np.full((20, 20, 8), 17, np.int32)
    ref[rec[ok, 0], rec[ok, 1], rec[ok, 2]] = rec[ok, 3]
    jlabel, jmask = jnative.decode_occupancy(rec, (20, 20, 8), 17)
    assert label.dtype == np.int32 and mask.dtype == np.uint8
    np.testing.assert_array_equal(label, ref)
    np.testing.assert_array_equal(mask, (ref != 0).astype(np.uint8))
    np.testing.assert_array_equal(label, jlabel)
    np.testing.assert_array_equal(mask, jmask)


def test_normalize_image_matches_numpy_and_jax(codec):
    img = np.random.RandomState(1).randint(0, 256, (16, 24, 3), np.uint8)
    got = native.normalize_image(img, MEAN, STD)
    want = (img.astype(np.float32) - np.asarray(MEAN, np.float32)) \
        * (1.0 / np.asarray(STD, np.float32))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.normalize_image(img, MEAN,
                                                               STD))


def test_meshgrid_matches_numpy_and_jax(codec):
    got = native.occ_meshgrid_native((-5.0, -5.0, -1.0), (10, 12, 4), 0.5)
    np.testing.assert_array_equal(
        got, jnative.occ_meshgrid_native((-5.0, -5.0, -1.0), (10, 12, 4),
                                         0.5))
    np.testing.assert_allclose(
        got, T.occ_meshgrid((-5.0, -5.0, -1.0, 0.0, 1.0, 1.0), (10, 12, 4),
                            0.5), atol=1e-6)


def test_occ_meshgrid_equal():
    for args in [(), ((0.0, -25.6, -2.0, 51.2, 25.6, 4.4), (256, 256, 32),
                      0.2)]:
        got, ref = T.occ_meshgrid(*args), JT.occ_meshgrid(*args)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("conf", [SHIPPED_AUG, WIDE_AUG,
                                  dict(H=900, W=1600, final_dim=(864, 1600),
                                       resize_lim=(1.0, 1.0))])
def test_sample_augmentation_and_matrix_equal(conf, test_mode):
    for seed in range(6):
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(3):
            got = T.sample_augmentation(r1, test_mode=test_mode, **conf)
            ref = JT.sample_augmentation(r2, test_mode=test_mode, **conf)
            assert dataclasses_equal(got, ref)
            np.testing.assert_array_equal(T.img_transform_matrix(got),
                                          JT.img_transform_matrix(ref))
        assert r1.randint(2 ** 31) == r2.randint(2 ** 31)


def dataclasses_equal(a, b) -> bool:
    return vars(a) == vars(b)


@pytest.mark.parametrize("conf", [SHIPPED_AUG, WIDE_AUG])
def test_resize_crop_flip_equal(conf):
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 256, IMAGE + (3,), np.uint8) for _ in range(6)]
    l2i = rng.randn(6, 4, 4)
    for seed in range(4):
        aug = T.sample_augmentation(np.random.RandomState(seed), **conf)
        got = T.resize_crop_flip(imgs, aug, l2i)
        ref = JT.resize_crop_flip(imgs, aug, l2i)
        for g, r in zip(got[0], ref[0]):
            assert g.dtype == r.dtype == np.uint8 and g.shape == (64, 96, 3)
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]


def test_photometric_distortion_equal():
    """Every branch of the reference's gates (16 seeds) on uint8 and float
    inputs; the streams end in the same state."""
    img = np.random.RandomState(4).randint(0, 256, (12, 20, 3), np.uint8)
    for seed in range(16):
        for src in (img, img.astype(np.float32) * 1.1 - 10):
            r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
            got = T.photometric_distortion(src, r1)
            ref = JT.photometric_distortion(src, r2)
            assert got.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
            assert r1.randint(2 ** 31) == r2.randint(2 ** 31)


def test_normalize_images_equal():
    rng = np.random.RandomState(5)
    u8 = [rng.randint(0, 256, (8, 12, 3), np.uint8) for _ in range(3)]
    f32 = [rng.rand(8, 12, 3).astype(np.float32) * 300 - 20
           for _ in range(3)]
    for imgs in (u8, f32):
        got = T.normalize_images(imgs, MEAN, STD)
        ref = JT.normalize_images(imgs, MEAN, STD)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_label_loaders_equal(tmp_path):
    rng = np.random.RandomState(6)
    cells = rng.choice(200 * 200 * 16, 3000, replace=False)
    rec = np.concatenate([np.stack(np.unravel_index(cells, (200, 200, 16)),
                                   -1), rng.randint(0, 17, (3000, 1))], -1)
    np.save(tmp_path / "s.npy", rec)
    got = T.load_occupancy_surroundocc(str(tmp_path / "s.npy"))
    ref = JT.load_occupancy_surroundocc(str(tmp_path / "s.npy"))
    assert got[0].dtype == np.int32 and ref[0].dtype == np.int64
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert got[1].dtype == ref[1].dtype == np.bool_
    assert got[2].dtype == ref[2].dtype == np.float32

    kitti = rng.randint(0, 20, (256, 256, 32)).astype(np.uint8)
    kitti[rng.rand(*kitti.shape) < 0.2] = 255
    np.save(tmp_path / "k.npy", kitti)
    for kw in (dict(), dict(unknown_to_empty=True, training=True)):
        got = T.load_occupancy_kitti360(str(tmp_path / "k.npy"), **kw)
        ref = JT.load_occupancy_kitti360(str(tmp_path / "k.npy"), **kw)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("n_scan", [50, 4000])
def test_anchor_points_equal(tmp_path, n_scan):
    """Padding (fewer in-range points than asked for) and subsampling."""
    rng = np.random.RandomState(7)
    scan = rng.uniform(-60, 60, (n_scan, 5)).astype(np.float32)
    scan.tofile(tmp_path / "p.bin")
    np.save(tmp_path / "p.npy", scan[:, :3])
    pc = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    e2l = np.eye(4)
    e2l[:3, 3] = (0.5, -0.2, 1.0)
    got = T.load_points(str(tmp_path / "p.bin"), pc, 512,
                        np.random.RandomState(1))
    ref = JT.load_points(str(tmp_path / "p.bin"), pc, 512,
                         np.random.RandomState(1))
    assert got.shape == (512, 3) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    got = T.load_pseudo_points(str(tmp_path / "p.npy"), pc, 512, e2l,
                               np.random.RandomState(2))
    ref = JT.load_pseudo_points(str(tmp_path / "p.npy"), pc, 512, e2l,
                                np.random.RandomState(2))
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def nuscenes_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nuscenes"))
    return write_nuscenes_files(root, num_samples=3, image_size=IMAGE,
                                num_labels=500, seed=0)


def datasets(paths, phase, conf, seed=0):
    pkl = os.path.join(paths["anno_root"],
                       f"nuscenes_infos_{phase}_sweeps_occ.pkl")
    args = (paths["data_root"], pkl, paths["occ_path"])
    kw = dict(data_aug_conf=conf, phase=phase, seed=seed)
    return NuScenesDataset(*args, **kw), jdataset.NuScenesDataset(*args, **kw)


def assert_samples_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == ref[k].dtype, k
        assert g.shape == ref[k].shape, k
        np.testing.assert_array_equal(g, ref[k], err_msg=k)


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("conf", [SHIPPED_AUG, WIDE_AUG],
                         ids=["shipped", "wide"])
def test_dataset_equal(nuscenes_set, phase, conf):
    """Every sample twice over (the shared RandomState's draws go on), with
    the camera geometry of the infos (poses, calibrations, intrinsics)."""
    ds, jds = datasets(nuscenes_set, phase, conf, seed=3)
    assert len(ds) == len(jds) == 3
    for _ in range(2):
        for i in range(len(ds)):
            assert_samples_equal(ds[i], jds[i])
    sample = ds[0]
    assert sample["imgs"].shape == (6, 64, 96, 3)
    assert sample["occ_label"].shape == (200, 200, 16)


def test_geometry_equal():
    rng = np.random.RandomState(8)
    for _ in range(5):
        calib = {"rotation": rng.randn(4), "translation": rng.randn(3),
                 "camera_intrinsic": [[500, 0, 80], [0, 500, 45], [0, 0, 1]]}
        pose = {"rotation": rng.randn(4), "translation": rng.randn(3) * 100}
        from gaussianformer_tpu_torch.data import dataset as pdataset
        np.testing.assert_array_equal(
            pdataset.get_img2global(calib, pose),
            jdataset.get_img2global(calib, pose))
        np.testing.assert_array_equal(
            pdataset.get_sensor2global(calib, pose),
            jdataset.get_sensor2global(calib, pose))


@pytest.mark.parametrize("num_samples,num_shards,shuffle,drop_last", [
    (10, 1, True, False), (10, 3, True, False), (11, 4, False, False),
    (11, 4, True, True)])
def test_sampler_equal(num_samples, num_shards, shuffle, drop_last):
    for shard in range(num_shards):
        kw = dict(shard_id=shard, num_shards=num_shards, shuffle=shuffle,
                  seed=5, drop_last=drop_last)
        s, js = ShardedSampler(num_samples, **kw), \
            jloader.ShardedSampler(num_samples, **kw)
        assert len(s) == len(js)
        for epoch in range(3):
            s.set_epoch(epoch)
            js.set_epoch(epoch)
            assert list(s) == list(js)
        s.set_last_iter(2)
        js.set_last_iter(2)
        assert list(s) == list(js)
        assert list(s) == list(js)    # the fast-forward is used once


@pytest.mark.parametrize("kind", ["nuscenes", "synthetic"])
def test_loader_equal_without_workers(nuscenes_set, kind):
    """num_workers=0: the JAX loader's batches in its order, across two
    epochs and a mid-epoch fast-forward, augmentation draws included."""
    if kind == "nuscenes":
        ds, jds = datasets(nuscenes_set, "train", WIDE_AUG, seed=1)
    else:
        ds = SyntheticOccDataset(3, 2, (16, 24), (8, 8, 4))
        jds = JaxSynthetic(3, 2, (16, 24), (8, 8, 4))
    dl = DataLoader(ds, 2, shuffle=True, seed=4, drop_last=False)
    jdl = jloader.DataLoader(jds, 2, shuffle=True, seed=4, drop_last=False)
    assert len(dl) == len(jdl) == 2
    for epoch in range(2):
        dl.sampler.set_epoch(epoch)
        jdl.sampler.set_epoch(epoch)
        got, ref = list(dl), list(jdl)
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            assert_samples_equal(g, r)
    dl.sampler.set_last_iter(2)
    jdl.sampler.set_last_iter(2)
    got, ref = list(dl), list(jdl)
    assert len(got) == len(ref) == 1
    assert_samples_equal(got[0], ref[0])


def test_loader_workers_draw_their_own_augmentations(nuscenes_set,
                                                     tmp_path):
    """Two worker processes over four frames that share one set of images
    (their labels differ): the same samples as without workers; the first
    frame of each worker, augmented from the same images, differs (a copy
    of one RandomState in both workers would draw the same); a new epoch
    draws new augmentations in the persistent workers."""
    root = str(tmp_path)
    paths = write_nuscenes_files(root, num_samples=4, image_size=IMAGE,
                                 num_labels=500, seed=1)
    for cam in os.listdir(os.path.join(root, "samples")):
        for i in range(1, 4):
            shutil.copy(os.path.join(root, "samples", cam, "frame0.png"),
                        os.path.join(root, "samples", cam, f"frame{i}.png"))
    ds, _ = datasets(paths, "train", WIDE_AUG, seed=2)
    sync = DataLoader(ds, 1, shuffle=False)
    pool = DataLoader(ds, 1, shuffle=False, num_workers=2)
    try:
        ref = list(sync)
        got = list(pool)
        assert len(got) == len(ref) == 4
        for g, r in zip(got, ref):
            assert torch.equal(g["occ_label"], r["occ_label"])
            assert g["imgs"].dtype == torch.float32
        # batches 0 and 1 are the first frames of workers 0 and 1
        assert not torch.equal(got[0]["imgs"], got[1]["imgs"])
        pool.sampler.set_epoch(1)
        again = list(pool)
        assert [torch.equal(a["occ_label"], b["occ_label"])
                for a, b in zip(again, got)] == [True] * 4
        assert not torch.equal(again[0]["imgs"], got[0]["imgs"])
    finally:
        pool.close()
