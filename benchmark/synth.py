"""Inputs and weights of a run, made on the device from ``--seed``.

The samples follow the synthetic nuScenes-shaped generator of the
GaussianFormer port (its own copy, frozen here): six cameras of normalised
N(0, 1) images at the configuration's input size, each camera a pinhole
with focal length 0.6 W turned by 60 degrees from the last, the 200 x 200
x 16 voxel centres as query points, and in each sample 2000-6000 distinct
occupied voxels of classes 1-16 in the lowest quarter of the grid (the
rest class 17, empty), 80% of the voxels visible to a camera. Every seed
gives the same shapes; only the values differ.

The weights are made by parameter name and shape: fan-in scaled normals
for conv and linear weights (a hundredth of that for the DCN offset
convs, so offsets are fractional and the bilinear paths run), unit norm
scales, zero biases, random BN statistics, N(0, 1) anchors and instance
features, the empty Gaussian's scalar at 10; the v1 anchor bank as GaussianFormer initialises it (xyz and
scales uniform in the unit cube through the inverse sigmoid, the identity
rotation, opacity 0.5, N(0, 1) semantics)."""
from __future__ import annotations

import math

import torch

#: seeds of the streams a run draws from (one generator each)
WEIGHTS, SAMPLES, DRAWS, DROPOUT, PICK = range(5)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + stream) % (2 ** 63))


def voxel_centres(c, device):
    g = c["grid"]
    lo = torch.tensor(g["pc_min"], dtype=torch.float32, device=device)
    idx = torch.stack(torch.meshgrid(
        torch.arange(g["H"], device=device), torch.arange(g["W"],
                                                          device=device),
        torch.arange(g["D"], device=device), indexing="ij"), -1)
    return lo + (idx.float() + 0.5) * g["grid_size"]


def cameras(c, device):
    """(projection_mat [cams, 4, 4], image_wh [cams, 2])."""
    h, w = c["input_size"]
    n = c["num_cams"]
    f = 0.6 * w
    mats = []
    for i in range(n):
        intr = torch.tensor([[f, 0, w / 2, 0], [0, f, h / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.float32)
        a = 2 * math.pi * i / n
        rot = torch.eye(4)
        rot[:3, :3] = torch.tensor([[math.cos(a), -math.sin(a), 0],
                                    [0, 0, -1],
                                    [math.sin(a), math.cos(a), 0]])
        mats.append(intr @ rot)
    wh = torch.tensor([[w, h]] * n, dtype=torch.float32)
    return torch.stack(mats).to(device), wh.to(device)


def samples(c, count: int, seed: int, device, labels: bool, batch: int = 1):
    """``count`` samples of ``batch`` each, as a list of dicts with imgs
    [batch, cams, H, W, 3], projection_mat, image_wh, occ_xyz [batch, X,
    Y, Z, 3] and, with ``labels``, occ_label and occ_cam_mask [batch, X,
    Y, Z]."""
    gen = generator(seed, SAMPLES, device)
    h, w = c["input_size"]
    n = c["num_cams"]
    imgs = torch.randn((count, batch, n, h, w, 3), generator=gen,
                       device=device)
    proj, wh = cameras(c, device)
    xyz = voxel_centres(c, device)
    g = c["grid"]
    shape = (g["H"], g["W"], g["D"])
    out = []
    for i in range(count):
        s = {"imgs": imgs[i], "projection_mat": proj.repeat(batch, 1, 1, 1),
             "image_wh": wh.repeat(batch, 1, 1),
             "occ_xyz": xyz.repeat(batch, 1, 1, 1, 1)}
        if labels:
            labs = [grid_labels(c, shape, gen, device) for _ in range(batch)]
            s["occ_label"] = torch.stack([lab for lab, _ in labs])
            s["occ_cam_mask"] = torch.stack([mask for _, mask in labs])
        out.append(s)
    return out


def grid_labels(c, shape, gen, device):
    """(labels, camera mask) of one sample's grid."""
    k = int(torch.randint(2000, 6000, (1,), generator=gen, device=device))
    low = (shape[0], shape[1], max(shape[2] // 4, 1))
    lab = torch.full(shape, c["num_classes"] - 1, dtype=torch.int64,
                     device=device)
    # distinct voxels, so that no write order decides a label
    pos = torch.randperm(math.prod(low), generator=gen, device=device)[:k]
    lab[pos // (low[1] * low[2]), pos // low[2] % low[1],
        pos % low[2]] = torch.randint(1, c["num_classes"] - 1, pos.shape,
                                      generator=gen, device=device)
    return lab, torch.rand(shape, generator=gen, device=device) > 0.2


def lifter_draws(c, count: int, seed: int, device, batch: int = 1):
    """Per frame the GaussianFormer-2 lifter's draws, as the program's
    ``GaussianLifterV2.draw`` orders them: (a candidate pick per slot,
    N(0, 0.1) jitter, the depth sampling's uniforms)."""
    gen = generator(seed, DRAWS, device)
    h, w = c["input_size"]
    n = c["num_cams"]
    cand = n * (h // 8) * (w // 8)
    return [(torch.randint(0, cand, (batch, cand), generator=gen,
                           device=device),
             torch.randn((batch, cand, 3), generator=gen,
                         device=device) * 0.1,
             torch.rand((batch, n, h // 8, w // 8, 1), generator=gen,
                        device=device))
            for _ in range(count)]


def make_state(shapes, c, seed: int, device):
    """A state dict for the named ``shapes`` (name -> shape, the reference
    model's parameters and BN statistics), from ``seed`` on ``device``, in
    two draws (normals, uniforms) sliced by name in sorted order."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    gen = generator(seed, WEIGHTS, device)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    state, at = {}, 0
    for name, size in zip(names, sizes):
        shape = shapes[name]
        z = normal[at:at + size].reshape(shape)
        u = uniform[at:at + size].reshape(shape)
        at += size
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            t = z * 0.1
        elif leaf == "running_var":
            t = u + 0.5
        elif name == "head.empty_scalar":
            # GaussianFormer's own init, which the program keeps
            t = torch.full(shape, 10.0, device=device)
        elif len(shape) == 1:
            t = torch.full(shape, 1.0 if leaf in ("weight", "scale") else 0.0,
                           device=device)
        elif name == "lifter.anchor" and c["version"] == 1:
            t = bank(u, z, c)
        elif name.startswith("lifter.") and leaf in (
                "anchor", "random_anchors", "instance_feature"):
            t = z.clone()
        else:
            std = (0.01 if "conv_offset" in name else 1.0) \
                / math.sqrt(size / shape[0])
            t = z * std
        state[name] = t.contiguous()
    return state


def bank(u, z, c):
    """The v1 anchor bank [P, 10 + opacity + semantics]."""
    p = u.shape[0]
    logit = torch.log(u[:, :6].clamp(1e-4, 0.9999)
                      / (1 - u[:, :6].clamp(1e-4, 0.9999)))
    rot = torch.zeros(p, 4, device=u.device)
    rot[:, 0] = 1.0
    parts = [logit, rot]
    if c["include_opa"]:
        parts.append(torch.zeros(p, 1, device=u.device))
    parts.append(z[:, :c["semantic_dim"]])
    return torch.cat(parts, -1)
