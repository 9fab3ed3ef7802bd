"""The lifters in plain PyTorch.

``GaussianLifterV2`` (GaussianFormer-2): a second tower's stride-8 map, a
depth distribution over ``num_samples`` bins and a no-hit bin per pixel,
one depth drawn per pixel by inverse-CDF sampling, the points that are
disabled or outside the range replaced by jittered copies of random valid
ones, then farthest-point sampling of ``num_anchor`` of them; learnt
scale, rotation, opacity and semantics, and ``random_samples`` learnt
anchors appended. ``GaussianLifter`` (v1): a learnt bank of anchors.
Parameter names are the program's."""
from __future__ import annotations

import torch
from torch import nn

from .precision import REFERENCE, Precision
from .towers import ResNetSecondFPN

EPS = torch.finfo(torch.float32).eps


def inverse_sigmoid(x):
    x = x.clamp(1e-4, 0.9999)
    return torch.log(x / (1.0 - x))


def farthest_point_sampling(points, num_samples: int,
                            prec: Precision = REFERENCE):
    """[N, 3] -> [num_samples] int64: start at index 0, then each time the
    point farthest (squared distance) from those taken, the first index
    among ties."""
    pts = prec.elementwise(points)
    x, y, z = pts.unbind(-1)
    dist = torch.full_like(x, float("inf"))
    sel = torch.empty(num_samples, dtype=torch.long, device=points.device)
    last = torch.zeros((), dtype=torch.long, device=points.device)
    sel[0] = last
    for i in range(1, num_samples):
        d = (x - x[last]) ** 2 + (y - y[last]) ** 2 + (z - z[last]) ** 2
        dist = torch.minimum(dist, d)
        last = torch.argmax(dist)
        sel[i] = last
    return sel


class GaussianLifterV2(nn.Module):
    def __init__(self, c, prec: Precision = REFERENCE,
                 checkpoint: bool = False):
        super().__init__()
        self.prec = prec
        self.num_anchor = c["num_anchor"]
        self.num_samples = c["num_depth_samples"]
        self.pc_range = tuple(c["pc_range"])
        self.voxel_size = c["grid"]["grid_size"]
        self.occ_resolution = (c["grid"]["H"], c["grid"]["W"],
                               c["grid"]["D"])
        self.empty_label = c["empty_label"]
        self.depth_min, self.depth_max = 1.0, 72.0
        out = tuple(c["initializer_out_channels"])
        self.initialize_backbone = ResNetSecondFPN(
            c["depth"], c["stage_with_dcn"], c["base_channels"], out, prec,
            checkpoint)
        self.projection = nn.Sequential(nn.ReLU(), nn.Linear(
            sum(out), self.num_samples + 1))
        rest = 3 + 4 + 1 + c["semantic_dim"]
        self.anchor = nn.Parameter(torch.zeros(self.num_anchor, rest))
        self.random_anchors = nn.Parameter(
            torch.zeros(c["random_samples"], 3 + rest))
        self.instance_feature = nn.Parameter(
            torch.zeros(self.num_anchor + c["random_samples"],
                        c["embed_dims"]))

    def rays(self, projection_mat, image_wh, h, w):
        """Per pixel of the h x w map: the ray's origin and direction in
        the lidar frame, x(d) = origin + d * dir."""
        # the program's own sequence of operations: FPS picks the farthest
        # point, so the candidates have to match to the last bit
        dev = projection_mat.device
        inv = torch.linalg.inv_ex(projection_mat).inverse
        u = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
        v = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
        uv = torch.stack([u[None, :].expand(h, w), v[:, None].expand(h, w)],
                         -1)[None, None] * image_wh[:, :, None, None]
        uv1 = torch.cat([uv, torch.ones_like(uv[..., :1])], -1)
        ray_dir = torch.einsum("bnij,bnhwj->bnhwi", inv[..., :3, :3], uv1)
        return inv[..., :3, 3][:, :, None, None], ray_dir

    def pixel_logits(self, imgs):
        """(the tower's map [B * N, C, h, w], the depth logits
        [B, N, h, w, S + 1])."""
        b, n = imgs.shape[:2]
        feat = self.initialize_backbone(
            imgs.reshape((b * n,) + imgs.shape[2:]).permute(0, 3, 1, 2))
        return feat, self.logits(feat, b)

    def logits(self, feat, b):
        """The depth logits [B, N, h, w, S + 1] of the tower's map."""
        feat = feat.permute(0, 2, 3, 1).reshape(b, -1, *feat.shape[2:4],
                                                feat.shape[1])
        with self.prec.matmul():
            return self.projection(feat)

    def pixel_gt(self, origin, ray_dir, occ_label, occ_cam_mask):
        """[B, N, h, w, S + 1] bool: the depth bins whose point lies in an
        occupied, camera-visible voxel inside the range, then no-hit."""
        b = occ_label.shape[0]
        occ = ((occ_label != self.empty_label) & occ_cam_mask.bool())
        bins = torch.linspace(self.depth_min, self.depth_max,
                              self.num_samples, device=occ_label.device)
        pts = origin[..., None, :] + ray_dir[..., None, :] * bins[:, None]
        lo = torch.tensor(self.pc_range[:3], device=pts.device)
        hi = torch.tensor(self.pc_range[3:], device=pts.device)
        res = torch.tensor(self.occ_resolution, device=pts.device)
        inside = ((pts >= lo) & (pts < hi)).all(-1)
        vox = ((pts - lo) / self.voxel_size).to(torch.int32).long()
        vox = torch.minimum(vox.clamp_min(0), res - 1)
        hit = torch.stack([occ[i][vox[i, ..., 0], vox[i, ..., 1],
                               vox[i, ..., 2]] for i in range(b)])
        hit = hit & inside
        return torch.cat([hit, ~hit.any(-1, keepdim=True)], -1)

    def candidates(self, logits, origin, ray_dir, draws):
        """The points FPS chooses from, [B, n*h*w, 3], drawn from
        ``logits`` with ``draws`` = (pick, noise, u) as the program's
        ``GaussianLifterV2.draw`` makes them."""
        pick, noise, u = draws
        b = logits.shape[0]
        lo = torch.tensor(self.pc_range[:3], device=logits.device)
        hi = torch.tensor(self.pc_range[3:], device=logits.device)
        pdf = torch.softmax(self.prec.elementwise(logits.detach()),
                            -1).float()
        cdf = torch.cumsum(pdf / (EPS + pdf.sum(-1, keepdim=True)), -1)
        index = (cdf[..., None, :] <= u[..., :, None]).sum(-1).clamp(
            0, self.num_samples)
        disable = (pdf.argmax(-1, keepdim=True) == self.num_samples)
        bins = torch.linspace(self.depth_min, self.depth_max,
                              self.num_samples, device=logits.device)
        depth = bins[index.clamp(0, self.num_samples - 1)]
        cand = (origin[..., None, :] + ray_dir[..., None, :]
                * depth[..., None]).reshape(b, -1, 3)
        valid = ~disable.reshape(b, -1) & ~((cand < lo) | (cand >= hi)).any(-1)
        out = []
        for i in range(b):
            order = torch.argsort((~valid[i]).to(torch.uint8), stable=True)
            count = valid[i].sum().clamp_min(1)
            repl = cand[i][order[pick[i] % count]] + noise[i]
            repl = torch.minimum(torch.maximum(repl, lo), hi)
            out.append(torch.where(valid[i][:, None], cand[i], repl))
        return torch.stack(out)

    def anchors_xyz(self, cand):
        """FPS of ``num_anchor`` points of each batch element, as anchor
        logits [B, num_anchor, 3]."""
        lo = torch.tensor(self.pc_range[:3], device=cand.device)
        hi = torch.tensor(self.pc_range[3:], device=cand.device)
        xyz = torch.stack([
            cand[i][farthest_point_sampling(cand[i], self.num_anchor,
                                            self.prec)]
            for i in range(cand.shape[0])])
        return inverse_sigmoid((xyz - lo) / (hi - lo))

    def representation(self, xyz):
        b = xyz.shape[0]
        anchor = torch.cat([xyz, self.anchor[None].expand(b, -1, -1)], -1)
        anchor = torch.cat([anchor, self.random_anchors[None].expand(
            b, -1, -1)], 1)
        return anchor, self.instance_feature[None].expand(b, -1, -1)


class GaussianLifter(nn.Module):
    def __init__(self, c):
        super().__init__()
        sem = c["semantic_dim"]
        self.anchor = nn.Parameter(torch.zeros(
            c["num_anchor"], 10 + int(c["include_opa"]) + sem))
        self.instance_feature = nn.Parameter(torch.zeros(
            c["num_anchor"], c["embed_dims"]))

    def representation(self, b):
        return (self.anchor[None].expand(b, -1, -1),
                self.instance_feature[None].expand(b, -1, -1))
