"""The Gaussian encoder in plain PyTorch: anchor embedding, FFN,
deformable multi-camera aggregation, submanifold sparse conv and the v1 /
v2 refinement, driven by the config's operation order. Module and
parameter names are the program's.

Anchor layout: [xyz logits (3), scale logits (3), quaternion (4),
opacity logit (0|1), semantics (C)]. Dropout takes its uniforms from
``rand(shape)``, which the caller supplies (a replay of the draws the
program made, in their order).

With ``checkpoint`` the encoder runs each operation under
``torch.utils.checkpoint``: its autograd memory is recomputed in the
backward instead of held. An operation's dropout uniforms are drawn
before it runs and handed in, so that the recomputation reuses them. The
deformable sampling runs in pieces of :data:`CHUNK` anchors, each
recomputed in the backward whenever gradients are on (at 144,000 anchors
one block's samples alone would hold about 21 GB)."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from .precision import REFERENCE, Precision

CLAMP = 9.21
#: anchors a piece of the deformable sampling
CHUNK = 16384
#: how near (in normalised image coordinates) to an image's edge a key
#: point lies where whether it is seen turns on the last bits of its
#: projection
EDGE = 1e-5


def sigmoid(x):
    return torch.sigmoid(x.clamp(-CLAMP, CLAMP))


def inverse_sigmoid(x):
    x = x.clamp(1e-4, 0.9999)
    return torch.log(x / (1.0 - x))


def to_world(xyz_logits, pc_range):
    lo = torch.tensor(pc_range[:3], device=xyz_logits.device)
    hi = torch.tensor(pc_range[3:], device=xyz_logits.device)
    return sigmoid(xyz_logits) * (hi - lo) + lo


def to_logits(xyz, pc_range):
    lo = torch.tensor(pc_range[:3], device=xyz.device)
    hi = torch.tensor(pc_range[3:], device=xyz.device)
    return inverse_sigmoid((xyz - lo) / (hi - lo))


def rotation_matrix(quat):
    q = quat / quat.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def handing(draws):
    """A ``rand`` that hands out ``draws`` in order (None: no dropout)."""
    if draws is None:
        return None
    it = iter(draws)

    def rand(shape):
        t = next(it)
        if tuple(t.shape) != tuple(shape):
            raise RuntimeError(f"a draw of {tuple(t.shape)} handed out "
                               f"where {tuple(shape)} is asked for")
        return t
    return rand


def dropout(x, p, rand):
    if p <= 0.0 or rand is None:
        return x
    return torch.where(rand(x.shape) >= p, x / (1.0 - p),
                       torch.zeros_like(x))


class Gaussians(NamedTuple):
    means: torch.Tensor
    scales: torch.Tensor
    rotations: torch.Tensor
    opacities: torch.Tensor
    semantics: torch.Tensor


def linear_relu_ln(dims, in_loops, out_loops, input_dims=None):
    input_dims = input_dims or dims
    layers = []
    for _ in range(out_loops):
        for _ in range(in_loops):
            layers += [nn.Linear(input_dims, dims), nn.ReLU()]
            input_dims = dims
        layers.append(nn.LayerNorm(dims))
    return nn.Sequential(*layers)


class Scale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.scale


class SparseGaussian3DEncoder(nn.Module):
    def __init__(self, dims, semantic_dim, include_opa):
        super().__init__()
        self.include_opa = include_opa
        self.semantic_dim = semantic_dim
        self.xyz_fc = linear_relu_ln(dims, 1, 2, 3)
        self.scale_fc = linear_relu_ln(dims, 1, 2, 3)
        self.rot_fc = linear_relu_ln(dims, 1, 2, 4)
        if include_opa:
            self.opacity_fc = linear_relu_ln(dims, 1, 2, 1)
        self.semantics_fc = linear_relu_ln(dims, 1, 2, semantic_dim)
        self.output_fc = linear_relu_ln(dims, 1, 2)

    def forward(self, anchor):
        out = (self.xyz_fc(anchor[..., 0:3]) + self.scale_fc(anchor[..., 3:6])
               + self.rot_fc(anchor[..., 6:10]))
        s = 10
        if self.include_opa:
            out = out + self.opacity_fc(anchor[..., 10:11])
            s = 11
        out = out + self.semantics_fc(anchor[..., s:s + self.semantic_dim])
        return self.output_fc(out)


class AsymmetricFFN(nn.Module):
    def __init__(self, dims, hidden, drop, add_identity, in_channels):
        super().__init__()
        in_channels = in_channels or dims
        self.drop = drop
        self.add_identity = add_identity
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(in_channels, hidden), nn.ReLU()),
            nn.Linear(hidden, dims))
        self.identity_fc = (nn.Linear(in_channels, dims)
                            if add_identity and in_channels != dims
                            else nn.Identity())

    def draw_shapes(self, x):
        """The shapes of the uniforms the forward on ``x`` draws."""
        if self.drop <= 0.0:
            return []
        rows = tuple(x.shape[:-1])
        return [rows + (self.layers[0][0].out_features,),
                rows + (self.layers[1].out_features,)]

    def forward(self, x, rand=None):
        h = dropout(self.layers[0](x), self.drop, rand)
        out = dropout(self.layers[1](h), self.drop, rand)
        return self.identity_fc(x) + out if self.add_identity else out


class KeyPoints(nn.Module):
    def __init__(self, dims, num_learnable, fixed_scale, fix_scale,
                 pc_range, scale_range):
        super().__init__()
        self.num_learnable = num_learnable
        self.fixed_scale = fixed_scale
        self.register_buffer("fix_scale", torch.tensor(fix_scale,
                                                       dtype=torch.float32),
                             persistent=False)
        self.pc_range = tuple(pc_range)
        self.scale_range = tuple(scale_range)
        self.learnable_fc = nn.Linear(dims, num_learnable * 3)

    @property
    def num_pts(self):
        return self.fix_scale.shape[0] + self.num_learnable

    def forward(self, anchor, feat):
        b, p = anchor.shape[:2]
        learn = sigmoid(self.learnable_fc(feat).reshape(
            b, p, self.num_learnable, 3)) - 0.5
        offs = torch.cat([self.fix_scale[None, None].expand(b, p, -1, 3),
                          learn * self.fixed_scale], -2)
        lo, hi = self.scale_range
        offs = offs * (lo + (hi - lo) * sigmoid(anchor[..., None, 3:6]))
        rot = rotation_matrix(anchor[..., 6:10])
        # the rotation's transpose applied to each offset
        pts = (offs[..., :, None, :] * rot[:, :, None].transpose(-1, -2)
               ).sum(-1)
        return pts + to_world(anchor[..., :3], self.pc_range)[:, :, None]


def project(kp, projection_mat, image_wh):
    """Key points [B, P, K, 3] -> (normalised image coordinates
    [B, cams, P, K, 2], depth [B, cams, P, K])."""
    hom = torch.cat([kp, torch.ones_like(kp[..., :1])], -1)
    proj = (projection_mat[:, :, None, None] @ hom[:, None, ..., None]
            )[..., 0]
    depth = proj[..., 2]
    uv = proj[..., :2] / depth[..., None].clamp_min(1e-5)
    return uv / image_wh[:, :, None, None, :], depth


def aggregate(feature_maps, loc, weights, num_pts, prec: Precision):
    """:func:`bilinear_sum` in pieces of :data:`CHUNK` anchors, each
    recomputed in the backward where gradients are on."""
    step = CHUNK * num_pts
    outs = []
    for q0 in range(0, loc.shape[1], step):
        args = (feature_maps, loc[:, q0:q0 + step],
                weights[:, q0:q0 + step], num_pts, prec)
        if torch.is_grad_enabled():
            outs.append(_checkpoint(bilinear_sum, *args,
                                    use_reentrant=False))
        else:
            outs.append(bilinear_sum(*args))
    return torch.cat(outs, 1)


def bilinear_sum(feature_maps, loc, weights, num_pts, prec: Precision):
    """Bilinear samples (align_corners False; a location counts only
    strictly inside (0, 1)^2; corners outside the map add nothing) of each
    level at each location and camera, weighted per level and group and
    summed over cameras, levels and each anchor's key points.
    feature_maps per level [B, cams, H, W, C]; loc [B, Q, cams, 2];
    weights [B, Q, cams, L, G]. Returns [B, Q / num_pts, C]."""
    b, q, cams, _ = loc.shape
    groups = weights.shape[-1]
    loc = prec.elementwise(loc)
    weights = prec.elementwise(weights)
    inside = ((loc[..., 0] > 0) & (loc[..., 0] < 1) & (loc[..., 1] > 0)
              & (loc[..., 1] < 1))
    out = 0.0
    for lvl, fm in enumerate(feature_maps):
        fm = prec.elementwise(fm)
        _, _, h, w, c = fm.shape
        flat = fm.reshape(b * cams, h * w, c)
        px = loc[..., 0] * w - 0.5
        py = loc[..., 1] * h - 0.5
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        lx = px - x0
        ly = py - y0
        spread = torch.arange(px.numel(), device=loc.device).reshape(
            px.shape) % (h * w)
        samp = 0.0
        for dy, dx, cw in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                           (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
            yy = y0 + dy
            xx = x0 + dx
            ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1) \
                & inside
            # whole pixels: exact in any float type up to 256, so the
            # row index is formed in integers
            idx = (yy.clamp(0, h - 1).long() * w
                   + xx.clamp(0, w - 1).long())
            # a corner that adds nothing reads a pixel of its own, not the
            # border's: the backward's sum by index serialises on a row
            # that many samples read
            idx = torch.where(ok, idx, spread)
            cam = torch.arange(cams, device=loc.device)
            rows = (torch.arange(b, device=loc.device)[:, None, None] * cams
                    + cam) * (h * w)
            got = flat.reshape(-1, c)[(rows + idx).reshape(-1)].reshape(
                b, q, cams, c)
            samp = samp + got * (cw * ok)[..., None]
        wl = weights[:, :, :, lvl].repeat_interleave(c // groups, -1)
        out = out + (samp * wl).sum(2)
    return out.float().reshape(b, q // num_pts, num_pts, -1).sum(2)


class DeformableFeatureAggregation(nn.Module):
    def __init__(self, dims, num_cams, num_learnable, fixed_scale,
                 fix_scale, pc_range, scale_range, attn_drop, residual_mode,
                 prec: Precision = REFERENCE, groups=4, levels=4):
        super().__init__()
        self.prec = prec
        self.num_cams = num_cams
        self.groups = groups
        self.levels = levels
        self.attn_drop = attn_drop
        self.residual_mode = residual_mode
        self.kps_generator = KeyPoints(dims, num_learnable, fixed_scale,
                                       fix_scale, pc_range, scale_range)
        k = self.kps_generator.num_pts
        self.camera_encoder = linear_relu_ln(dims, 1, 2, 12)
        self.weights_fc = nn.Linear(dims, groups * levels * k)
        self.output_proj = nn.Linear(dims, dims)

    def edge_anchors(self, feat, anchor, projection_mat, image_wh):
        """[B, P] bool: the anchors with a key point in front of a camera
        within :data:`EDGE` of its image's edge. Such a point is seen or
        not by the last bits of its projection, and where it is one of few
        that an anchor's group sees, the anchor's output jumps with it."""
        uv, depth = project(self.kps_generator(anchor, feat),
                            projection_mat, image_wh)
        near = torch.minimum(uv.abs(), (1.0 - uv).abs()).amin(-1) < EDGE
        return (near & (depth > 1e-5)).any(-1).any(1)

    def draw_shapes(self, feat):
        """The shapes of the uniforms the forward on ``feat`` draws."""
        if self.attn_drop <= 0.0:
            return []
        b, p = feat.shape[:2]
        return [(b, p, self.num_cams, self.levels,
                 self.kps_generator.num_pts, self.groups)]

    def forward(self, feat, anchor, anchor_embed, feature_maps,
                projection_mat, image_wh, rand=None):
        b, p = feat.shape[:2]
        k = self.kps_generator.num_pts
        kp = self.kps_generator(anchor, feat)
        cam = self.camera_encoder(
            projection_mat[:, :, :3].reshape(b, self.num_cams, 12))
        wts = self.weights_fc((feat + anchor_embed)[:, :, None]
                              + cam[:, None]).reshape(
            b, p, self.num_cams, self.levels, k, self.groups)
        uv, depth = project(kp, projection_mat, image_wh)
        vis = ((depth > 1e-5) & (uv[..., 0] > 0) & (uv[..., 0] < 1)
               & (uv[..., 1] > 0) & (uv[..., 1] < 1))
        keep = None
        if rand is not None and self.attn_drop > 0:
            keep = (rand(wts.shape) > self.attn_drop).permute(
                0, 1, 4, 2, 3, 5)
        wts = wts.permute(0, 1, 4, 2, 3, 5)          # [B, P, K, cams, L, G]
        mask = vis.permute(0, 2, 3, 1)[..., None, None].expand(wts.shape)
        if keep is not None:
            mask = mask & keep
        # an anchor group that no camera sees gets zero weights
        none = mask.sum(dim=(2, 3, 4), keepdim=True) == 0
        wts = wts.masked_fill(~mask, float("-inf")).masked_fill(none, 0.0)
        wts = torch.softmax(wts.reshape(b, p, -1, self.groups), -2)
        wts = wts.reshape(mask.shape).masked_fill(none, 0.0).reshape(
            b, p * k, self.num_cams, self.levels, self.groups)
        loc = uv.permute(0, 2, 3, 1, 4).reshape(b, p * k, self.num_cams, 2)
        out = self.output_proj(aggregate(feature_maps, loc, wts, k,
                                         self.prec))
        if self.residual_mode == "cat":
            return torch.cat([out, feat], -1)
        return out


class SubMConv3d(nn.Module):
    """Weights [C_out, k, k, k, C_in] (spconv's layout)."""

    def __init__(self, cin, cout, k, bias, prec: Precision = REFERENCE):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.empty(cout, k, k, k, cin))
        if bias:
            self.bias = nn.Parameter(torch.zeros(cout))
        else:
            self.register_parameter("bias", None)

    def forward(self, x, neighbours):
        """x [P, C_in]; neighbours [P, k^3], the anchor in each tap's
        voxel or -1. Returns [P, C_out]."""
        p, cin = x.shape
        kkk = neighbours.shape[1]
        xq = self.prec.tower(x)
        wmat = self.prec.tower(self.weight).permute(1, 2, 3, 4, 0).reshape(
            kkk, cin, -1)
        # an empty tap reads the anchor's own row, zeroed: were it to read
        # one shared row, the backward's sum by index would serialise on it
        own = torch.arange(p, device=x.device)[:, None]
        safe = torch.where(neighbours < 0, own, neighbours)
        out = 0.0
        for t in range(0, kkk, 25):
            nb = neighbours[:, t:t + 25]
            cols = xq[safe[:, t:t + 25].reshape(-1)].reshape(p, -1, cin)
            cols = cols.masked_fill((nb < 0)[..., None], 0.0)
            out = out + cols.reshape(p, -1) @ wmat[t:t + 25].reshape(
                -1, wmat.shape[-1])
        return out if self.bias is None else out + self.bias


def neighbours(xyz, pc_range, grid_size, k):
    """[P, k^3]: for each anchor and tap of a k^3 stencil, the anchor in
    that voxel (the highest index where several share it) or -1. Voxels by
    truncation of (xyz - lo) / grid, clamped into the grid."""
    dev = xyz.device
    lo = torch.tensor(pc_range[:3], device=dev)
    gs = torch.tensor(grid_size, device=dev)
    shape = [int((pc_range[i + 3] - pc_range[i]) / float(grid_size[i]))
             for i in range(3)]
    top = torch.tensor([s - 1 for s in shape], device=dev)
    v = torch.minimum(((xyz - lo) / gs).to(torch.int32).long().clamp_min(0),
                      top)
    X, Y, Z = shape
    table = torch.full((X * Y * Z,), -1, dtype=torch.long, device=dev)
    table.scatter_reduce_(0, (v[:, 0] * Y + v[:, 1]) * Z + v[:, 2],
                          torch.arange(v.shape[0], device=dev), "amax")
    r = torch.arange(-(k // 2), k // 2 + 1, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3)
    nb = v[:, None] + offs
    ok = ((nb >= 0) & (nb <= top)).all(-1)
    flat = (nb[..., 0] * Y + nb[..., 1]) * Z + nb[..., 2]
    return torch.where(ok, table[flat.clamp(0, X * Y * Z - 1)],
                       torch.full_like(flat, -1))


class SparseConv3DModule(nn.Module):
    def __init__(self, dims, pc_range, grid_size, use_out_proj, multi_layer,
                 prec: Precision = REFERENCE, k=5):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.grid_size = tuple(grid_size)
        self.k = k
        self.multi_layer = multi_layer
        if multi_layer:
            layers = []
            for _ in range(3):
                layers += [SubMConv3d(dims, dims, k, True, prec),
                           nn.LayerNorm(dims), nn.ReLU()]
            self.layer = nn.Sequential(*layers)
        else:
            self.layer = SubMConv3d(dims, dims, k, False, prec)
        self.output_proj = (nn.Linear(dims, dims) if use_out_proj
                            else nn.Identity())

    def forward(self, feat, anchor):
        xyz = to_world(anchor[..., :3], self.pc_range)
        outs = []
        for i in range(feat.shape[0]):
            nb = neighbours(xyz[i], self.pc_range, self.grid_size, self.k)
            x = feat[i]
            if self.multi_layer:
                for j in range(0, len(self.layer), 3):
                    x = torch.relu(self.layer[j + 1](self.layer[j](x, nb)))
            else:
                x = self.layer(x, nb)
            outs.append(x)
        return self.output_proj(torch.stack(outs))


class RefineV2(nn.Module):
    """World-space step of at most ``unit_xyz`` on the mean; scale,
    rotation, opacity and semantics replaced."""

    def __init__(self, dims, pc_range, scale_range, unit_xyz, semantic_dim):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.scale_range = tuple(scale_range)
        self.semantic_dim = semantic_dim
        self.register_buffer("unit_xyz", torch.tensor(unit_xyz),
                             persistent=False)
        out = 11 + semantic_dim
        self.layers = nn.Sequential(*linear_relu_ln(dims, 2, 2),
                                    nn.Linear(dims, out), Scale(out))

    def forward(self, feat, anchor, anchor_embed):
        o = self.layers(feat + anchor_embed)
        step = (2.0 * sigmoid(o[..., :3]) - 1.0) * self.unit_xyz
        xyz = to_logits(to_world(anchor[..., :3], self.pc_range) + step,
                        self.pc_range)
        rot = o[..., 6:10] / o[..., 6:10].norm(dim=-1, keepdim=True
                                               ).clamp_min(1e-12)
        sem = o[..., 11:11 + self.semantic_dim]
        new = torch.cat([xyz, o[..., 3:6], rot, o[..., 10:11], sem], -1)
        lo, hi = self.scale_range
        return new, Gaussians(to_world(xyz, self.pc_range),
                              lo + (hi - lo) * sigmoid(o[..., 3:6]), rot,
                              sigmoid(o[..., 10:11]), sem)


class RefineV1(nn.Module):
    """The output is the new anchor: with ``restrict_xyz`` its xyz a
    bounded step in logit space, the ``refine_manual`` components added
    to the old anchor's, the quaternion normalised."""

    def __init__(self, dims, pc_range, scale_range, unit_xyz, semantic_dim,
                 include_opa, activation, restrict_xyz, manual):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.scale_range = tuple(scale_range)
        self.semantic_dim = semantic_dim
        self.include_opa = include_opa
        self.activation = activation
        self.restrict_xyz = restrict_xyz
        self.manual = tuple(manual or ())
        self.register_buffer("unit_prob", torch.tensor(
            [unit_xyz[i] / (pc_range[i + 3] - pc_range[i]) * 4.0
             for i in range(3)]), persistent=False)
        out = 10 + int(include_opa) + semantic_dim
        self.layers = nn.Sequential(*linear_relu_ln(dims, 2, 2),
                                    nn.Linear(dims, out), Scale(out))

    def forward(self, feat, anchor, anchor_embed):
        o = self.layers(feat + anchor_embed)
        if self.restrict_xyz:
            o = torch.cat([(2.0 * sigmoid(o[..., :3]) - 1.0) * self.unit_prob,
                           o[..., 3:]], -1)
        k = len(self.manual)
        if k:
            o = torch.cat([o[..., :k] + anchor[..., :k], o[..., k:]], -1)
        rot = o[..., 6:10] / o[..., 6:10].norm(dim=-1, keepdim=True
                                               ).clamp_min(1e-12)
        o = torch.cat([o[..., :6], rot, o[..., 10:]], -1)
        s = 10 + int(self.include_opa)
        sem = o[..., s:s + self.semantic_dim]
        if self.activation == "softplus":
            sem = torch.nn.functional.softplus(sem)
        lo, hi = self.scale_range
        return o, Gaussians(to_world(o[..., :3], self.pc_range),
                            lo + (hi - lo) * sigmoid(o[..., 3:6]), rot,
                            sigmoid(o[..., 10:s]), sem)


def operation_order(c):
    if c["version"] == 2:
        return ("identity", "deformable", "add", "norm", "identity", "ffn",
                "add", "norm", "identity", "spconv", "add", "norm",
                "identity", "ffn", "add", "norm", "refine") * c["num_decoder"]
    return (("deformable", "ffn", "norm", "refine")
            + ("spconv", "norm", "deformable", "ffn", "norm", "refine")
            * (c["num_decoder"] - 1))


class GaussianOccEncoder(nn.Module):
    def __init__(self, c, prec: Precision = REFERENCE,
                 checkpoint: bool = False):
        super().__init__()
        self.checkpoint = checkpoint
        d = c["embed_dims"]
        self.order = operation_order(c)
        self.anchor_encoder = SparseGaussian3DEncoder(d, c["semantic_dim"],
                                                      c["include_opa"])

        def make(op):
            if op in ("identity", "add"):
                return nn.Identity()
            if op == "norm":
                return nn.LayerNorm(d)
            if op == "ffn":
                return AsymmetricFFN(d, 4 * d, c["ffn_drop"],
                                     c["ffn_add_identity"],
                                     c["ffn_in_channels"])
            if op == "deformable":
                return DeformableFeatureAggregation(
                    d, c["num_cams"], c["num_learnable_pts"],
                    c["learnable_fixed_scale"], c["fix_scale"],
                    c["pc_range"], c["scale_range"], c["attn_drop"],
                    c["deformable_residual_mode"], prec)
            if op == "spconv":
                return SparseConv3DModule(d, c["pc_range"],
                                          c["spconv_grid_size"],
                                          c["spconv_use_out_proj"],
                                          c["spconv_use_multi_layer"], prec)
            if c["version"] == 2:
                return RefineV2(d, c["pc_range"], c["scale_range"],
                                c["unit_xyz"], c["semantic_dim"])
            return RefineV1(d, c["pc_range"], c["scale_range"],
                            c["unit_xyz"], c["semantic_dim"],
                            c["include_opa"], c["semantics_activation"],
                            c["restrict_xyz"], c["refine_manual"])
        self.layers = nn.ModuleList(make(op) for op in self.order)

    def run_op(self, i, args, rand=None):
        """Operation i of the order on ``args``, the arguments its module
        takes in the program (without the program's trailing training
        flag and generator)."""
        op, layer = self.order[i], self.layers[i]
        if op == "ffn":
            return layer(args[0], rand)
        if op == "deformable":
            return layer(*args[:6], rand)
        if op == "spconv":
            return layer(args[0], args[1])
        if op == "refine":
            return layer(*args[:3])
        return layer(args[0])

    def step(self, i, args, rand=None):
        """:meth:`run_op`, its dropout uniforms drawn from ``rand`` first
        and handed in; under ``checkpoint`` (with gradients on) recomputed
        in the backward on the same uniforms."""
        draws = None
        if rand is not None and hasattr(self.layers[i], "draw_shapes"):
            draws = [rand(s) for s in self.layers[i].draw_shapes(args[0])]
        if self.checkpoint and torch.is_grad_enabled():
            return _checkpoint(self._handed, i, args, draws,
                               use_reentrant=False)
        return self._handed(i, args, draws)

    def _handed(self, i, args, draws):
        return self.run_op(i, args, handing(draws))

    def forward(self, anchor, feat, feature_maps, projection_mat, image_wh,
                rand=None):
        embed = self.anchor_encoder(anchor)
        preds = []
        identity = None
        for i, op in enumerate(self.order):
            if op == "identity":
                identity = feat
            elif op == "add":
                feat = feat + identity
            elif op == "deformable":
                feat = self.step(i, (feat, anchor, embed, feature_maps,
                                     projection_mat, image_wh), rand)
            elif op == "spconv":
                feat = self.step(i, (feat, anchor))
            elif op == "refine":
                anchor, g = self.step(i, (feat, anchor, embed))
                preds.append(g)
                if i != len(self.order) - 1:
                    embed = self.anchor_encoder(anchor)
            else:
                feat = self.step(i, (feat,), rand)
        return preds
