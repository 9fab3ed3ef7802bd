"""The work of a frame and of a train step, counted from a configuration's
shapes alone (frozen: whatever implements an operation, and whatever a
later change renames, reads the same work here).

A count is 2 * multiply-adds of the convolutions and matrix products:
both ResNet towers with their DCNv2 convs (the offset conv and the
deformable 3x3, each 2 * B*H*W * 9 * C_in * C_out), the FPN, the lifter's
SECONDFPN and depth projection, and the encoder's linear layers and
submanifold convs (dense over the k^3 taps, as computed). Not counted:
elementwise work, the deformable sampling, FPS, the splat, the losses and
the small batched products of the key points and projections.

A train step adds the backward: twice the forward's count for every
operation whose input takes a gradient, once (the weight's gradient) for
the towers' stems and the camera encoder's first layer, whose inputs are
data. Every parameter takes a gradient in the program's step (frozen ones
too, for the global norm)."""
from __future__ import annotations

import dataclasses
from typing import List

BLOCKS = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


@dataclasses.dataclass
class Work:
    forward: float = 0.0     # flops of the forward
    backward: float = 0.0    # flops of the backward, where it runs
    dcn: List[float] = dataclasses.field(default_factory=list)

    def add(self, flops, grad_input=True):
        self.forward += flops
        self.backward += flops * (2 if grad_input else 1)


def conv_out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def conv(work, n, h, w, cin, cout, k, grad_input=True):
    """A k x k conv over an n x h x w output."""
    work.add(2.0 * n * h * w * cin * cout * k * k, grad_input)


def tower(work, c, n, h, w, neck):
    """ResNet (stem, maxpool, bottlenecks; the stride on each stage's
    first 1x1) and its neck: ``"fpn"`` (start level 1, four outputs) or
    ``"second_fpn"``. Returns nothing; adds to ``work``."""
    base = c["base_channels"]
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    conv(work, n, h, w, 3, base, 7, grad_input=False)
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    cin, planes = base, base
    sizes = []
    for i, nb in enumerate(BLOCKS[c["depth"]]):
        for j in range(nb):
            s = (1 if i == 0 else 2) if j == 0 else 1
            h, w = conv_out(h, 1, s, 0), conv_out(w, 1, s, 0)
            conv(work, n, h, w, cin, planes, 1)
            if c["stage_with_dcn"][i]:
                off = 2.0 * n * h * w * 9 * planes * 27
                dcn = 2.0 * n * h * w * 9 * planes * planes
                work.add(off + dcn)
                work.dcn.append(off + dcn)
            else:
                conv(work, n, h, w, planes, planes, 3)
            conv(work, n, h, w, planes, 4 * planes, 1)
            if j == 0 and (s != 1 or cin != 4 * planes):
                conv(work, n, h, w, cin, 4 * planes, 1)
            cin = 4 * planes
        sizes.append((cin, h, w))
        planes *= 2
    if neck == "fpn":
        d = c["embed_dims"]
        for cin, h, w in sizes[1:]:
            conv(work, n, h, w, cin, d, 1)
            conv(work, n, h, w, d, d, 3)
        h, w = sizes[-1][1:]
        conv(work, n, conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1), d, d, 3)
    else:
        outs = c["initializer_out_channels"]
        for (cin, h, w), cout, s in zip(sizes, outs, (0.5, 1, 2, 4)):
            if s < 1:
                k = int(round(1 / s))
                conv(work, n, conv_out(h, k, k, 0), conv_out(w, k, k, 0),
                     cin, cout, k)
            else:
                # a transposed conv: k*k taps at each input position
                conv(work, n, h, w, cin, cout, int(s))
        h, w = sizes[1][1:]
        work.add(2.0 * n * h * w * sum(outs) * (c["num_depth_samples"] + 1))


def linear(work, rows, fan_in, fan_out, grad_input=True):
    work.add(2.0 * rows * fan_in * fan_out, grad_input)


def mlp(work, rows, d, in_loops, out_loops, input_dims=None):
    """linear_relu_ln: [Linear, ReLU] x in_loops then LayerNorm, out_loops
    times."""
    fan_in = input_dims or d
    for _ in range(out_loops * in_loops):
        linear(work, rows, fan_in, d)
        fan_in = d


def encoder(work, c, batch):
    d = c["embed_dims"]
    p = batch * (c["num_anchor"] + (c["random_samples"]
                                    if c["version"] == 2 else 0))
    sem = c["semantic_dim"]
    k = len(c["fix_scale"]) + c["num_learnable_pts"]
    cams = c["num_cams"]

    def anchor_embed():
        for fan_in in (3, 3, 4) + ((1,) if c["include_opa"] else ()) + (sem,):
            mlp(work, p, d, 1, 2, fan_in)
        mlp(work, p, d, 1, 2)

    if c["version"] == 2:
        order = ["deformable", "ffn", "spconv", "ffn",
                 "refine"] * c["num_decoder"]
    else:
        order = (["deformable", "ffn", "refine"]
                 + ["spconv", "deformable", "ffn", "refine"]
                 * (c["num_decoder"] - 1))
    anchor_embed()
    refines = order.count("refine")
    for op in order:
        if op == "deformable":
            linear(work, p, d, 3 * c["num_learnable_pts"])
            rows = batch * cams
            linear(work, rows, 12, d, grad_input=False)
            linear(work, rows, d, d)
            linear(work, p * cams, d, 4 * 4 * k)
            linear(work, p, d, d)
        elif op == "ffn":
            fan_in = c["ffn_in_channels"] or d
            linear(work, p, fan_in, 4 * d)
            linear(work, p, 4 * d, d)
            if c["ffn_add_identity"] and fan_in != d:
                linear(work, p, fan_in, d)
        elif op == "spconv":
            taps = 5 ** 3
            for _ in range(3 if c["spconv_use_multi_layer"] else 1):
                linear(work, p, taps * d, d)
            if c["spconv_use_out_proj"]:
                linear(work, p, d, d)
        elif op == "refine":
            mlp(work, p, d, 2, 2)
            linear(work, p, d, 11 + sem if c["version"] == 2
                   else 10 + int(c["include_opa"]) + sem)
            refines -= 1
            if refines:
                anchor_embed()


def model_work(c, batch=1) -> Work:
    """The work of one forward (and one backward) of the configuration
    ``c`` (the ``config`` of a configuration file) at ``batch``."""
    work = Work()
    n = batch * c["num_cams"]
    h, w = c["input_size"]
    tower(work, c, n, h, w, "fpn")
    if c["version"] == 2:
        tower(work, c, n, h, w, "second_fpn")
    encoder(work, c, batch)
    return work
