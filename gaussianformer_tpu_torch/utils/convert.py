"""JAX package parameters -> this port's ``state_dict``.

The JAX package keeps its weights as a nested dict ``{"params": ...,
"batch_stats": ...}`` of arrays in flax layouts and flax names; the port
uses the reference (mmseg / mmdet / mmdet3d) module names, so its
``state_dict`` lines up with the JAX package's
``utils/torch_convert.py::convert_full_state_dict``. Layouts:

  - Conv kernel      [kh, kw, I, O]      -> weight [O, I, kh, kw]
  - ConvTranspose    [kh, kw, I, O], spatially flipped (flax places
                     kernel[k-1-a] where torch places kernel[a])
                                         -> weight [I, O, kh, kw]
  - Dense kernel     [I, O]              -> Linear weight [O, I]
  - LayerNorm / BN   scale               -> weight
  - BN batch_stats   mean / var          -> running_mean / running_var
  - sparse conv      [k, k, k, I, O]     -> spconv weight [O, k, k, k, I]

Both model families convert: GaussianFormer-2 (lifter v2 with its second
tower, three-layer spconv) and the v1 models (``lifter.anchor`` /
``lifter.instance_feature`` alone, the FFN's ``identity_fc``, the
single bias-free spconv ``layer.weight``, ``head.empty_scalar``), and the
FFN's optional ``pre_norm`` LayerNorm.

The DCN offset conv keeps its channel order: both packages, like mmcv,
emit 18 offsets as (dy, dx) per tap followed by 9 mask logits.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_RESNET = r"(img_backbone|lifter/initialize_backbone/img_backbone)"


def _lrl_index(in_loops: int, out_loops: int) -> Dict[str, int]:
    """flax LinearReluLn child name -> reference Sequential index."""
    mapping, idx, dense, ln = {}, 0, 0, 0
    for _ in range(out_loops):
        for _ in range(in_loops):
            mapping[f"Dense_{dense}"] = idx
            dense += 1
            idx += 2              # skip the ReLU
        mapping[f"LayerNorm_{ln}"] = idx
        ln += 1
        idx += 1
    return mapping


_LRL12 = _lrl_index(1, 2)
_LRL22 = _lrl_index(2, 2)


def _conv(a):
    return a.transpose(3, 2, 0, 1)


def _deconv(a):
    return a[::-1, ::-1].transpose(2, 3, 0, 1)


def _dense(a):
    return a.T


def _same(a):
    return a


_LEAF = {
    # kind -> {flax leaf: (torch leaf, transform)}
    "conv": {"kernel": ("weight", _conv), "bias": ("bias", _same)},
    "deconv": {"kernel": ("weight", _deconv)},
    "dense": {"kernel": ("weight", _dense), "bias": ("bias", _same)},
    "norm": {"scale": ("weight", _same), "bias": ("bias", _same),
             "mean": ("running_mean", _same),
             "var": ("running_var", _same)},
    "scale": {"scale": ("scale", _same)},
}


def _module(path: str, n_fpn_levels: int) -> Tuple[str, str]:
    """flax module path -> (reference module path, kind)."""
    m = re.fullmatch(_RESNET + r"/(.*)", path)
    if m:
        pre, rest = m.group(1).replace("/", "."), m.group(2)
        if rest == "conv1":
            return f"{pre}.conv1", "conv"
        if rest == "bn1":
            return f"{pre}.bn1", "norm"
        b = re.fullmatch(r"stage(\d+)/layer_(\d+)/(.*)", rest)
        if b:
            blk = f"{pre}.layer{b.group(1)}.{b.group(2)}"
            leaf = b.group(3)
            table = {"downsample_conv": ("downsample.0", "conv"),
                     "downsample_bn": ("downsample.1", "norm"),
                     "conv2/conv_offset": ("conv2.conv_offset", "conv")}
            if leaf in table:
                sub, kind = table[leaf]
                return f"{blk}.{sub}", kind
            if re.fullmatch(r"conv\d", leaf):
                return f"{blk}.{leaf}", "conv"
            if re.fullmatch(r"bn\d", leaf):
                return f"{blk}.{leaf}", "norm"
    m = re.fullmatch(r"img_neck/(lateral|fpn_conv|extra_conv)_(\d+)", path)
    if m:
        i = int(m.group(2))
        if m.group(1) == "lateral":
            return f"img_neck.lateral_convs.{i}.conv", "conv"
        if m.group(1) == "extra_conv":
            i += n_fpn_levels
        return f"img_neck.fpn_convs.{i}.conv", "conv"
    m = re.fullmatch(r"lifter/initialize_backbone/img_neck/deblock_(\d+)_"
                     r"(deconv|conv|bn)", path)
    if m:
        pre = f"lifter.initialize_backbone.img_neck.deblocks.{m.group(1)}"
        kind = {"deconv": "deconv", "conv": "conv", "bn": "norm"}[m.group(2)]
        return f"{pre}.{1 if kind == 'norm' else 0}", kind
    if path == "lifter/projection":
        return "lifter.projection.1", "dense"
    m = re.fullmatch(r"encoder/anchor_encoder/(\w+)/(\w+)", path)
    if m:
        kind = "dense" if m.group(2).startswith("Dense") else "norm"
        return (f"encoder.anchor_encoder.{m.group(1)}."
                f"{_LRL12[m.group(2)]}", kind)
    m = re.fullmatch(r"encoder/op(\d+)_(\w+?)(?:/(.*))?", path)
    if m:
        pre, op, rest = f"encoder.layers.{m.group(1)}", m.group(2), m.group(3)
        if op == "norm" and rest is None:
            return pre, "norm"
        if op == "ffn" and rest in ("fc1", "fc2"):
            return pre + (".layers.0.0" if rest == "fc1" else ".layers.1"), \
                "dense"
        if op == "ffn" and rest == "identity_fc":
            return f"{pre}.identity_fc", "dense"
        if op == "ffn" and rest == "pre_norm":
            return f"{pre}.pre_norm", "norm"
        if op == "deformable":
            if rest in ("kps_generator/learnable_fc", "weights_fc",
                        "output_proj"):
                return f"{pre}.{rest.replace('/', '.')}", "dense"
            c = re.fullmatch(r"camera_encoder/(\w+)", rest or "")
            if c:
                kind = "dense" if c.group(1).startswith("Dense") else "norm"
                return f"{pre}.camera_encoder.{_LRL12[c.group(1)]}", kind
        if op == "spconv":
            if rest == "output_proj":
                return f"{pre}.output_proj", "dense"
            c = re.fullmatch(r"ln(\d)", rest or "")
            if c:
                return f"{pre}.layer.{3 * int(c.group(1)) + 1}", "norm"
        if op == "refine":
            if rest == "out_fc":
                return f"{pre}.layers.10", "dense"
            if rest == "out_scale":
                return f"{pre}.layers.11", "scale"
            c = re.fullmatch(r"layers/(\w+)", rest or "")
            if c:
                kind = "dense" if c.group(1).startswith("Dense") else "norm"
                return f"{pre}.layers.{_LRL22[c.group(1)]}", kind
    raise KeyError(f"no port module for JAX path {path!r}")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _leaf_param(path: str, val, multi_layer_spconv
                ) -> Tuple[str, np.ndarray] | None:
    """Leaves that sit directly on a module with no child module.
    ``multi_layer_spconv``: the op indices whose spconv is the three-layer
    Sequential (``layer.0/3/6``); the others hold one conv, ``layer``."""
    m = re.fullmatch(r"lifter/(anchor|random_anchors|instance_feature)",
                     path)
    if m:
        return f"lifter.{m.group(1)}", val
    if path == "head/empty_scalar":
        return "head.empty_scalar", val
    m = re.fullmatch(r"encoder/op(\d+)_spconv/conv(\d)_(kernel|bias)", path)
    if m:
        key = f"encoder.layers.{m.group(1)}.layer"
        if m.group(1) in multi_layer_spconv:
            key += f".{3 * int(m.group(2))}"
        if m.group(3) == "kernel":
            return f"{key}.weight", val.transpose(4, 0, 1, 2, 3)
        return f"{key}.bias", val
    return None


def _placements(variables: Mapping):
    """(JAX path, port key, layout transform) of every leaf."""
    flat = _flatten(variables.get("params", {}))
    flat.update(_flatten(variables.get("batch_stats", {})))
    n_fpn = len({m.group(0) for m in map(
        re.compile(r"img_neck/lateral_\d+/").match, flat) if m})
    multi = {m.group(1) for m in map(
        re.compile(r"encoder/op(\d+)_spconv/ln0/").match, flat) if m}
    for path, val in flat.items():
        direct = _leaf_param(path, val, multi)
        if direct is not None:
            yield path, direct[0], direct[1]
            continue
        mod, leaf = path.rsplit("/", 1)
        tpath, kind = _module(mod, n_fpn)
        if leaf not in _LEAF[kind]:
            raise KeyError(f"unexpected leaf {leaf!r} at {path!r}")
        tleaf, fn = _LEAF[kind][leaf]
        yield path, f"{tpath}.{tleaf}", fn(val)


def jax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of the JAX package's
    BEVSegmentor (or of any of its sub-towers under the same names) ->
    the port's ``state_dict``. Raises on any leaf it cannot place. A tree
    of gradients or updates in the shape of the params converts the same
    way (``{"params": grads}``)."""
    return {key: torch.from_numpy(np.array(arr, dtype=np.float32,
                                           order="C", copy=True))
            for _, key, arr in _placements(variables)}


def jax_paths(variables: Mapping) -> Dict[str, str]:
    """Port ``state_dict`` key -> the "/"-joined JAX path of the same
    leaf (under ``params`` or ``batch_stats``)."""
    return {key: path for path, key, _ in _placements(variables)}
