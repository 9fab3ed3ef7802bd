"""Convert a reference PyTorch checkpoint into the port's (the job of the
root ``tools/convert_checkpoint.py``, here for the PyTorch port).

    python -m gaussianformer_tpu_torch.convert_checkpoint \\
        --config prob_gs6400 --torch-ckpt path/to/state_dict.pth \\
        --out out/prob64_converted [--strict] [--device cuda]

Writes ``ckpt_000000000.pt`` and ``latest`` (``utils/checkpoint.py``),
which ``python -m gaussianformer_tpu_torch.eval --work-dir DIR`` picks up.

The port's module names are the reference's (mmseg / mmdet / mmdet3d), and
it keeps the reference's layouts: the convolutions' [O, I, kh, kw], the
SECONDFPN's transposed convolutions' [I, O, kh, kw] unflipped, the spconv
kernels' [O, k, k, k, I], the ``linear_relu_ln`` Sequential indices. So a
reference tensor maps onto the port's tensor of its own name, where the
JAX package's converter (``gaussianformer_tpu/utils/torch_convert.py``)
transposes, flips and renames. Reference entries that carry no weight here
are dropped as that converter drops them: ``num_batches_tracked``, the
spconv's ``pc_range`` / ``grid_size`` buffers and the head's
``empty_mean`` / ``empty_scale`` / ``empty_rot`` / ``empty_sem`` /
``empty_opa`` (config constants in the port). A ``state_dict`` wrapper is
unwrapped. The model's tensors the checkpoint lacks keep the seeded init of
``build_segmentor``. Prints the mapped and total keys and the unmapped
ones; ``--strict`` exits nonzero on any unmapped reference key or any
model tensor left out. A shape that differs always raises.

The JAX tool's ``--skip-dcn-margin-check`` and ``--allow-out-of-margin``
are not ported: they guard the Pallas DCN's sampling window, and the
port's DCN kernels are exact for any offset.
"""
from __future__ import annotations

import argparse
import re
from typing import Dict, List, Mapping, Tuple

import torch

#: reference entries with no weight in the port (dropped, not unmapped)
DROPPED = re.compile(r"(.*\.num_batches_tracked"
                     r"|encoder\.layers\.\d+\.(pc_range|grid_size)"
                     r"|head\.empty_(mean|scale|rot|sem|opa))")


def convert_state_dict(sd: Mapping[str, torch.Tensor],
                       template: Mapping[str, torch.Tensor]
                       ) -> Tuple[Dict[str, torch.Tensor], List[str],
                                  List[str]]:
    """Map a reference ``state_dict`` onto the port's tensors of the same
    names (``template``: the model's ``state_dict``). Returns (the mapped
    tensors, in the template's dtypes, on the CPU; the reference keys that
    map to nothing; the template's keys the reference lacks). Raises
    ``ValueError`` on a shape that differs."""
    out, unmapped = {}, []
    for key, val in sd.items():
        if key in template:
            want = template[key]
            if tuple(val.shape) != tuple(want.shape):
                raise ValueError(f"{key}: the checkpoint's shape "
                                 f"{tuple(val.shape)} is not the model's "
                                 f"{tuple(want.shape)}")
            out[key] = torch.as_tensor(val).detach().to(
                device="cpu", dtype=want.dtype).contiguous()
        elif not DROPPED.fullmatch(key):
            unmapped.append(key)
    missing = [k for k in template if k not in out]
    return out, sorted(unmapped), missing


def main(argv=None) -> int:
    from .configs import get_config
    from .device import resolve_device
    from .models.segmentor import build_segmentor
    from .train.runner import _read_state_dict
    from .utils.checkpoint import save_checkpoint

    ap = argparse.ArgumentParser(
        prog="python -m gaussianformer_tpu_torch.convert_checkpoint")
    ap.add_argument("--config", default="prob_gs6400")
    ap.add_argument("--torch-ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--strict", action="store_true",
                    help="fail on any unmapped reference key or any model "
                         "tensor the checkpoint lacks")
    ap.add_argument("--device", default="cuda",
                    help="where the model template is built")
    args = ap.parse_args(argv)

    cfg = get_config(args.config)
    model = build_segmentor(cfg, device=resolve_device(args.device), seed=0)
    template = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    sd = _read_state_dict(args.torch_ckpt)
    mapped, unmapped, missing = convert_state_dict(sd, template)
    print(f"mapped {len(mapped)}/{len(sd)} reference keys; "
          f"{len(sd) - len(mapped) - len(unmapped)} dropped (no weight in "
          f"the port); {len(missing)} of the model's {len(template)} tensors "
          f"not in the checkpoint (they keep the seeded init)")
    for what, keys in (("unmapped", unmapped), ("missing", missing)):
        if keys:
            print(f"{what}:")
            for k in keys[:40]:
                print("  ", k)
    if args.strict and (unmapped or missing):
        return 1
    path = save_checkpoint(args.out, 0, {
        "model": {**template, **mapped}, "epoch": 0, "global_iter": 0,
        "last_iter": 0})
    print(f"wrote {path}; evaluate with:")
    print(f"  python -m gaussianformer_tpu_torch.eval --config {args.config}"
          f" --work-dir {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
