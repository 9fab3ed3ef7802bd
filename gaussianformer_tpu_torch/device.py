"""Device selection for the port's entry points, and the constant tensors
of its forward."""
from __future__ import annotations

import torch

_CONSTANTS = {}


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and absent, instead of running
    on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch versions on the CPU")
    return dev


def constant(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype, device)``, made once per (values,
    dtype, device) and kept: a forward that reads it copies nothing from
    the host, which a CUDA graph's capture refuses (a pageable copy
    synchronises). The first call (outside a capture) makes it, outside
    inference mode so that autograd may save it. Never written in place."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (tuple(values), dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.tensor(values, dtype=dtype, device=device)
        _CONSTANTS[key] = t
    return t
