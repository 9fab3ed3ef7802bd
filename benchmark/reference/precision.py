"""The arithmetic the reference computes in, and the control's one step
below it.

The configurations state bf16 for the towers, their necks and the spconv,
and float32 with TF32 off everywhere else. The reference computes every
part in float32 with TF32 off. The control (``Precision.control()``) is the
reference one step down in each part: fp8 (e4m3, one scale per tensor) in
place of bf16, TF32 for the float32 matrix products and convolutions, and
bf16 for the other float32 arithmetic (the deformable sampling, the FPS
distances, the splat's exponents)."""
from __future__ import annotations

import contextlib
import dataclasses

import torch

FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Precision:
    low: bool = False
    # the bf16 parts rounded to bf16, the rest as the reference: the
    # precision the configuration states, for looking at how far a number
    # moves with it alone
    stated: bool = False

    @classmethod
    def control(cls):
        return cls(low=True)

    def tower(self, t):
        """A conv input or weight of a bf16 part: as is, rounded to fp8
        (the control) or to bf16 (``stated``); gradients pass straight
        through."""
        if self.low:
            return fp8_round(t)
        if self.stated:
            return t + (t.detach().to(torch.bfloat16).to(t.dtype)
                        - t.detach())
        return t

    def elementwise(self, t):
        """A float32 operand of elementwise arithmetic: as is, or bf16."""
        return t.to(torch.bfloat16) if self.low else t

    @contextlib.contextmanager
    def matmul(self):
        """TF32 for float32 products off (reference) or on (control)."""
        keep = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.low
        torch.backends.cudnn.allow_tf32 = self.low
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = keep


def fp8_round(t):
    """``t`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude maps to 448), back in ``t``'s dtype; the gradient passes
    straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


REFERENCE = Precision()
