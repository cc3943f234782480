"""The control: the reference in the program's place, a step of precision
below the configuration's. The configuration computes in bfloat16, so the
control computes as it states but with every convolution and linear layer
of the reference on float8 (e4m3) inputs and weights, each tensor under
its own scale: the step a later change would be tempted by."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in ``x``'s
    dtype."""
    amax = x.abs().amax().float().clamp(min=1e-12)
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


@contextlib.contextmanager
def float8_layers():
    """Inside the block the reference's ``Conv2d`` and ``Linear`` compute
    on float8-rounded inputs and weights."""
    from monorun_ref.models import layers

    def conv(self, x):
        w = fp8(layers._cast(self.weight, x.dtype))
        return F.conv2d(fp8(x), w, layers._cast(self.bias, x.dtype),
                        self.stride, self.padding, self.dilation, self.groups)

    def linear(self, x):
        return F.linear(fp8(x), fp8(layers._cast(self.weight, x.dtype)),
                        layers._cast(self.bias, x.dtype))

    saved = layers.Conv2d.forward, layers.Linear.forward
    layers.Conv2d.forward, layers.Linear.forward = conv, linear
    try:
        yield
    finally:
        layers.Conv2d.forward, layers.Linear.forward = saved
