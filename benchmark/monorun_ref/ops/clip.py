"""``jnp.clip`` with its gradient.

``torch.clamp`` passes the whole gradient at a bound; ``jnp.clip`` is
``minimum(maximum(x, lo), hi)``, whose gradient is 1 inside, 1/2 at a
bound (a tie of the maximum or minimum) and 0 outside. Where a clamped
value is differentiated and can sit exactly on its bound (a RoI edge
clipped to the image, a sample on a map's first row), the port uses this
to give the JAX package's gradient.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def clip(x: Tensor, lo=None, hi=None) -> Tensor:
    """``jnp.clip(x, lo, hi)``; the bounds (numbers or tensors) carry no
    gradient."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype, device=x.device))
    return x
