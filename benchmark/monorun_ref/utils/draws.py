"""Uniforms that follow their generator's device."""

from typing import Optional, Sequence

import torch


def uniform(shape: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` on ``device``, drawn on the
    generator's own device (on ``device`` when there is none): one seeded
    CPU generator gives a CPU and a GPU run the same draws."""
    src = device if generator is None else generator.device
    return torch.rand(tuple(shape), generator=generator, device=src).to(device)
