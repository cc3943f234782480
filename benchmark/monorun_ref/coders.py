"""Target coders: encode and decode transforms for dimensions, NOC maps,
reprojection errors and rotations (``monorun_tpu/coders.py`` in PyTorch).

Channels-last ``(n, h, w, c)`` maps, flip as a per-RoI boolean vector.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .ops.clip import clip

Tensor = torch.Tensor

KITTI_DIM_MEANS = ((3.89, 1.53, 1.62), (0.82, 1.78, 0.63), (1.77, 1.72, 0.57))
KITTI_DIM_STDS = ((0.44, 0.14, 0.11), (0.25, 0.13, 0.12), (0.15, 0.10, 0.14))
NOC_MEANS = (-0.1, -0.5, 0.0)
NOC_STDS = (0.35, 0.23, 0.34)


def _const(values, like: Tensor) -> Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class NOCCoder:
    """NOC parts (+variance) -> object-frame coords (+variance)."""

    target_means: Sequence[float] = NOC_MEANS
    target_stds: Sequence[float] = NOC_STDS
    eps: float = 1e-5

    def encode(
        self,
        gt_coords_3d: Tensor,       # (n, h, w, 3) mask-weighted coords
        gt_coords_3d_mask: Tensor,  # (n, h, w, 1)
        dimensions: Tensor,         # (n, 3) [l, h, w]
        flip: Tensor,               # (n,) bool
    ) -> Tuple[Tensor, Tensor]:
        """Masked object coords -> z-scored NOC parts and their mask; z is
        negated under a horizontal flip (the object frame is mirrored)."""
        means = _const(self.target_means, gt_coords_3d)
        stds = _const(self.target_stds, gt_coords_3d)
        foreground = gt_coords_3d_mask >= self.eps
        parts = (gt_coords_3d / clip(gt_coords_3d_mask, self.eps)
                 / clip(dimensions, self.eps)[:, None, None, :])
        parts_mask = torch.where(foreground, gt_coords_3d_mask,
                                 torch.zeros_like(gt_coords_3d_mask))
        flip_sign = torch.where(flip[:, None, None], -1.0, 1.0).to(parts.dtype)
        parts = parts * torch.stack(
            [torch.ones_like(flip_sign), torch.ones_like(flip_sign), flip_sign], -1)
        parts = (parts - means) / stds
        return parts * parts_mask, parts_mask

    def decode(
        self,
        part: Tensor,                      # (n, h, w, 3)
        part_var: Optional[Tensor],        # (n, h, w, 3) or None
        dimensions: Tensor,                # (n, 3)
        dimensions_var: Optional[Tensor],  # (n, 3) or None
        flip: Tensor,                      # (n,) bool, resolved upstream
    ) -> Tuple[Tensor, Optional[Tensor]]:
        del flip  # flip correction is resolved in the NOC head's banks
        means = _const(self.target_means, part)
        stds = _const(self.target_stds, part)
        dims = dimensions[:, None, None, :]
        part_norm = part * stds + means
        coords_3d = part_norm * dims

        coords_3d_var: Optional[Tensor] = None
        if part_var is not None:
            part_norm_var = part_var * stds.square()
            coords_3d_var = part_norm_var * dims.square()
            if dimensions_var is not None:
                dims_var = dimensions_var[:, None, None, :]
                coords_3d_var = (
                    coords_3d_var
                    + dims_var * part_norm.square()
                    + part_norm_var * dims_var
                )
        elif dimensions_var is not None:
            dims_var = dimensions_var[:, None, None, :]
            coords_3d_var = dims_var * part_norm.square()
        return coords_3d, coords_3d_var


@dataclasses.dataclass(frozen=True)
class DimCoder:
    """Per-class z-score codec for 3D dimensions (l, h, w)."""

    target_means: Sequence[Sequence[float]] = KITTI_DIM_MEANS
    target_stds: Sequence[Sequence[float]] = KITTI_DIM_STDS

    def encode(self, dimensions: Tensor, labels: Tensor) -> Tensor:
        means = _const(self.target_means, dimensions)[labels]
        stds = _const(self.target_stds, dimensions)[labels]
        return (dimensions - means) / stds

    def decode(
        self, dim: Tensor, dim_var: Optional[Tensor], labels: Tensor
    ) -> Tuple[Tensor, Optional[Tensor]]:
        means = _const(self.target_means, dim)[labels]
        stds = _const(self.target_stds, dim)[labels]
        dimensions = dim * stds + means
        dimensions_var = dim_var * stds.square() if dim_var is not None else None
        return dimensions, dimensions_var


@dataclasses.dataclass(frozen=True)
class ProjErrorCoder:
    """Distance-invariant reprojection-error codec."""

    ref_length: float = 1.6
    ref_focal_y: float = 722.0
    target_std: float = 0.15
    distance_min: float = 0.1
    epistemic_std_gain: float = 1.0

    @property
    def scaling_denominator(self) -> float:
        return self.ref_length * self.ref_focal_y * self.target_std

    def encode(self, coords_2d_diff_std: Tensor, distance: Tensor) -> Tensor:
        """Pixel reprojection error (n, h, w, c) at distance (n, 1) ->
        distance-invariant error."""
        return coords_2d_diff_std * (distance[:, None, None, :] / self.scaling_denominator)

    def decode(self, proj_error_std: Tensor, distance: Tensor) -> Tensor:
        d = clip(distance[:, None, None, :], self.distance_min)
        return proj_error_std * (self.scaling_denominator / d)

    def decode_logstd(
        self,
        proj_logstd: Tensor,               # (n, h, w, 2)
        coords_3d_var: Optional[Tensor],   # (n, h, w, 3) or None
        distance: Optional[Tensor],        # (n, 1) or None
    ) -> Tensor:
        if distance is not None:
            d = distance[:, None, None, :].clamp(min=self.distance_min)
        else:
            d = _const(self.scaling_denominator, proj_logstd)
        if coords_3d_var is not None:
            # u-variance mixes x/z epistemic variance; v-variance takes y
            var_u = 0.5 * (coords_3d_var[..., 0] + coords_3d_var[..., 2])
            var_v = coords_3d_var[..., 1]
            coords_2d_var = torch.stack([var_u, var_v], dim=-1)
            coords_2d_var = (
                coords_2d_var * (self.ref_focal_y * self.epistemic_std_gain) ** 2
                + torch.exp(2.0 * proj_logstd) * self.scaling_denominator ** 2
            ) / d.square()
            return 0.5 * torch.log(coords_2d_var)
        return proj_logstd + torch.log(self.scaling_denominator / d)

    def cov_correction(self, cov: Tensor, distance: Tensor) -> Tensor:
        # cov: (n, 4, 4); distance: (n,)
        scale = (self.scaling_denominator / distance).square()
        return cov * scale[:, None, None]
