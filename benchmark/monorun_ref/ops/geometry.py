"""Camera projection with clip-aware masking and analytic pose Jacobians;
the PyTorch counterpart of ``monorun_tpu/ops/geometry.py``.

Residual model:

    r_i = w_i * ( clip( pi( K (R_y(yaw) X_i + t) ) ) - x2d_i )

with z clipped to ``z >= z_min`` and (u, v) clipped to the image rectangle
grown by an allowed border. Clipped points and RANSAC outliers get zero
Jacobian rows. Everything is batched over a leading RoI axis: (b, n, ...).
Pose columns are ordered [yaw, tx, ty, tz].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


Tensor = torch.Tensor


def yaw_rotation_matrix(yaw: Tensor) -> Tensor:
    """R_y(yaw): (...,) -> (..., 3, 3)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, z, s], -1),
            torch.stack([z, o, z], -1),
            torch.stack([-s, z, c], -1),
        ],
        -2,
    )


class ProjectionResult(NamedTuple):
    uv: Tensor            # (b, n, 2) clipped projections
    z: Tensor             # (b, n, 1) clipped depths
    z_clip_mask: Tensor   # (b, n, 1) bool
    uv_clip_mask: Tensor  # (b, n, 2) bool
    sin_yaw: Tensor       # (b,)
    cos_yaw: Tensor       # (b,)
    error_unweighted: Tensor  # (b, n, 2) uv - coords_2d


def forward_proj(
    coords_2d: Tensor, coords_3d: Tensor, cam_mats: Tensor, z_min: float,
    u_range: Tensor, v_range: Tensor, yaw: Tensor, t_vec: Tensor,
) -> ProjectionResult:
    """Project object coords with a yaw-only pose; returns clip masks."""
    sin_yaw = torch.sin(yaw)[:, 0]
    cos_yaw = torch.cos(yaw)[:, 0]
    k_r = cam_mats @ yaw_rotation_matrix(yaw[:, 0])         # (b, 3, 3)
    k_t = (cam_mats @ t_vec[..., None])[..., 0]             # (b, 3)
    uvz = torch.einsum("bux,bnx->bnu", k_r, coords_3d) + k_t[:, None, :]
    uv, z = uvz[..., :2], uvz[..., 2:3]
    z_clip_mask = z < z_min
    z = z.clamp(min=z_min)
    uv = uv / z
    uv_lb = torch.stack([u_range[:, 0], v_range[:, 0]], -1)[:, None, :]
    uv_ub = torch.stack([u_range[:, 1], v_range[:, 1]], -1)[:, None, :]
    uv_clip_mask = (uv < uv_lb) | (uv > uv_ub)
    uv = torch.minimum(torch.maximum(uv, uv_lb), uv_ub)
    return ProjectionResult(
        uv, z, z_clip_mask, uv_clip_mask, sin_yaw, cos_yaw, uv - coords_2d
    )


def pose_jacobians(
    proj: ProjectionResult,
    cam_mats: Tensor,
    coords_2d_istd: Tensor,
    coords_3d: Tensor,
    inlier_mask: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor]:
    """Weighted Jacobians wrt [yaw, t], zero at clips: (jac_yaw (b,n,2,1),
    jac_t (b,n,2,3), zero_mask (b,n,2))."""
    uv, z = proj.uv, proj.z
    zero_mask = proj.z_clip_mask | proj.uv_clip_mask
    if inlier_mask is not None:
        zero_mask = zero_mask | ~inlier_mask[..., None]

    jac_t_xy = cam_mats[:, None, :2, :2] / z[..., None]
    jac_t_z = (cam_mats[:, None, :2, 2:3] - uv[..., None]) / z[..., None]
    jac_t = torch.cat([jac_t_xy, jac_t_z], -1) * coords_2d_istd[..., None]
    jac_t = torch.where(zero_mask[..., None], torch.zeros_like(jac_t), jac_t)

    s, c = proj.sin_yaw, proj.cos_yaw
    m1_l = cam_mats[:, 0:2][:, :, [0, 2]]                     # (b, 2, 2)
    m1_r = torch.stack(
        [torch.stack([-s, c], -1), torch.stack([-c, -s], -1)], -2
    )
    m1 = m1_l @ m1_r
    m2 = torch.einsum("bnu,bx->bnux", uv, torch.stack([c, s], -1))
    jac_yaw_m = m1[:, None] + m2
    xz = coords_3d[..., [0, 2]]
    jac_yaw = torch.einsum("bnux,bnx->bnu", jac_yaw_m, xz) / z
    jac_yaw = jac_yaw * coords_2d_istd
    jac_yaw = torch.where(zero_mask, torch.zeros_like(jac_yaw), jac_yaw)[..., None]
    return jac_yaw, jac_t, zero_mask


def jacobian_and_error(
    coords_2d, coords_2d_istd, coords_3d, cam_mats, u_range, v_range,
    z_min: float, yaw, t_vec, inlier_mask,
) -> Tuple[Tensor, Tensor]:
    """Stacked pose Jacobian (b, 2n, 4) and weighted residual (b, 2n)."""
    proj = forward_proj(
        coords_2d, coords_3d, cam_mats, z_min, u_range, v_range, yaw, t_vec
    )
    jac_yaw, jac_t, _ = pose_jacobians(
        proj, cam_mats, coords_2d_istd, coords_3d, inlier_mask
    )
    b, n = coords_2d.shape[:2]
    jac = torch.cat([jac_yaw, jac_t], -1).reshape(b, 2 * n, 4)
    error = proj.error_unweighted * coords_2d_istd
    if inlier_mask is not None:
        error = torch.where(inlier_mask[..., None], error, torch.zeros_like(error))
    return jac, error.reshape(b, 2 * n)


def gn_normal_equations(
    coords_2d, coords_2d_istd, coords_3d, cam_mats, u_range, v_range,
    z_min: float, yaw, t_vec, inlier_mask,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Gauss-Newton terms, entry-major: (g (4, b), h (4, 4, b), cost (b,))."""
    proj = forward_proj(
        coords_2d, coords_3d, cam_mats, z_min, u_range, v_range, yaw, t_vec
    )
    jac_yaw, jac_t, _ = pose_jacobians(
        proj, cam_mats, coords_2d_istd, coords_3d, inlier_mask
    )
    err = proj.error_unweighted * coords_2d_istd
    if inlier_mask is not None:
        err = torch.where(inlier_mask[..., None], err, torch.zeros_like(err))
    cols = (jac_yaw[..., 0], jac_t[..., 0], jac_t[..., 1], jac_t[..., 2])

    def red(a, bb):
        return (a * bb).sum(dim=(1, 2))

    g = torch.stack([red(c, err) for c in cols])
    rows = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            rows[i][j] = rows[j][i] = red(cols[i], cols[j])
    h = torch.stack([torch.stack(r) for r in rows])
    return g, h, red(err, err)


def approx_hessian(
    coords_2d, coords_2d_istd, coords_3d, cam_mats, u_range, v_range,
    z_min: float, yaw, t_vec, inlier_mask,
) -> Tensor:
    """Gauss-Newton J^T J, (b, 4, 4)."""
    jac, _ = jacobian_and_error(
        coords_2d, coords_2d_istd, coords_3d, cam_mats, u_range, v_range,
        z_min, yaw, t_vec, inlier_mask,
    )
    return torch.einsum("bni,bnj->bij", jac, jac)


def exact_hessian(
    coords_2d, coords_2d_istd, coords_3d, cam_mats, u_range, v_range,
    z_min: float, yaw, t_vec, inlier_mask,
) -> Tensor:
    """Exact least-squares Hessian (b, 4, 4): the pose derivative of the
    analytic gradient J^T e (J^T J plus the residual-curvature term)."""
    pose = torch.cat([yaw, t_vec], dim=1).detach().requires_grad_(True)
    with torch.enable_grad():
        jac, err = jacobian_and_error(
            coords_2d, coords_2d_istd, coords_3d, cam_mats, u_range, v_range,
            z_min, pose[:, :1], pose[:, 1:], inlier_mask,
        )
        g = torch.einsum("bni,bn->bi", jac, err)
        # RoIs are independent, so the gradient of each summed column is
        # that column's per-RoI derivative row
        rows = [
            torch.autograd.grad(g[:, i].sum(), pose, retain_graph=i < 3)[0]
            for i in range(4)
        ]
    return torch.stack(rows, dim=1).detach()
