"""Batched uncertainty-weighted PnP, all RoIs solved together on the
device; the PyTorch counterpart of ``monorun_tpu/ops/pnp.py``.

1. istd pre-filter: points whose inverse std is below ``thres * mean`` in
   either channel are dropped (keep all when <= 4 survive).
2. Closed-form yaw-DLT init: with a 4-DoF pose the projection constraints
   are linear in [cos(yaw), sin(yaw), t], solved as a weighted 5x5 normal
   system from per-point moments; t is re-solved at the normalised yaw.
3. RANSAC: H hypotheses per RoI from minimal subsets (one point per
   contiguous band of n/k points, picked by the smallest random key),
   scored by inliers under the per-RoI pixel threshold; consensus refit.
   The keys are an input (``ransac_keys`` (b, H, n) uniform in [0, 1));
   without it they are drawn from ``generator``.
4. Levenberg-Marquardt: fixed-iteration damped Gauss-Newton on
   [yaw, t] with per-RoI accept/reject and Marquardt damping.
5. Covariance (J^T J)^-1 at the final pose behind a Cholesky PD guard.

No gradients flow through the solver.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.draws import uniform
from .geometry import (
    approx_hessian, exact_hessian, gn_normal_equations, yaw_rotation_matrix,
)
from .linalg_small import (
    spd_inverse, spd_inverse_packed, spd_solve_packed, spd_valid,
    spd_valid_packed,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    z_min: float = 0.5
    istd_thres: float = 0.6
    inlier_opt_only: bool = True
    ransac_hypotheses: int = 32
    ransac_min_points: int = 4
    lm_iters: int = 8
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 0.25
    coord_istd_normalize: bool = False
    eps: float = 1e-6
    exact_hessian: bool = False


class PnPResult(NamedTuple):
    valid: Tensor        # (b,) bool
    yaw: Tensor          # (b, 1)
    t_vec: Tensor        # (b, 3)
    pose_cov: Tensor     # (b, 4, 4)
    inlier_mask: Tensor  # (b, n) bool


def istd_inlier_mask(istd: Tensor, thres: float) -> Tensor:
    """(b, n, 2) -> (b, n) bool; keep-all fallback when <= 4 survive."""
    mean = istd.mean(dim=1, keepdim=True)
    ok = (istd >= thres * mean).all(dim=2)
    count = ok.sum(dim=1, keepdim=True)
    return torch.where(count > 4, ok, torch.ones_like(ok))


# upper triangle of the 5x5 normal matrix; moment layout =
# [A_i*A_j for (i, j) in _TRI5] + [A_i*b for i in range(5)]
_TRI5 = [(i, j) for i in range(5) for j in range(i, 5)]
_TRI5_POS = {ij: k for k, ij in enumerate(_TRI5)}
N_MOMENTS = len(_TRI5) + 5


def dlt_point_moments(coords_2d: Tensor, coords_3d: Tensor, cam_mats: Tensor) -> Tensor:
    """Per-point normal-equation moments (b, n, 20); the u-row's constant
    is 0. Non-finite moments (degenerate points) are dropped."""
    u, v = coords_2d[..., 0], coords_2d[..., 1]
    x, y, z = coords_3d[..., 0], coords_3d[..., 1], coords_3d[..., 2]
    fx = cam_mats[:, 0, 0][:, None]
    fy = cam_mats[:, 1, 1][:, None]
    cx = cam_mats[:, 0, 2][:, None]
    cy = cam_mats[:, 1, 2][:, None]
    zeros = torch.zeros_like(x)
    du, dv = cx - u, cy - v
    Au = torch.stack([fx * x + du * z, fx * z - du * x, fx + zeros, zeros, du], -1)
    Av = torch.stack([dv * z, -dv * x, zeros, fy + zeros, dv], -1)
    bv = fy * y
    prods = [Au[..., i] * Au[..., j] + Av[..., i] * Av[..., j] for (i, j) in _TRI5]
    atbs = [Av[..., i] * bv for i in range(5)]
    M = torch.stack(prods + atbs, dim=-1)
    return torch.where(torch.isfinite(M), M, torch.zeros_like(M))


def dlt_solve_moments(M: Tensor, eps: float = 1e-8) -> Tuple[Tensor, Tensor]:
    """Closed-form 4-DoF PnP from summed moments (batch, 20) -> (yaw
    (batch, 1), t (batch, 3))."""
    def tri(i, j):
        return M[..., _TRI5_POS[(min(i, j), max(i, j))]]

    def atb(i):
        return M[..., len(_TRI5) + i]

    eye5 = torch.eye(5, dtype=M.dtype, device=M.device)[:, :, None]
    ata = torch.stack([torch.stack([tri(i, j) for j in range(5)], 0) for i in range(5)], 0)
    # relative Tikhonov keeps degenerate RoIs finite
    tr = sum(ata[i, i] for i in range(5))
    ata = ata + (1e-6 * tr / 5.0 + eps) * eye5
    atb5 = torch.stack([atb(i) for i in range(5)], 0)
    sol = spd_solve_packed(ata, -atb5)
    c, s = sol[..., 0], sol[..., 1]
    norm = torch.sqrt((c * c + s * s).clamp(min=eps))
    c, s = c / norm, s / norm
    yaw = torch.atan2(s, c)[..., None]

    eye3 = torch.eye(3, dtype=M.dtype, device=M.device)[:, :, None]
    ata_t = torch.stack(
        [torch.stack([tri(i, j) for j in range(2, 5)], 0) for i in range(2, 5)], 0
    )
    tr_t = sum(ata_t[i, i] for i in range(3))
    ata_t = ata_t + (1e-6 * tr_t / 3.0 + eps) * eye3
    atb_t = torch.stack(
        [-(c * tri(0, i) + s * tri(1, i) + atb(i)) for i in range(2, 5)], 0
    )
    return yaw, spd_solve_packed(ata_t, atb_t)


def dlt_yaw_pnp(coords_2d, weights, coords_3d, cam_mats, eps: float = 1e-8):
    """Weighted closed-form 4-DoF PnP -> (yaw (b, 1), t (b, 3))."""
    M = torch.einsum(
        "bnd,bn->bd", dlt_point_moments(coords_2d, coords_3d, cam_mats), weights
    )
    return dlt_solve_moments(M, eps)


def ransac_yaw_pnp(
    keys: Tensor,          # (b, H, n) uniform draws
    coords_2d: Tensor, istd: Tensor, valid: Tensor, coords_3d: Tensor,
    cam_mats: Tensor, thr: Tensor, cfg: PnPConfig,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Fixed-shape RANSAC -> (yaw, t, inlier_mask)."""
    b, n = valid.shape
    H = cfg.ransac_hypotheses
    k = cfg.ransac_min_points
    if n % k:
        raise ValueError(f"point count {n} is not a multiple of {k}")
    w_point = istd.mean(-1) * valid
    keys = keys + torch.where(valid, 0.0, 10.0)[:, None, :]
    seg = n // k
    segmin = keys.reshape(b, H, k, seg).argmin(dim=-1)          # (b, H, k)
    onehot = torch.arange(seg, device=keys.device) == segmin[..., None]
    mask_w = onehot.reshape(b, H, n).float() * w_point[:, None]
    M_pt = dlt_point_moments(coords_2d, coords_3d, cam_mats)
    Mh = torch.einsum("bhn,bnd->bhd", mask_w, M_pt)
    yaw_h, t_h = dlt_solve_moments(Mh.reshape(b * H, N_MOMENTS))

    rot_h = yaw_rotation_matrix(yaw_h.reshape(b, H))          # (b, H, 3, 3)
    cam_pts = torch.einsum("bhij,bnj->bhni", rot_h, coords_3d) + t_h.reshape(b, H, 1, 3)
    z = cam_pts[..., 2:3].clamp(min=cfg.z_min)
    uv_h = torch.einsum(
        "bij,bhnj->bhni", cam_mats[:, :2, :2], cam_pts[..., :2] / z
    ) + cam_mats[:, None, None, :2, 2]
    err = torch.linalg.vector_norm(uv_h - coords_2d[:, None], dim=-1)   # (b, H, n)
    inl = (err <= thr[:, None, None]) & valid[:, None, :]
    score = inl.sum(-1)
    score = torch.where(t_h.reshape(b, H, 3)[..., 2] > cfg.z_min, score, -1)
    best = score.argmax(dim=1)

    best_inl = inl[torch.arange(b, device=inl.device), best]
    count = best_inl.sum(dim=1, keepdim=True)
    inlier_mask = torch.where(count > 4, best_inl, valid)
    M0 = torch.einsum("bnd,bn->bd", M_pt, istd.mean(-1) * inlier_mask)
    yaw0, t0 = dlt_solve_moments(M0)
    return yaw0, t0, inlier_mask


def lm_refine(
    coords_2d, istd, coords_3d, cam_mats, u_range, v_range, yaw0, t0,
    inlier_mask: Optional[Tensor], cfg: PnPConfig,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Damped Gauss-Newton on [yaw, t], every RoI in lockstep. The
    gradient and J^T J of the last accepted pose ride along, so each trial
    costs one evaluation. Returns (yaw, t, cost, J^T J entry-major)."""
    b = coords_2d.shape[0]

    def eval_ghc(pose):
        return gn_normal_equations(
            coords_2d, istd, coords_3d, cam_mats, u_range, v_range,
            cfg.z_min, pose[:, :1], pose[:, 1:], inlier_mask,
        )

    pose = torch.cat([yaw0, t0], dim=1)
    lam = torch.full((b,), cfg.lm_lambda_init, dtype=pose.dtype, device=pose.device)
    g, h, cost = eval_ghc(pose)
    eye = torch.eye(4, dtype=pose.dtype, device=pose.device)[:, :, None]
    idx = torch.arange(4, device=pose.device)
    for _ in range(cfg.lm_iters):
        d = h[idx, idx]                                       # (4, b)
        damped = h + eye * (lam[None] * d.clamp(min=1e-8))
        pose_new = pose + spd_solve_packed(damped, -g)
        g_new, h_new, cost_new = eval_ghc(pose_new)
        accept = (cost_new < cost) & torch.isfinite(cost_new)
        pose = torch.where(accept[:, None], pose_new, pose)
        g = torch.where(accept[None], g_new, g)
        h = torch.where(accept[None, None], h_new, h)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, lam * cfg.lm_lambda_down, lam * cfg.lm_lambda_up)
        lam = lam.clamp(1e-10, 1e8)
    return pose[:, :1], pose[:, 1:], cost, h


def pnp_uncert(
    coords_2d: Tensor,        # (b, n, 2)
    coords_2d_istd: Tensor,   # (b, n, 2)
    coords_3d: Tensor,        # (b, n, 3)
    cam_mats: Tensor,         # (b, 3, 3)
    u_range: Tensor,          # (b, 2)
    v_range: Tensor,          # (b, 2)
    ransac_thr: Optional[Tensor] = None,   # (b,) or None (no RANSAC)
    ransac_keys: Optional[Tensor] = None,  # (b, H, n) uniform draws
    cfg: PnPConfig = PnPConfig(),
    generator: Optional[torch.Generator] = None,
) -> PnPResult:
    """Full uncertainty PnP: pre-filter -> init -> LM -> covariance."""
    with torch.no_grad():
        istd = coords_2d_istd
        if cfg.coord_istd_normalize:
            mean = istd.mean(dim=(1, 2), keepdim=True)
            istd = istd / mean.clamp(min=cfg.eps)
        valid0 = istd_inlier_mask(istd, cfg.istd_thres)

        if ransac_thr is not None:
            if ransac_keys is None:
                b, n = valid0.shape
                ransac_keys = uniform((b, cfg.ransac_hypotheses, n), generator,
                                      coords_2d.device)
            yaw0, t0, inlier = ransac_yaw_pnp(
                ransac_keys, coords_2d, istd, valid0, coords_3d, cam_mats,
                ransac_thr, cfg,
            )
        else:
            yaw0, t0 = dlt_yaw_pnp(
                coords_2d, istd.mean(-1) * valid0, coords_3d, cam_mats
            )
            inlier = valid0

        opt_mask = inlier if cfg.inlier_opt_only else None
        yaw, t, cost, hess = lm_refine(
            coords_2d, istd, coords_3d, cam_mats, u_range, v_range,
            yaw0, t0, opt_mask, cfg,
        )
        if cfg.exact_hessian:
            hess = exact_hessian(
                coords_2d, istd, coords_3d, cam_mats, u_range, v_range,
                cfg.z_min, yaw, t, opt_mask,
            ).permute(1, 2, 0)
        cov_valid = spd_valid_packed(hess, rel=1e-9)
        eye = torch.eye(4, dtype=hess.dtype, device=hess.device)
        cov = spd_inverse_packed(
            torch.where(cov_valid[None, None], hess, eye[:, :, None])
        )
        valid = (
            cov_valid
            & torch.isfinite(cost)
            & torch.isfinite(yaw).all(dim=1)
            & torch.isfinite(t).all(dim=1)
            & (inlier.sum(dim=1) >= cfg.ransac_min_points)
        )
        # failed slots are sanitised at the source
        yaw = torch.where(valid[:, None], yaw, torch.zeros_like(yaw))
        t = torch.where(valid[:, None], t, t.new_tensor([0.0, 0.0, 10.0]))
        cov = torch.where(valid[:, None, None], cov, eye)
    return PnPResult(valid=valid, yaw=yaw, t_vec=t, pose_cov=cov, inlier_mask=inlier)
