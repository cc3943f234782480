"""MonoRUn detector, serving path: the PyTorch counterpart of
``monorun_tpu/models/detector.py`` (``serve_raw``, ``heads_forward``,
``extract_feats``, ``calibrated_cov``).

backbone -> FPNplus -> RPN proposals -> bbox head + multiclass NMS ->
[global head (MC) -> dim decode -> NOC head -> coord decode -> log-std
decode -> PnP -> covariance calibration/correction -> score head] ->
per-class rotated-BEV 3D NMS. Batched over images and RoIs with static
shapes: B images give exactly (B, max_per_img) detection slots with
validity masks.

The module tree follows the reference's mmdet state-dict names
(``backbone.*``, ``neck.*``, ``rpn_head.*``, ``roi_head.{bbox,global,
noc,score,pose}_head.*``), so a reference checkpoint loads with
``load_state_dict``.

Randomness (the MC-dropout masks and the RANSAC keys) can be passed in as
``HeadDraws``; what is not passed is drawn from the caller's generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..coders import DimCoder, NOCCoder, ProjErrorCoder
from ..config import MonoRUnConfig
from ..data.pipeline import device_preprocess, scale_intrinsics
from ..ops.nms import NEG_INF, nms_rotated_bev
from ..ops.pnp import PnPConfig, pnp_uncert
from ..ops.roi_align import (
    align_strides, multilevel_roi_align_auto, roi_grid_centers,
)
from .bbox_head import BBoxHead, get_det_bboxes
from .fpn import FPNplus
from .global_head import GlobalHead, slice_pred
from .noc_head import NOCHead
from .resnet import ResNet
from .rpn import RPNHead, get_proposals
from .score_head import ScoreHead

Tensor = torch.Tensor


class Detections(NamedTuple):
    """Fixed-shape per-image detection results."""

    bboxes_2d: Tensor      # (B, M, 4) xyxy
    scores_2d: Tensor      # (B, M)
    labels: Tensor         # (B, M) int, -1 invalid
    bboxes_3d: Tensor      # (B, M, 8) [l, h, w, x, y, z, ry, score]
    valid: Tensor          # (B, M) bool (after 3D NMS)
    pose_cov: Tensor       # (B, M, 4, 4)
    extras: Dict[str, Tensor]


class HeadDraws(NamedTuple):
    """Random inputs of ``heads_forward``; None entries are drawn."""

    mc_masks: Optional[Tuple[Tensor, Tensor, Tensor]] = None  # global head
    ransac_keys: Optional[Tensor] = None                      # (B*K, H, n)


def compute_dtype(cfg: MonoRUnConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class PoseHead(nn.Module):
    """Holds the learnable covariance calibration scales."""

    def __init__(self):
        super().__init__()
        self.cov_calib_logscale = nn.Parameter(torch.zeros(4))


class RoIHead(nn.Module):
    def __init__(self, cfg: MonoRUnConfig):
        super().__init__()
        # the heads read the neck's width, as the JAX modules infer it
        c = cfg.neck.out_channels
        self.bbox_head = BBoxHead(dataclasses.replace(cfg.bbox_head, in_channels=c))
        self.global_head = GlobalHead(
            dataclasses.replace(cfg.global_head, in_channels=c)
        )
        self.noc_head = NOCHead(dataclasses.replace(cfg.noc_head, in_channels=c))
        self.score_head = ScoreHead(cfg.score_head)
        self.pose_head = PoseHead()


class MonoRUn(nn.Module):
    def __init__(self, cfg: MonoRUnConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.backbone = ResNet(cfg.backbone.depth, cfg.backbone.out_indices)
        self.neck = FPNplus(
            cfg.neck.in_channels, cfg.neck.out_channels, cfg.neck.num_outs,
            cfg.neck.num_lower_outs, cfg.neck.lazy_lower,
        )
        self.rpn_head = RPNHead(
            cfg.neck.out_channels, cfg.rpn.feat_channels,
            len(cfg.rpn.anchors.scales) * len(cfg.rpn.anchors.ratios),
        )
        self.roi_head = RoIHead(cfg)

    # ---- shared pieces ---------------------------------------------------

    def extract_feats(self, images: Tensor) -> Tuple[Tensor, ...]:
        """(B, H, W, 3) normalised batch -> FPN levels, NHWC."""
        return self.neck(self.backbone(images.to(self.dtype)))

    def calibrated_cov(self, pose_cov: Tensor) -> Tensor:
        s = torch.exp(self.roi_head.pose_head.cov_calib_logscale)
        return (s[:, None] * s[None, :]) * pose_cov

    def serve_raw(
        self, raw: Tensor, cam_native: Tensor, raw_shapes: Tensor,
        draws: HeadDraws = HeadDraws(),
        generator: Optional[torch.Generator] = None,
    ) -> Detections:
        """uint8 canvas in, detections out: preprocessing, backbone and
        heads. ``cam_native`` is the native-resolution K."""
        cfg = self.cfg
        images, shapes = device_preprocess(raw, raw_shapes, cfg.data)
        cam = scale_intrinsics(cam_native, cfg.data.test_scale)
        feats = self.extract_feats(images)
        return self.heads_forward(
            feats, cam, shapes, (cfg.data.pad_height, cfg.data.pad_width),
            draws, generator,
        )

    # ---- inference -------------------------------------------------------

    def _align(self, feats, rois, head_cfg, out_size):
        n_lvl = len(head_cfg.featmap_strides)
        return multilevel_roi_align_auto(
            feats[:n_lvl], rois,
            align_strides(self.cfg.neck.lazy_lower, head_cfg.featmap_strides),
            out_size, head_cfg.finest_scale, max_ratio=head_cfg.align_max_ratio,
        )

    def heads_forward(
        self,
        feats: Tuple[Tensor, ...],     # extract_feats output
        cam_intrinsic: Tensor,         # (B, 3, 3)
        img_shapes: Tensor,            # (B, 2) true (h, w) before padding
        pad_shape: Tuple[int, int],
        draws: HeadDraws = HeadDraws(),
        generator: Optional[torch.Generator] = None,
    ) -> Detections:
        """RPN -> proposals -> aligns -> heads -> PnP -> 3D NMS."""
        cfg = self.cfg
        tc = cfg.test
        heads = self.roi_head
        dev = cam_intrinsic.device
        B = cam_intrinsic.shape[0]
        M = tc.max_per_img
        cam_intrinsic = cam_intrinsic.float()
        img_shapes = img_shapes.float()

        cls_scores, bbox_preds = self.rpn_head(feats[cfg.rpn.starting_level:])
        proposals, prop_valid = get_proposals(
            cls_scores, bbox_preds, cfg.rpn, pad_shape, tc.rpn_nms_pre,
            tc.rpn_nms_post, valid_shapes=img_shapes,
        )                                               # (B, P, 4), (B, P)
        P = proposals.shape[1]
        batch_col = torch.arange(B, dtype=proposals.dtype, device=dev)
        rois = torch.cat(
            [batch_col.repeat_interleave(P)[:, None], proposals.reshape(B * P, 4)], 1
        )
        rs = cfg.bbox_head.roi_feat_size
        roi_feats = self._align(feats, rois, cfg.bbox_head, (rs, rs))
        cls_logits, deltas = heads.bbox_head(roi_feats)
        det_boxes, det_scores, det_labels, det_valid = get_det_bboxes(
            proposals, cls_logits.reshape(B, P, -1), deltas.reshape(B, P, -1),
            prop_valid, pad_shape, cfg.bbox_head, tc.score_thr,
            tc.nms_iou_thr, M,
        )                                               # (B, M, ...)
        det_labels = det_labels.clamp(0, cfg.bbox_head.num_classes - 1)

        # ---- head slots: the K best (score-sorted) detections per image --
        K = tc.head_slots if 0 < tc.head_slots < M else M
        hd_boxes = det_boxes[:, :K]
        hd_labels = det_labels[:, :K]
        hd_valid = det_valid[:, :K]
        flat_labels = hd_labels.reshape(B * K)
        det_rois = torch.cat(
            [batch_col.repeat_interleave(K)[:, None], hd_boxes.reshape(B * K, 4)], 1
        )

        # ---- global head (factored MC dropout) ---------------------------
        reg_feats = self._align(feats, det_rois, cfg.bbox_head, (rs, rs))
        gout = heads.global_head(reg_feats, draws.mc_masks, generator)
        dim_enc, dim_var_enc, latent, _ = slice_pred(
            cfg.global_head, gout.dim_latent_pred, gout.dim_latent_var,
            flat_labels,
        )
        dim_coder = DimCoder(cfg.global_head.dim_means, cfg.global_head.dim_stds)
        dims, dims_var = dim_coder.decode(dim_enc, dim_var_enc, flat_labels)

        # ---- NOC head -----------------------------------------------------
        ns = cfg.noc_head.roi_size
        noc_feats = self._align(feats, det_rois, cfg.noc_head, (ns, ns))
        flip = torch.zeros(B * K, dtype=torch.bool, device=dev)
        nout = heads.noc_head(noc_feats, latent, flat_labels, flip)
        noc_coder = NOCCoder(cfg.noc_head.noc_means, cfg.noc_head.noc_stds)
        coords_3d, coords_3d_var = noc_coder.decode(
            nout.noc_pred, None, dims, dims_var, flip
        )
        proj_coder = ProjErrorCoder(
            cfg.projection_head.ref_length, cfg.projection_head.ref_focal_y,
            cfg.projection_head.target_std,
        )
        proj_logstd = proj_coder.decode_logstd(nout.proj_logstd, coords_3d_var, None)

        # ---- PnP ----------------------------------------------------------
        dsz = cfg.noc_head.dense_size
        coords_2d_roi = roi_grid_centers(det_rois, (dsz, dsz))    # (BK, d, d, 2)
        istd = torch.exp(-proj_logstd) / cfg.pose_head.std_scale
        n_pts = dsz * dsz
        shapes_per_det = img_shapes.repeat_interleave(K, 0)
        border = cfg.pose_head.allowed_border
        lo = torch.full((B * K,), -border, device=dev)
        u_range = torch.stack([lo, shapes_per_det[:, 1] + border], -1)
        v_range = torch.stack([lo, shapes_per_det[:, 0] + border], -1)
        roi_heights = coords_2d_roi[:, -1, 0, 1] - coords_2d_roi[:, 0, 0, 1]
        ph = cfg.pose_head
        pnp = pnp_uncert(
            coords_2d_roi.reshape(B * K, n_pts, 2),
            istd.reshape(B * K, n_pts, 2),
            coords_3d.reshape(B * K, n_pts, 3),
            cam_intrinsic.repeat_interleave(K, 0),
            u_range, v_range,
            ransac_thr=ph.epnp_ransac_thres_ratio * roi_heights,
            ransac_keys=draws.ransac_keys,
            cfg=PnPConfig(
                z_min=ph.z_min, istd_thres=ph.epnp_istd_thres,
                inlier_opt_only=ph.inlier_opt_only,
                ransac_hypotheses=ph.ransac_hypotheses, lm_iters=ph.lm_iters,
                exact_hessian=ph.forward_exact_hessian,
            ),
            generator=generator,
        )

        pose_cov_calib = self.calibrated_cov(pnp.pose_cov)
        if tc.cov_correction:
            if cfg.projection_head.distance_mode == "z-depth":
                distance = pnp.t_vec[:, 2]
            else:
                distance = torch.linalg.vector_norm(pnp.t_vec, dim=1)
            pose_cov_calib = proj_coder.cov_correction(
                pose_cov_calib, distance.clamp(min=1e-3)
            )

        # ---- score head ----------------------------------------------------
        score_cov = pose_cov_calib if tc.calib_scoring else pnp.pose_cov
        logits = heads.score_head(
            gout.reg_fc_out.to(self.dtype), pnp.yaw, pnp.t_vec, score_cov, dims
        )
        zero = torch.zeros((), device=dev)
        scores_3d = torch.where(pnp.valid, torch.sigmoid(logits), zero)
        final_scores = (
            det_scores[:, :K].reshape(B * K) * scores_3d
            if tc.mult_2d_score else scores_3d
        )
        final_scores = torch.where(hd_valid.reshape(B * K), final_scores, zero)
        bboxes_3d = torch.cat(
            [dims, pnp.t_vec, pnp.yaw, final_scores[:, None]], 1
        ).reshape(B, K, 8)

        # ---- per-class rotated-BEV 3D NMS: one exact fixpoint pass per
        # image (fixpoint_iters=K), classes separated by centre offsets -----
        bev = bboxes_3d[..., [3, 5, 0, 2, 6]]                # x, z, l, w, ry
        off = hd_labels.to(bev.dtype) * 1e4
        bev = torch.cat([bev[..., :2] + off[..., None], bev[..., 2:]], -1)
        s = torch.where(hd_valid, bboxes_3d[..., 7], torch.full_like(bev[..., 0], NEG_INF))
        idx, v = nms_rotated_bev(bev, s, tc.nms_3d_thr, K, exact=False,
                                 fixpoint_iters=K)
        keep3d = torch.zeros((B, K), dtype=torch.bool, device=dev).scatter(1, idx, v)
        final_valid = hd_valid & keep3d & pnp.valid.reshape(B, K)
        bboxes_3d = torch.where(final_valid[..., None], bboxes_3d, zero)

        extras: Dict[str, Tensor] = {}
        if tc.debug:
            extras = dict(
                oc_maps=coords_3d.reshape(B, K, dsz, dsz, 3),
                std_maps=torch.exp(proj_logstd).reshape(B, K, dsz, dsz, 2),
                latent_vecs=latent.reshape(B, K, -1),
            )

        eye = torch.eye(4, device=dev)
        pose_cov_out = torch.where(
            final_valid[..., None, None], pose_cov_calib.reshape(B, K, 4, 4), eye
        )
        if K < M:
            # pad back to max_per_img slots; tail slots are invalid with an
            # identity covariance
            tail = M - K
            bboxes_3d = torch.cat([bboxes_3d, bboxes_3d.new_zeros(B, tail, 8)], 1)
            final_valid = torch.cat([final_valid, final_valid.new_zeros(B, tail)], 1)
            pose_cov_out = torch.cat(
                [pose_cov_out, eye.expand(B, tail, 4, 4)], 1
            )
            extras = {
                k: torch.cat([v, v.new_zeros((B, tail) + v.shape[2:])], 1)
                for k, v in extras.items()
            }

        return Detections(
            bboxes_2d=det_boxes, scores_2d=det_scores, labels=det_labels,
            bboxes_3d=bboxes_3d, valid=final_valid, pose_cov=pose_cov_out,
            extras=extras,
        )


def init_random_weights(model: MonoRUn, generator: torch.Generator) -> MonoRUn:
    """Seeded random weights with the JAX package's serving-init rules:
    every >= 2-D weight ~ N(0, 1/fan_in), biases and the calibration
    scales zero, BatchNorm scale/variance one and shift/mean zero, and the
    NOC head's latent decoder zero (its identity start)."""
    latent = model.roi_head.noc_head.latent_decoder.weight
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2 and p is not latent:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator) / fan_in ** 0.5)
            elif name.endswith("weight") and p.dim() == 1:
                p.fill_(1.0)                         # normalisation scales
            else:
                p.zero_()
        for name, b in model.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
    return model
