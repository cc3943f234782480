"""MonoRUn detector: the PyTorch counterpart of
``monorun_tpu/models/detector.py`` (``__call__`` as ``forward``,
``serve_raw``, ``heads_forward``,
``extract_feats``, ``calibrated_cov``, and ``train_forward`` for the
training losses).

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
``HeadDraws``, and what is not passed is drawn from the caller's
generator; the training step's comes as ``TrainDraws``, all of it, or
from the generator through ``utils/draws.py:train_draws``.

The serving forward's stages (``utils/stages.py:STAGES``) are marked with
``self.stage(name)``, a null context unless a profiling tool installs a
timer on the model (``utils/stages.py:timing``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..coders import DimCoder, NOCCoder, ProjErrorCoder
from ..config import MonoRUnConfig
from ..data.pipeline import device_preprocess, scale_intrinsics
from ..losses import (
    kl_loss_mv, robust_kl_loss, sigmoid_bce_loss, smooth_l1_loss, softmax_ce_loss,
)
from ..ops.box_coder import delta_decode, delta_encode
from ..ops.clip import clip
from ..ops.geometry import project_points
from ..ops.linalg_small import spd_inverse
from ..ops.nms import NEG_INF, nms_rotated_bev
from ..ops.pnp import PnPConfig, pnp_uncert
from ..ops.roi_align import (
    align_strides, multilevel_roi_align_auto, prepare_pyramid, roi_grid_centers,
)
from ..ops.rotated_iou import bbox3d_overlaps_aligned
from ..parallel import global_mean, global_sum
from ..targets.assigner import AssignCfg, assign_max_iou
from ..targets.dense_target import encode_noc_points, sparse_noc_targets
from ..targets.rpn_targets import rpn_loss
from ..targets.sampler import SampleResult, sample_rois
from ..utils.draws import TrainDraws, train_draws
from ..utils.stages import NULL
from .bbox_head import BBoxHead, get_det_bboxes
from .fpn import FPNplus
from .global_head import GlobalHead, slice_pred
from .noc_head import NOCHead
from .resnet import ResNet
from .rpn import RPNHead, get_proposals
from .score_head import ScoreHead, iou3d_balanced_sample_weights, score_targets

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
        self.stage_hook = None      # utils/stages.py:timing

    # ---- shared pieces ---------------------------------------------------

    def stage(self, name: str):
        """The context the forward's stage ``name`` runs under."""
        return NULL if self.stage_hook is None else self.stage_hook(name)

    def extract_feats(self, images: Tensor) -> Tuple[Tensor, ...]:
        """(B, H, W, 3) normalised batch -> FPN levels, NHWC."""
        return self.neck(self.backbone(images.to(self.dtype)))

    def calibrated_cov(self, pose_cov: Tensor) -> Tensor:
        s = torch.exp(self.roi_head.pose_head.cov_calib_logscale)
        return (s[:, None] * s[None, :]) * pose_cov

    def forward(
        self, images: Tensor, cam_intrinsic: Tensor, img_shapes: Tensor,
        draws: HeadDraws = HeadDraws(),
        generator: Optional[torch.Generator] = None,
    ) -> Detections:
        """Normalised, padded (B, H, W, 3) batch in, detections out (the
        JAX package's ``MonoRUn.__call__``). ``cam_intrinsic`` is the K of
        the images as given, ``img_shapes`` their (h, w) before padding."""
        with self.stage("backbone_fpn"):
            feats = self.extract_feats(images)
        return self.heads_forward(
            feats, cam_intrinsic, img_shapes, (images.shape[1], images.shape[2]),
            draws, generator,
        )

    def serve_raw(
        self, raw: Tensor, cam_native: Tensor, raw_shapes: Tensor,
        draws: HeadDraws = HeadDraws(),
        generator: Optional[torch.Generator] = None,
    ) -> Detections:
        """uint8 canvas in, detections out: preprocessing, backbone and
        heads. ``cam_native`` is the native-resolution K."""
        cfg = self.cfg
        with self.stage("preprocess"):
            images, shapes = device_preprocess(raw, raw_shapes, cfg.data)
            cam = scale_intrinsics(cam_native, cfg.data.test_scale)
        with self.stage("backbone_fpn"):
            feats = self.extract_feats(images)
        return self.heads_forward(
            feats, cam, shapes, (cfg.data.pad_height, cfg.data.pad_width),
            draws, generator,
        )

    # ---- inference -------------------------------------------------------

    def _align(self, feats, rois, head_cfg, out_size, tile_h, pyramid):
        n_lvl = len(head_cfg.featmap_strides)
        return multilevel_roi_align_auto(
            feats[:n_lvl], rois,
            align_strides(self.cfg.neck.lazy_lower, head_cfg.featmap_strides),
            out_size, head_cfg.finest_scale, max_ratio=head_cfg.align_max_ratio,
            tile_h=tile_h, pyramid=pyramid,
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

        with self.stage("rpn_proposals"):
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
        with self.stage("align_proposals"):
            rs = cfg.bbox_head.roi_feat_size
            # one dual-orientation pyramid shared by the three aligns (None
            # unless the environment selects a staged kernel)
            pyr = prepare_pyramid(feats[: len(cfg.bbox_head.featmap_strides)])
            roi_feats = self._align(feats, rois, cfg.bbox_head, (rs, rs), 24, pyr)
        with self.stage("bbox_head_nms"):
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

        with self.stage("global_head_mc"):
            # ---- global head (factored MC dropout) ---------------------------
            reg_feats = self._align(feats, det_rois, cfg.bbox_head, (rs, rs), 24, pyr)
            gout = heads.global_head(reg_feats, draws.mc_masks, generator)
            dim_enc, dim_var_enc, latent, _ = slice_pred(
                cfg.global_head, gout.dim_latent_pred, gout.dim_latent_var,
                flat_labels,
            )
            dim_coder = DimCoder(cfg.global_head.dim_means, cfg.global_head.dim_stds)
            dims, dims_var = dim_coder.decode(dim_enc, dim_var_enc, flat_labels)

        with self.stage("noc_head"):
            # ---- NOC head -----------------------------------------------------
            ns = cfg.noc_head.roi_size
            noc_feats = self._align(feats, det_rois, cfg.noc_head, (ns, ns), 32, pyr)
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

        with self.stage("pnp"):
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

        with self.stage("score_3d_nms"):
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


    # ---- training ----------------------------------------------------------

    def _sample(self, cfg, noise, cand_boxes, cand_valid, batch) -> SampleResult:
        """R-CNN assignment and sampling of every image, stacked (B, ...)."""
        tr = cfg.train
        acfg = AssignCfg(
            pos_iou_thr=tr.rcnn_pos_iou_thr, neg_iou_thr=tr.rcnn_neg_iou_thr,
            min_pos_iou=tr.rcnn_min_pos_iou, ignore_iof_thr=tr.rcnn_ignore_iof_thr,
        )
        per_image = []
        for b in range(cand_boxes.shape[0]):
            res = assign_max_iou(
                cand_boxes[b], cand_valid[b], batch["gt_boxes"][b], batch["gt_valid"][b],
                batch["gt_labels"][b], acfg, ignore_boxes=batch["ignore_boxes"][b],
                ignore_valid=batch["ignore_valid"][b],
            )
            per_image.append(sample_rois(
                (noise[0][b], noise[1][b]), cand_boxes[b], res.assigned_gt, res.labels,
                tr.rcnn_num_samples, tr.rcnn_pos_fraction, max_pos=tr.max_pos,
            ))
        return SampleResult(*(torch.stack(f) for f in zip(*per_image)))

    def train_forward(
        self,
        batch: Dict[str, Tensor],
        loss_ema: Tensor,
        draws: TrainDraws = TrainDraws(),
        generator: Optional[torch.Generator] = None,
        cfg: Optional[MonoRUnConfig] = None,
    ):
        """Training losses of one batch (``monorun_tpu/models/detector.py:
        _train_forward``), with the JAX package's gradient paths: the
        proposals stay differentiable (through the regression targets, the
        RoI grid and the aligns' RoI gradient), and the refinement deltas,
        the PnP inputs and outputs, the IoUs and the calibration error carry
        none. ``cfg`` overrides the model's config (the loss schedule).
        ``draws`` holds every random input, or none: then they are
        ``utils/draws.py:train_draws``' from ``generator``.

        Under data parallelism the batch is this rank's rows of the global
        batch, and every reduction across samples is the global batch's
        (``parallel/``): the losses' denominators (``losses.py``), the
        projection loss's EMA, the score head's BatchNorm moments and
        sampler counts, ``samp_w``'s mean and ``mean_iou``'s count; the
        NOC targets' weights are normalised per image, as in JAX. Each
        loss is then this rank's share of the global loss.

        batch: images (B, H, W, 3), cam (B, 3, 3), img_shapes (B, 2),
        scale_factor (B, 2), crop_offset (B, 2), gt_boxes (B, G, 4),
        gt_labels (B, G), gt_valid (B, G), ignore_boxes (B, I, 4),
        ignore_valid (B, I), gt_bboxes_3d (B, G, 7) [l, h, w, x, y, z, ry],
        flip (B,), uv (B, G, Q, 2), oc (B, G, Q, 3), pts_valid (B, G, Q).

        Returns (total_loss, (losses and metrics, new_loss_ema))."""
        cfg = self.cfg if cfg is None else cfg
        tr = cfg.train
        heads = self.roi_head
        images = batch["images"]
        B, H, W = images.shape[:3]
        dev = images.device
        pad_shape = (H, W)
        K = cfg.bbox_head.num_classes
        gt_boxes = batch["gt_boxes"]

        if all(d is None for d in draws):
            draws = train_draws(cfg, B, pad_shape, gt_boxes.shape[1], generator, dev)

        feats = self.extract_feats(images)
        cls_scores, bbox_preds = self.rpn_head(feats[cfg.rpn.starting_level:])
        losses = rpn_loss(
            draws.rpn_noise, cls_scores, bbox_preds, gt_boxes, batch["gt_valid"],
            batch["ignore_boxes"], batch["ignore_valid"], cfg.rpn, tr,
        )
        proposals, prop_valid = get_proposals(
            cls_scores, bbox_preds, cfg.rpn, pad_shape, cfg.rpn.train_nms_pre,
            cfg.rpn.nms_post, valid_shapes=batch["img_shapes"],
        )

        # ---- assign + sample, the GTs added as proposals ----------------------
        cand_boxes = torch.cat([proposals, gt_boxes], 1)
        cand_valid = torch.cat([prop_valid, batch["gt_valid"]], 1)
        samp = self._sample(cfg, draws.rcnn_noise, cand_boxes, cand_valid, batch)
        P = tr.max_pos
        Ns = tr.rcnn_num_samples
        all_boxes = torch.cat([samp.pos_boxes, samp.neg_boxes], 1)
        all_valid = torch.cat([samp.pos_valid, samp.neg_valid], 1)
        batch_col = torch.arange(B, dtype=all_boxes.dtype, device=dev)
        rois = torch.cat([batch_col.repeat_interleave(Ns)[:, None], all_boxes.reshape(-1, 4)], 1)
        rs = cfg.bbox_head.roi_feat_size
        roi_feats = self._align(feats, rois, cfg.bbox_head, (rs, rs), 24, None)
        cls_logits, deltas = heads.bbox_head(roi_feats)

        # ---- bbox head losses ----------------------------------------------
        labels_all = torch.cat(
            [samp.pos_labels, torch.full((B, Ns - P), K, dtype=samp.pos_labels.dtype,
                                         device=dev)], 1).reshape(-1)
        valid_flat = all_valid.reshape(-1)
        n_total = valid_flat.sum()
        losses["loss_cls"] = softmax_ce_loss(cls_logits, labels_all,
                                             weight=valid_flat.float(), avg_factor=n_total)
        pos_gt_boxes = torch.gather(gt_boxes, 1, samp.pos_gt_inds[..., None].expand(-1, -1, 4))
        bh = cfg.bbox_head
        reg_targets = delta_encode(samp.pos_boxes, pos_gt_boxes, bh.target_means,
                                   bh.target_stds)                    # (B, P, 4)
        deltas_k = deltas.reshape(B, Ns, K, 4)[:, :P]
        pos_deltas = torch.gather(
            deltas_k, 2, samp.pos_labels[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
        losses["loss_bbox"] = smooth_l1_loss(
            pos_deltas, reg_targets, beta=1.0, weight=samp.pos_valid[..., None].float(),
            avg_factor=n_total,
        )

        if tr.refined_reassign:
            # cascade-style re-assign and re-sample against the class-refined
            # boxes (the assigned class for positives, the predicted one for
            # the rest), GT-sourced positives dropped, GTs appended again
            deltas_sg = deltas.detach().reshape(B, Ns, K, 4)
            pred_lbl = cls_logits.detach().reshape(B, Ns, -1)[..., :K].argmax(-1)
            lbl_mat = labels_all.reshape(B, Ns)
            roi_lbl = torch.where(lbl_mat == K, pred_lbl, lbl_mat)
            sel_deltas = torch.gather(
                deltas_sg, 2, roi_lbl[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
            refined_all = delta_decode(all_boxes, sel_deltas, bh.target_means,
                                       bh.target_stds, max_shape=pad_shape)
            pos_is_gt = samp.pos_inds >= proposals.shape[1]
            refined_valid = torch.cat([samp.pos_valid & ~pos_is_gt, samp.neg_valid], 1)
            cand2 = torch.cat([refined_all, gt_boxes], 1)
            cand2_valid = torch.cat([refined_valid, batch["gt_valid"]], 1)
            samp = self._sample(cfg, draws.rcnn_noise_refined, cand2, cand2_valid, batch)
            pos_boxes = samp.pos_boxes
        else:
            # positive-RoI refinement by the assigned class, without gradient
            # through the deltas
            refined = delta_decode(samp.pos_boxes, pos_deltas.detach(), bh.target_means,
                                   bh.target_stds, max_shape=pad_shape)
            pos_boxes = torch.where(samp.pos_valid[..., None], refined, samp.pos_boxes)

        # ---- 3D heads on the positive slots ----------------------------------
        npos = B * P
        pos_rois = torch.cat([batch_col.repeat_interleave(P)[:, None],
                              pos_boxes.reshape(-1, 4)], 1)
        flat_pos_valid = samp.pos_valid.reshape(-1)
        flat_pos_labels = samp.pos_labels.reshape(-1)
        pos_gt_3d = torch.gather(batch["gt_bboxes_3d"], 1,
                                 samp.pos_gt_inds[..., None].expand(-1, -1, 7)).reshape(-1, 7)

        reg_feats = self._align(feats, pos_rois, cfg.bbox_head, (rs, rs), 24, None)
        gout = heads.global_head.forward_train(reg_feats, draws.global_masks)
        dim_enc, _, latent, _ = slice_pred(cfg.global_head, gout.dim_latent_pred, None,
                                           flat_pos_labels)
        dim_coder = DimCoder(cfg.global_head.dim_means, cfg.global_head.dim_stds)
        dim_targets = dim_coder.encode(pos_gt_3d[:, :3], flat_pos_labels)
        losses["loss_dim"] = smooth_l1_loss(dim_enc, dim_targets, beta=1.0,
                                            weight=flat_pos_valid[:, None].float())
        if tr.debug:
            dim_enc = dim_targets     # head isolation: downstream sees GT dims

        nh = cfg.noc_head
        noc_feats = self._align(feats, pos_rois, nh, (nh.roi_size, nh.roi_size), 32, None)
        flip_pos = batch["flip"].repeat_interleave(P)
        nout = heads.noc_head(noc_feats, latent, flat_pos_labels, flip_pos, draws.noc_mask)
        noc_pred, proj_logstd_enc = nout.noc_pred, nout.proj_logstd
        dsz = nh.dense_size
        if nh.with_lidar_loss:
            oc_enc = encode_noc_points(
                batch["oc"], batch["gt_bboxes_3d"][:, :, None, :3],
                batch["flip"][:, None, None], nh.noc_means, nh.noc_stds,
            )                                                        # (B, G, Q, 3)
            tg, wg = zip(*(sparse_noc_targets(
                pos_boxes[b], samp.pos_valid[b], samp.pos_gt_inds[b], batch["uv"][b],
                oc_enc[b], batch["pts_valid"][b], dsz) for b in range(B)))
            tg = torch.stack(tg).reshape(-1, dsz, dsz, 3)
            wg = torch.stack(wg).reshape(-1, dsz, dsz, 1)
            losses["loss_noc"] = smooth_l1_loss(
                nout.noc_pred, tg, beta=1.0,
                weight=wg * flat_pos_valid[:, None, None, None].float(),
            )
            if tr.debug:
                # head isolation: GT NOC targets, and a log-std from the
                # target weights on both channels
                noc_pred = tg
                w_dbg = clip(wg, 1e-6, 1e6)
                proj_logstd_enc = torch.broadcast_to(-torch.log(w_dbg),
                                                     noc_pred.shape[:3] + (2,))

        # ---- decode + projection loss ----------------------------------------
        noc_coder = NOCCoder(nh.noc_means, nh.noc_stds)
        dims, _ = dim_coder.decode(dim_enc, None, flat_pos_labels)
        coords_3d, _ = noc_coder.decode(noc_pred, None, dims, None, flip_pos)
        coords_2d_roi = roi_grid_centers(pos_rois, (dsz, dsz))
        cams_pos = batch["cam"].repeat_interleave(P, 0)
        shapes_pos = batch["img_shapes"].repeat_interleave(P, 0)
        # the grid lives in augmented image coordinates and the 3D geometry in
        # the original camera frame: undo flip, then crop, then resize
        scale = batch["scale_factor"].repeat_interleave(P, 0)     # (n, 2) [sh, sw]
        crop = batch["crop_offset"].repeat_interleave(P, 0)       # (n, 2) [x, y]
        u_mirror = (shapes_pos[:, 1] - 1.0)[:, None, None]
        u = coords_2d_roi[..., 0]
        u = torch.where(flip_pos[:, None, None], u_mirror - u, u)
        u = (u + crop[:, 0, None, None]) / scale[:, 1, None, None]
        v = (coords_2d_roi[..., 1] + crop[:, 1, None, None]) / scale[:, 0, None, None]
        coords_2d_roi = torch.stack([u, v], -1)
        pose_gt = pos_gt_3d[:, 3:7]                                # [x, y, z, ry]
        if cfg.projection_head.distance_mode == "z-depth":
            distances = pos_gt_3d[:, 5:6]
        else:
            distances = torch.linalg.vector_norm(pos_gt_3d[:, 3:6], dim=1, keepdim=True)
        ph = cfg.projection_head
        coords_2d_proj = project_points(coords_3d, pose_gt, cams_pos, shapes_pos,
                                        z_min=ph.z_min, allowed_border=ph.allowed_border)
        proj_coder = ProjErrorCoder(ph.ref_length, ph.ref_focal_y, ph.target_std)
        proj_error = proj_coder.encode(coords_2d_proj - coords_2d_roi, distances)
        w_proj = flat_pos_valid[:, None, None, None].float().expand(proj_error.shape)
        loss_proj, new_ema = robust_kl_loss(
            proj_error, 0, proj_logstd_enc, loss_ema, weight=w_proj,
            momentum=ph.loss_momentum, training=True,
        )
        losses["loss_proj"] = loss_proj * ph.loss_weight

        # ---- pose (PnP, no gradient) + calibration loss ----------------------
        proj_logstd_dec = proj_coder.decode_logstd(proj_logstd_enc, None, distances)
        pose = cfg.pose_head
        istd = torch.exp(-proj_logstd_dec) / pose.std_scale
        border = pose.allowed_border
        lo = torch.full((npos,), -border, device=dev)
        u_range = torch.stack([lo, shapes_pos[:, 1] + border], -1)
        v_range = torch.stack([lo, shapes_pos[:, 0] + border], -1)
        roi_heights = coords_2d_roi[:, -1, 0, 1] - coords_2d_roi[:, 0, 0, 1]
        pnp = pnp_uncert(
            coords_2d_roi.reshape(npos, dsz * dsz, 2), istd.reshape(npos, dsz * dsz, 2),
            coords_3d.detach().reshape(npos, dsz * dsz, 3), cams_pos, u_range, v_range,
            ransac_thr=pose.epnp_ransac_thres_ratio * roi_heights,
            ransac_keys=draws.ransac_keys,
            cfg=PnPConfig(
                z_min=pose.z_min, istd_thres=pose.epnp_istd_thres,
                inlier_opt_only=pose.inlier_opt_only,
                ransac_hypotheses=pose.ransac_hypotheses, lm_iters=pose.lm_iters,
                exact_hessian=pose.forward_exact_hessian,
            ),
        )
        # a covariance that is not finite is replaced before the calibration,
        # whose gradient carries the covariance's value
        eye = torch.eye(4, device=dev)
        pc0 = pnp.pose_cov.reshape(npos, -1)
        pc_ok = torch.isfinite(pc0).all(-1) & (pc0.abs() < 1e18).all(-1)
        pose_cov_calib = self.calibrated_cov(
            torch.where(pc_ok[:, None, None], pnp.pose_cov, eye))
        pose_ok = pnp.valid & flat_pos_valid & pc_ok

        # score targets on predictions without gradient
        ious = bbox3d_overlaps_aligned(
            pos_gt_3d[:, [3, 4, 5, 0, 1, 2, 6]],
            torch.cat([pnp.t_vec, dims, pnp.yaw], 1).detach(),
        )
        ious = torch.where(pose_ok, ious, torch.zeros_like(ious))
        # this rank's share of the global batch's mean (the step sums the
        # ranks' metrics)
        losses["mean_iou"] = (ious * flat_pos_valid).sum() / clip(
            global_sum(flat_pos_valid.sum()), 1)

        # loss_calib: weight 0 until the loss schedule switches it on
        yaw_diff = (pnp.yaw[:, 0] - pose_gt[:, 3] + math.pi) % (2 * math.pi) - math.pi
        diff = clip(torch.cat([yaw_diff[:, None], pnp.t_vec - pose_gt[:, :3]], 1), -1e6, 1e6)
        cc0 = pose_cov_calib.detach().reshape(npos, -1)
        cov_ok = torch.isfinite(cc0).all(-1) & (cc0.abs() < 1e18).all(-1)
        inv_cov = calibration_inv_cov(pose_cov_calib, cov_ok)
        losses["loss_calib"] = kl_loss_mv(
            diff.detach(), 0, inv_cov, weight=(pose_ok & cov_ok)[:, None].float(),
        ) * pose.loss_calib_weight

        # ---- score head ------------------------------------------------------
        score_cov = pose_cov_calib if tr.calib_scoring else pnp.pose_cov
        logits = heads.score_head(gout.reg_fc_out.to(self.dtype), pnp.yaw, pnp.t_vec,
                                  score_cov, dims, train=True, valid=pose_ok)
        targets = score_targets(cfg.score_head, ious)
        samp_w = iou3d_balanced_sample_weights(cfg.score_head, ious, draws.score_uniform,
                                               valid=pose_ok)
        samp_w = samp_w / clip(global_mean(samp_w), 1e-2)
        losses["loss_score"] = sigmoid_bce_loss(
            logits[:, None], targets[:, None], weight=samp_w[:, None],
            avg_factor=pose_ok.sum(),
        )

        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        return total, (losses, new_ema)


def calibration_inv_cov(pose_cov_calib: Tensor, cov_ok: Tensor) -> Tensor:
    """The inverse covariance of the calibration loss: the JAX package's
    ``spd_inverse(where(cov_ok, pose_cov_calib, 0) + I)``
    (``monorun_tpu/models/detector.py:833-840``), the same values. A finite
    but nearly singular covariance (a garbage PnP on a padded slot)
    overflows the unrolled Cholesky: ``kl_loss_mv`` then gives its row 0,
    but the inverse's backward at that matrix is still 0 x inf, and the
    JAX package's calibration-scale gradient turns NaN. Here such rows
    take the same non-finite inverse without a gradient, so every loss
    value, and every gradient that is finite in the JAX package, is
    unchanged."""
    eye = torch.eye(4, device=pose_cov_calib.device)
    safe = torch.where(cov_ok[:, None, None], pose_cov_calib, torch.zeros_like(pose_cov_calib))
    inv0 = spd_inverse(safe.detach() + eye)
    inv_ok = torch.isfinite(inv0.flatten(1)).all(-1)
    safe = torch.where(inv_ok[:, None, None], safe, torch.zeros_like(safe))
    return torch.where(inv_ok[:, None, None], spd_inverse(safe + eye), inv0)


# the standard deviation of N(0, 1) truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978


def truncated_normal(shape, generator: torch.Generator) -> Tensor:
    """flax's ``lecun_normal`` draw before its 1/sqrt(fan_in): N(0, 1)
    truncated to [-2, 2] (by the inverse CDF), rescaled to unit variance."""
    lo = 0.5 * math.erfc(math.sqrt(2.0))                  # Phi(-2)
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=generator,
                                             dtype=torch.float64)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0) / TRUNCATED_STD).float()


def init_random_weights(model: MonoRUn, generator: torch.Generator,
                        truncated: bool = False) -> MonoRUn:
    """Seeded random weights with the JAX package's init rules: every >= 2-D
    weight of variance 1/fan_in, biases and the calibration scales zero,
    BatchNorm scale/variance one and shift/mean zero, and the NOC head's
    latent decoder zero (its identity start). The weights are a normal
    draw, as the JAX package's serving init makes them
    (``_fast_init_variables``); ``truncated`` makes them flax's
    ``lecun_normal`` (a normal truncated at two standard deviations), as
    its training init does (``create_train_state``'s traced init)."""
    latent = model.roi_head.noc_head.latent_decoder.weight
    draw = truncated_normal if truncated else (
        lambda shape, generator: torch.randn(shape, generator=generator))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2 and p is not latent:
                fan_in = p[0].numel()
                p.copy_(draw(p.shape, generator) / fan_in ** 0.5)
            elif name.endswith("weight") and p.dim() == 1:
                p.fill_(1.0)                         # normalisation scales
            else:
                p.zero_()
        for name, b in model.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
    return model
