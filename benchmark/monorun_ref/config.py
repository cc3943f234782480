"""Typed configuration: the frozen dataclasses of the port's
``config.py``. The benchmark fills them from a cell's configuration file
(``benchlib/spec.py:build_config``); the presets stay with the port."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    depth: int = 101
    frozen_stages: int = 1          # stem + layer1 frozen
    norm_eval: bool = True          # BN always uses running stats
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)


@dataclasses.dataclass(frozen=True)
class NeckConfig:
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5               # P2..P6
    num_lower_outs: int = 1         # extra stride-2 level (FPNplus)
    # Lazy stride-2 level: keep the ``lower0`` 3x3 conv on the stride-4
    # lateral grid instead of materialising it on the 2x-upsampled grid
    # (fpn_plus.py:79-91 computes conv(up2(lateral0)) densely). This is an
    # APPROXIMATION: the conv's tap pitch doubles, so the level deviates
    # from the reference's by the kernel-first-moment term (median ~3% of
    # the level std on smooth fields, ~18% on white-noise content;
    # measured bounds in tests/test_fpn_lazy.py). It removes the
    # 145 GFLOP/img dense conv + the 60 MB stride-2 tensor, and is the
    # default for training from scratch (weights adapt to the grid they
    # see; AP-guarded by tests/test_e2e_synthetic.py). Loading a converted
    # reference .pth checkpoint defaults this OFF for faithful semantics
    # (apis/inference.init_inference).
    lazy_lower: bool = True


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    scales: Tuple[float, ...] = (5.0,)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    in_channels: int = 256
    feat_channels: int = 256
    starting_level: int = 1         # skip the stride-2 FPN level
    anchors: AnchorConfig = AnchorConfig()
    # proposal generation
    nms_pre: int = 1000             # per level
    nms_post: int = 1000
    nms_thr: float = 0.75
    min_bbox_size: float = 0.0
    train_nms_pre: int = 2000
    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class BBoxHeadConfig:
    in_channels: int = 256
    fc_out_channels: int = 1024
    roi_feat_size: int = 7
    num_classes: int = 3
    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    reg_class_agnostic: bool = False
    finest_scale: float = 20.0      # RoI extractor level mapping
    featmap_strides: Tuple[int, ...] = (2, 4, 8, 16, 32)
    # adaptive bin-sampling cap for the 7x7 aligns. mmcv RoIAlign with
    # sampling_ratio=0 averages ceil(span/bins) samples per bin UNCAPPED
    # (reference configs/kitti_multiclass.py:40); 6 covers every RoI the
    # mmdet level mapping admits up to effective aspect ~4.6 and is
    # golden-parity tested (tests/test_golden_detector.py)
    align_max_ratio: int = 6


@dataclasses.dataclass(frozen=True)
class GlobalHeadConfig:
    latent_channels: int = 16
    num_fcs: int = 2
    in_channels: int = 256
    fc_out_channels: int = 1024
    num_classes: int = 3
    roi_feat_size: int = 7
    latent_class_agnostic: bool = False
    dropout_rate: float = 0.5
    dropout2d_rate: float = 0.2
    num_dropout_layers: int = 2
    mc_samples: int = 50
    # MC-dropout bit generation via XLA's hardware RngBitGenerator (~10x
    # cheaper than threefry for the (n, S, 1024) masks) — NOT guaranteed
    # bit-stable across backends/compiler versions; False restores
    # threefry for bitwise cross-platform reproducibility
    mc_fast_rng: bool = True
    dim_means: Tuple[Tuple[float, float, float], ...] = (
        (3.89, 1.53, 1.62), (0.82, 1.78, 0.63), (1.77, 1.72, 0.57))
    dim_stds: Tuple[Tuple[float, float, float], ...] = (
        (0.44, 0.14, 0.11), (0.25, 0.13, 0.12), (0.15, 0.10, 0.14))


@dataclasses.dataclass(frozen=True)
class NOCHeadConfig:
    num_convs: int = 3
    in_channels: int = 256
    conv_out_channels: int = 256
    num_classes: int = 3
    class_agnostic: bool = False
    num_convs_upsampled: int = 1
    noc_channels: int = 3
    uncert_channels: int = 2
    dropout2d_rate: float = 0.2
    flip_correction: bool = True
    latent_channels: int = 16
    with_lidar_loss: bool = False   # loss_noc on (_lidar_supv presets)
    finest_scale: float = 28.0
    featmap_strides: Tuple[int, ...] = (2, 4, 8, 16, 32)
    roi_size: int = 14
    dense_size: int = 28
    # adaptive bin-sampling cap for the 14x14 align (see
    # BBoxHeadConfig.align_max_ratio; 4 is mmcv-exact at this grid)
    align_max_ratio: int = 4
    carafe_up_kernel: int = 5
    carafe_encoder_kernel: int = 3
    carafe_compressed_channels: int = 64
    noc_means: Tuple[float, float, float] = (-0.1, -0.5, 0.0)
    noc_stds: Tuple[float, float, float] = (0.35, 0.23, 0.34)


@dataclasses.dataclass(frozen=True)
class ProjectionHeadConfig:
    z_min: float = 0.5
    allowed_border: float = 200.0
    ref_length: float = 1.6
    ref_focal_y: float = 722.0
    target_std: float = 0.15
    distance_mode: str = "range"    # or "z-depth"
    loss_weight: float = 1.0
    loss_momentum: float = 0.1


@dataclasses.dataclass(frozen=True)
class PoseHeadConfig:
    z_min: float = 0.5
    epnp_istd_thres: float = 0.6
    inlier_opt_only: bool = True
    allowed_border: float = 200.0
    epnp_ransac_thres_ratio: float = 0.2
    std_scale: float = 10.0
    ransac_hypotheses: int = 32
    lm_iters: int = 8
    # exact second-order LS Hessian for the pose covariance (reference
    # hessian.py:5-64; shipped OFF at configs/kitti_multiclass.py:128)
    forward_exact_hessian: bool = False
    # starts at 0 and is switched on by the default loss_schedule entry
    # (reference LossUpdaterHook, configs/kitti_multiclass.py:315-325)
    loss_calib_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class LossScheduleEntry:
    """One scheduled config swap — the generic equivalent of the reference
    LossUpdaterHook (runner/hooks/loss_updater.py:17-57): when the global
    step reaches ``step``, the dotted ``attr`` path of the model config is
    set to ``value`` and the train step is re-specialised. The shipped
    presets use it to enable loss_calib after iteration 100."""

    step: int
    attr: str
    value: Any


@dataclasses.dataclass(frozen=True)
class ScoreHeadConfig:
    reg_fc_out_channels: int = 1024
    pose_fc_out_channels: int = 1024
    fc_out_channels: int = 256
    use_pose_norm: bool = True
    pose_norm_momentum: float = 0.01
    mode: str = "linear_average"
    iou_thres: float = 0.7
    linear_coefs: Tuple[float, float] = (-0.5, 2.0)
    # IoU3DBalancedSampler
    sampler_pos_iou_thr: float = 0.5
    sampler_pos_fraction_min: float = 0.25
    sampler_pos_fraction_max: float = 0.75
    sampler_smooth_keeprate: bool = True


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    # RPN assign/sample
    rpn_pos_iou_thr: float = 0.7
    rpn_neg_iou_thr: float = 0.3
    rpn_min_pos_iou: float = 0.3
    rpn_ignore_iof_thr: float = 0.5
    rpn_num_samples: int = 256
    rpn_pos_fraction: float = 0.5
    # RCNN assign/sample
    rcnn_pos_iou_thr: float = 0.6
    rcnn_neg_iou_thr: float = 0.6
    rcnn_min_pos_iou: float = 0.6
    rcnn_ignore_iof_thr: float = 0.6
    rcnn_num_samples: int = 512
    rcnn_pos_fraction: float = 0.25
    add_gt_as_proposals: bool = True
    max_pos: int = 128              # static positive-RoI capacity
    # Cascade-R-CNN-style re-assign+resample after bbox refinement
    # (monorun_roi_head.py:141-166, bbox_refined_assigner/sampler). The
    # reference supports it but no shipped config enables it; OFF keeps
    # the default positive-RoI-refinement branch.
    refined_reassign: bool = False
    dense_size: int = 28
    calib_scoring: bool = True
    # GT-substitution head-isolation mode (monorun_roi_head.py:323-324,
    # 357-361; config train_cfg debug, configs/kitti_multiclass.py:163,194):
    # replace predicted dims (and, with lidar supervision, the NOC map +
    # proj_logstd) with their targets so downstream losses (projection,
    # PnP calibration, score) are driven by ground-truth-quality inputs
    debug: bool = False
    # schedule
    optimizer: str = "adamw"
    lr: float = 2.0e-4
    weight_decay: float = 0.01
    grad_clip_norm: float = 35.0
    # per-param-group clipping (reference OptimizerHookMod paramwise_cfg,
    # runner/hooks/optimizer.py:72-92 — shipped unused there): params
    # whose dotted path contains a key form their own clip group with
    # that max_norm; first match wins; the rest clip at grad_clip_norm
    grad_clip_paramwise: Tuple[Tuple[str, float], ...] = ()
    # JSONL per-parameter gradient/weight statistic dumps every N steps
    # to <workdir>/grad_stats.jsonl (reference save_stats text dumps,
    # runner/hooks/optimizer.py:29-57); 0 disables
    save_stats_interval: int = 0
    warmup_iters: int = 500
    warmup_ratio: float = 0.001
    total_epochs: int = 50
    samples_per_device: int = 3
    checkpoint_interval: int = 2
    eval_interval: int = 2
    log_interval: int = 10
    log_grad_stats: bool = False
    tensorboard: bool = True   # reference TensorboardLoggerHook
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TestCfg:
    rpn_nms_pre: int = 1000
    rpn_nms_post: int = 1000
    rpn_nms_thr: float = 0.75
    score_thr: float = 0.05
    nms_iou_thr: float = 0.7
    max_per_img: int = 100
    # 3D heads (MC global, NOC decoder, PnP, score) run on only the
    # head_slots highest-2D-score detection slots; the tail is reported
    # invalid. The reference runs these heads on the dynamic set of NMS
    # survivors (monorun_roi_head.py simple_test) — usually well under
    # 48 on KITTI — while fixed shapes would pay all max_per_img slots
    # every frame. 0 = compute every slot (strict parity).
    head_slots: int = 48
    nms_3d_thr: float = 0.01
    mult_2d_score: bool = True
    calib_scoring: bool = True
    cov_correction: bool = True
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    classes: Tuple[str, ...] = ("Car", "Pedestrian", "Cyclist")
    train_root: str = "data/kitti/training/"
    test_root: str = "data/kitti/testing/"
    train_list: str = "mono3dsplit_train_list.txt"
    val_list: str = "mono3dsplit_val_list.txt"
    test_list: str = "test_list.txt"
    coord_3d_prefix: Optional[str] = None   # 'obj_crd/' for lidar supv
    img_mean: Tuple[float, float, float] = (95.80, 98.72, 93.82)
    img_std: Tuple[float, float, float] = (83.11, 81.65, 80.54)
    to_rgb: bool = True
    size_divisor: int = 32
    flip_ratio: float = 0.5
    # static padded shapes (KITTI images are <= 376 x 1242)
    pad_height: int = 384
    pad_width: int = 1280
    # native-resolution uint8 serving canvas (on-device preprocessing,
    # data/pipeline.py:device_preprocess): images are pasted top-left
    # unresized; resize/normalize/pad run inside the jitted program.
    # Stays at the scale-1.0 padded size even when test_scale < 1.
    raw_height: int = 384
    raw_width: int = 1280
    max_gt: int = 64
    workers: int = 2
    # test-time input downscale (architectural FLOP cut, NOT reference
    # behaviour — the reference evaluates at native resolution). Images
    # and intrinsics are scaled together, so PnP still solves in metric
    # space; predicted 2D boxes are mapped back to native coords before
    # evaluation/submission (apis/test.py). Pair with matching
    # pad_height/pad_width. AP cost must be validated per the protocol
    # in README 'Fast presets'.
    test_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class MonoRUnConfig:
    name: str = "kitti_multiclass"
    backbone: BackboneConfig = BackboneConfig()
    neck: NeckConfig = NeckConfig()
    rpn: RPNConfig = RPNConfig()
    bbox_head: BBoxHeadConfig = BBoxHeadConfig()
    global_head: GlobalHeadConfig = GlobalHeadConfig()
    noc_head: NOCHeadConfig = NOCHeadConfig()
    projection_head: ProjectionHeadConfig = ProjectionHeadConfig()
    pose_head: PoseHeadConfig = PoseHeadConfig()
    score_head: ScoreHeadConfig = ScoreHeadConfig()
    train: TrainCfg = TrainCfg()
    test: TestCfg = TestCfg()
    data: DataConfig = DataConfig()
    compute_dtype: str = "bfloat16"   # conv/matmul dtype on TPU
    # scheduled config swaps by dotted path (LossUpdaterHook equivalent);
    # default mirrors configs/kitti_multiclass.py:315-325
    loss_schedule: Tuple[LossScheduleEntry, ...] = (
        LossScheduleEntry(100, "pose_head.loss_calib_weight", 0.01),
    )

    @property
    def num_classes(self) -> int:
        return len(self.data.classes)
