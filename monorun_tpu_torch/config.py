"""Typed configuration system with the six reference presets.

Replaces the reference's mmcv python-file configs + registry construction
(configs/*.py, core/bbox_3d/builder.py) with frozen dataclasses. Presets
mirror the shipped configs:

  kitti_multiclass, kitti_multiclass_trainval, kitti_multiclass_lidar_supv,
  kitti_multiclass_lidar_supv_trainval, kitti_car, kitti_car_lidar_supv

CLI deep-merge overrides (--cfg-options a.b=c) are provided by
``apply_overrides``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


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


def _car_variant(base: MonoRUnConfig, name: str) -> MonoRUnConfig:
    """Single-class preset: Car only, class-agnostic 3D heads, RPN ratios
    0.4/0.7/1.0 (configs/kitti_car.py deltas)."""
    return _replace(
        base,
        name=name,
        data=_replace(base.data, classes=("Car",)),
        rpn=_replace(
            base.rpn, anchors=_replace(base.rpn.anchors, ratios=(0.4, 0.7, 1.0))
        ),
        bbox_head=_replace(base.bbox_head, num_classes=1),
        global_head=_replace(
            base.global_head, num_classes=1,
            dim_means=(base.global_head.dim_means[0],),
            dim_stds=(base.global_head.dim_stds[0],),
        ),
        noc_head=_replace(base.noc_head, num_classes=1, class_agnostic=True),
    )


def _fast(base: MonoRUnConfig, name: str) -> MonoRUnConfig:
    """Serving-speed preset: 0.75x test resolution + 512 RPN proposals.

    Architectural FLOP cuts the reference does not make (its test budget
    is native-res + 1000 proposals, configs/kitti_multiclass.py:196-207).
    Each cut is revertible by config and costed in README 'Fast presets';
    AP impact is guarded by tests/test_e2e_synthetic.py (trained model,
    official evaluator, fast-preset bars) and must be re-validated on
    real KITTI via tools/parity.py before production use. Pads stay
    64-divisible (320 = 5 * 64) so the stride-64 FPN level is exact."""
    return _replace(
        base,
        name=name,
        data=_replace(
            base.data, test_scale=0.75, pad_height=320, pad_width=960,
        ),
        test=_replace(base.test, rpn_nms_pre=512, rpn_nms_post=512),
    )


def _fast_r50(base: MonoRUnConfig) -> MonoRUnConfig:
    """_fast + ResNet-50 backbone: the deepest cut (the reference ships
    no R50 KITTI checkpoint, so this preset implies retraining)."""
    fast = _fast(base, "kitti_multiclass_fast_r50")
    return _replace(
        fast, backbone=_replace(fast.backbone, depth=50),
    )


def _fast2(base: MonoRUnConfig, name: str, depth: int) -> MonoRUnConfig:
    """The next fast-ladder rung past _fast: every per-detection cost
    halved on top of the 0.75x/512-proposal cuts.

    * rpn_nms_post 512 -> 256: half the proposal-scale RoIAlign + bbox
      head work (reference budget: 1000, configs/kitti_multiclass.py:202)
    * head_slots 48 -> 24: the 3D heads run on the 24 best 2D detections
      (KITTI scenes rarely hold more than ~15 scored cars)
    * mc_samples 50 -> 16: the factored-MC epistemic variance estimate
      uses 16 Bernoulli samples (reference hard-codes 50,
      fc_extractor_monte_carlo.py:24) — unbiased, ~1.8x noisier std
    * dense_size 28 -> 14: the NOC/uncertainty maps stay at the RoI grid
      (no CARAFE 2x upsample; PnP solves 196- instead of 784-point
      problems; reference dense_size=28, configs/kitti_multiclass.py:191).
      Skipping the upsample changes the decoder function -> this rung,
      like _fast_r50, implies retraining.

    Costed in README 'Fast presets'; AP-guarded by the e2e synthetic
    harness; real-KITTI validation protocol as for _fast."""
    fast = _fast(base, name)
    return _replace(
        fast,
        backbone=_replace(fast.backbone, depth=depth),
        test=_replace(
            fast.test, rpn_nms_pre=256, rpn_nms_post=256, head_slots=24,
        ),
        global_head=_replace(fast.global_head, mc_samples=16),
        noc_head=_replace(fast.noc_head, dense_size=14),
        train=_replace(fast.train, dense_size=14),
    )


def _fast3_r50(base: MonoRUnConfig) -> MonoRUnConfig:
    """Top ladder rung: _fast2_r50 + 0.625x test resolution (pad
    256 x 832, both 64-divisible so the stride-64 level stays exact),
    192 proposals and 16 head slots. Measured 454.9 fps/chip on v5e-1
    (batch 8) vs the reference's ~14; every cut is config-revertible
    and subject to the same real-KITTI validation protocol as _fast."""
    f2 = _fast2(base, "kitti_multiclass_fast3_r50", depth=50)
    return _replace(
        f2,
        data=_replace(
            f2.data, test_scale=0.625, pad_height=256, pad_width=832,
        ),
        test=_replace(
            f2.test, rpn_nms_pre=192, rpn_nms_post=192, head_slots=16,
        ),
    )


def _lidar_supv(base: MonoRUnConfig, name: str) -> MonoRUnConfig:
    """LiDAR-supervised preset: NOC loss on, obj_crd prefix, dropout2d 0.5
    (configs/kitti_multiclass_lidar_supv.py deltas)."""
    return _replace(
        base,
        name=name,
        noc_head=_replace(
            base.noc_head, with_lidar_loss=True, dropout2d_rate=0.5
        ),
        data=_replace(base.data, coord_3d_prefix="obj_crd/"),
    )


def _trainval(base: MonoRUnConfig, name: str) -> MonoRUnConfig:
    """train+val training, 32 epochs, no val hook."""
    return _replace(
        base,
        name=name,
        train=_replace(base.train, total_epochs=32, eval_interval=0),
        data=_replace(base.data, train_list="trainval_list.txt"),
    )


def get_config(name: str) -> MonoRUnConfig:
    base = MonoRUnConfig()
    presets = {
        "kitti_multiclass": base,
        "kitti_multiclass_trainval": _trainval(base, "kitti_multiclass_trainval"),
        "kitti_multiclass_lidar_supv": _lidar_supv(
            base, "kitti_multiclass_lidar_supv"),
        "kitti_multiclass_lidar_supv_trainval": _trainval(
            _lidar_supv(base, ""), "kitti_multiclass_lidar_supv_trainval"),
        "kitti_car": _car_variant(base, "kitti_car"),
        "kitti_car_lidar_supv": _lidar_supv(
            _car_variant(base, ""), "kitti_car_lidar_supv"),
        # Serving-speed presets: architectural FLOP cuts behind config,
        # costed in README 'Fast presets' (GFLOP + fps + AP guard). Not
        # reference behaviour; the parity runbook (tools/parity.py)
        # forces all of this off.
        "kitti_multiclass_fast": _fast(base, "kitti_multiclass_fast"),
        "kitti_multiclass_fast_r50": _fast_r50(base),
        "kitti_multiclass_fast2": _fast2(
            base, "kitti_multiclass_fast2", depth=101
        ),
        "kitti_multiclass_fast2_r50": _fast2(
            base, "kitti_multiclass_fast2_r50", depth=50
        ),
        "kitti_multiclass_fast3_r50": _fast3_r50(base),
    }
    if name not in presets:
        raise KeyError(f"unknown config '{name}'; have {sorted(presets)}")
    return presets[name]


def set_by_path(cfg: Any, path: str, value: Any) -> Any:
    """Return a copy of the frozen-dataclass config with the dotted
    ``path`` set to ``value`` (the reference's rsetattr,
    runner/hooks/loss_updater.py:12-14, for immutable configs)."""
    keys = path.split(".")

    def rec(obj, ks):
        if len(ks) == 1:
            return dataclasses.replace(obj, **{ks[0]: value})
        return dataclasses.replace(
            obj, **{ks[0]: rec(getattr(obj, ks[0]), ks[1:])}
        )

    return rec(cfg, keys)


def apply_loss_schedule(cfg: MonoRUnConfig, step: int) -> MonoRUnConfig:
    """Config with every schedule entry whose step has been reached applied
    (in step order, so later entries override earlier ones)."""
    for e in sorted(cfg.loss_schedule, key=lambda e: e.step):
        if step >= e.step:
            cfg = set_by_path(cfg, e.attr, e.value)
    return cfg


def schedule_boundaries(cfg: MonoRUnConfig) -> Tuple[int, ...]:
    """Sorted unique steps at which the train step must re-specialise."""
    return tuple(sorted({e.step for e in cfg.loss_schedule}))


def apply_overrides(cfg: Any, overrides: Sequence[str]) -> Any:
    """CLI deep-merge: ['train.lr=1e-4', 'test.max_per_img=50']."""
    for ov in overrides:
        path, _, raw = ov.partition("=")
        keys = path.split(".")
        # parse value
        try:
            import ast

            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        # rebuild nested frozen dataclasses
        def rec(obj, ks):
            if len(ks) == 1:
                return dataclasses.replace(obj, **{ks[0]: val})
            child = getattr(obj, ks[0])
            return dataclasses.replace(obj, **{ks[0]: rec(child, ks[1:])})

        cfg = rec(cfg, keys)
    return cfg
