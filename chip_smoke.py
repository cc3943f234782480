#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``monorun_tpu_torch``) on one CUDA GPU.

Run from the repository root:

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --profile FILE  # also a torch.profiler breakdown
                                          # of the serving forward; its
                                          # full table goes to FILE

Phases, each printing its own lines:

1. the card's name and power limit, as nvidia-smi gives them;
2. the build of the hand-written CUDA RoIAlign kernel
   (``monorun_tpu_torch/csrc/roi_align.cu``) from this checkout;
3. the kernel against its plain PyTorch version on a kitti_multiclass-sized
   pyramid (batch 8, C=256, levels 96x320, 96x320, 48x160, 24x80, 12x40)
   at the three main-path shapes, in bfloat16 and float32, with times;
4. serving kitti_multiclass at batch 8, full width, seeded random weights,
   through ``init_inference`` -> ``InferenceSession.run``: output shapes,
   finiteness, validity masks, exactly 3 kernel launches per forward, the
   three aligns re-run on the forward's own features and RoIs through the
   kernel and the plain version, ms per batch and frames/s;
5. a tiny float32 configuration served on the GPU (kernel) and on the CPU
   (plain version) with the same weights and random draws, compared;
6. a ``kernels`` JSON line and, last, the JSON result line.

Tolerances (kernel against plain version; both accumulate in float32):
bfloat16 |d| <= 2^-7 |ref| + 1e-5 max(1, max|ref|), one bfloat16 rounding
of the output apart; float32 |d| <= 1e-5 |ref| + 1e-5 max(1, max|ref|),
the summation order of up to 36 samples x 4 taps.

Bounds: the least time for a call is the larger of the bytes it must move
(the feature rows its taps touch with non-zero weight, the RoIs and the
output, each once) over 3.35 TB/s and its bilinear FMAs (4 per channel per
computed sample, 2 FLOPs each) over 67 TFLOP/s, the H100 SXM's float32
rate outside the tensor cores.

Any failed phase, or no GPU, exits non-zero without the last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from monorun_tpu_torch.apis.inference import init_inference
from monorun_tpu_torch.config import get_config
from monorun_tpu_torch.data.pipeline import device_preprocess
from monorun_tpu_torch.models.detector import HeadDraws
from monorun_tpu_torch.ops import roi_align as ra
from monorun_tpu_torch.ops.roi_align_cuda import roi_align_kernel

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BATCH = 8
REQUESTS = 10          # timed serving requests, after 2 warm-up requests
KERNEL_SOURCE = "monorun_tpu_torch/csrc/roi_align.cu"
REPLACES = ("monorun_tpu/ops/roi_align_band.py:57 (_band_kernel), "
            "monorun_tpu/ops/roi_align_sorted.py:99 (_sorted_kernel)")
TOLERANCE = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (1e-5, 1e-5)}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---- kernel against plain version --------------------------------------


def max_err(got: torch.Tensor, ref: torch.Tensor):
    """(max abs error, whether it is within the dtype's tolerance)."""
    rtol, atol_rel = TOLERANCE[ref.dtype]
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    bound = rtol * ref.abs() + atol_rel * ref.abs().max().clamp(min=1.0)
    ok = bool(torch.isfinite(got).all()) and bool((d <= bound).all())
    return float(d.max()), ok


def device_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``reps`` runs, each after an L2
    flush (a write larger than the 50 MB cache), by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def align_work(feats, rois, strides, out_size, finest, max_ratio):
    """(bytes, FLOPs) one align call must move and do on these inputs."""
    sizes = [(f.shape[1], f.shape[2]) for f in feats]
    C, item = feats[0].shape[-1], feats[0].element_size()
    rows, samples = [], 0
    for start in range(0, rois.shape[0], 1024):
        r, w, avg = ra.sample_taps(sizes, rois[start:start + 1024].float(), strides,
                                   out_size, finest, max_ratio, ra.LONG_SPAN_CAP)
        rows.append(torch.unique(r[(w > 0) & (avg > 0)]))
        samples += int(((w.sum(0) > 0) & (avg > 0)).sum())
    touched = int(torch.unique(torch.cat(rows)).numel())
    n = rois.shape[0]
    nbytes = touched * C * item + n * 5 * 4 + n * out_size[0] * out_size[1] * C * item
    return nbytes, 2 * 4 * C * samples


def compare_align(label, feats, rois, strides, out_size, finest, max_ratio, flush,
                  timed=True):
    """Kernel against plain version on one call; prints one line and
    returns its record."""
    def kernel():
        return roi_align_kernel(feats, rois, strides, out_size, finest, max_ratio,
                                ra.LONG_SPAN_CAP)

    def plain():
        return ra.multilevel_roi_align(feats, rois, strides, out_size, finest,
                                       max_ratio=max_ratio, long_span_cap=ra.LONG_SPAN_CAP)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err, ok = max_err(got, ref)
    rec = dict(call=label, dtype=str(feats[0].dtype).replace("torch.", ""),
               rois=int(rois.shape[0]), out=list(out_size), max_ratio=max_ratio,
               max_abs_err=err, max_abs_ref=float(ref.float().abs().max()))
    if timed:
        nbytes, flops = align_work(feats, rois, strides, out_size, finest, max_ratio)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        rec.update(
            ms=device_ms(kernel, 15, flush), plain_ms=device_ms(plain, 10, flush),
            bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
    print("align " + json.dumps(rec), flush=True)
    check(ok, f"kernel and plain version disagree on {label} ({rec['dtype']}): "
              f"max abs error {err}")
    return rec


def synthetic_rois(n_per_img, batch, img_hw, min_side, max_side, gen, dev):
    """RoIs (n, 5) inside img_hw with log-uniform sides; 2% are zero-size
    padded slots and 2% thin slivers."""
    n = n_per_img * batch
    H, W = img_hw

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    side = min_side * (max_side / min_side) ** u(n)
    aspect = 4.0 ** (2 * u(n) - 1)
    w, h = side * aspect.sqrt(), side / aspect.sqrt()
    sliver = u(n) < 0.02
    h = torch.where(sliver, 1.0 + 2 * u(n), h)
    w = torch.where(sliver, 100.0 + 300 * u(n), w)
    x1, y1 = u(n) * W, u(n) * H
    x2, y2 = (x1 + w).clamp(max=W), (y1 + h).clamp(max=H)
    b = torch.arange(batch, device=dev).repeat_interleave(n_per_img).float()
    rois = torch.stack([b, x1, y1, x2, y2], 1)
    pad = u(n) < 0.02
    rois[:, 1:] = torch.where(pad[:, None], 0.0, rois[:, 1:])
    return rois


def phase_kernel(cfg, flush, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    H, W = cfg.data.pad_height, cfg.data.pad_width
    strides = ra.align_strides(cfg.neck.lazy_lower, cfg.bbox_head.featmap_strides)
    feats32 = [torch.randn(BATCH, H // s, W // s, cfg.neck.out_channels, generator=gen,
                           device=dev) for s in strides]
    props = synthetic_rois(cfg.test.rpn_nms_post, BATCH, (375, 1242), 2.0, 600.0, gen, dev)
    dets = synthetic_rois(cfg.test.head_slots, BATCH, (375, 1242), 10.0, 400.0, gen, dev)
    bh, nh = cfg.bbox_head, cfg.noc_head
    calls = (
        ("proposals 7x7", props, (7, 7), bh.finest_scale, bh.align_max_ratio),
        ("detections 7x7", dets, (7, 7), bh.finest_scale, bh.align_max_ratio),
        ("detections 14x14", dets, (nh.roi_size,) * 2, nh.finest_scale, nh.align_max_ratio),
    )
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        feats = [f.to(dtype) for f in feats32]
        for label, rois, out_size, finest, mr in calls:
            recs.append(compare_align(f"synthetic {label}", feats, rois, strides, out_size,
                                      finest, mr, flush, timed=dtype == torch.bfloat16))
        del feats
    return recs


# ---- serving -------------------------------------------------------------


def kitti_inputs(cfg, batch, gen, dev):
    """Random uint8 canvases holding 375x1242 images, KITTI intrinsics."""
    raw = torch.randint(0, 256, (batch, cfg.data.raw_height, cfg.data.raw_width, 3),
                        generator=gen, device=dev, dtype=torch.uint8)
    cam = torch.tensor([[721.5, 0.0, 609.6], [0.0, 721.5, 172.9], [0.0, 0.0, 1.0]],
                       device=dev).expand(batch, 3, 3).contiguous()
    shapes = torch.tensor([[375.0, 1242.0]], device=dev).expand(batch, 2).contiguous()
    return raw, cam, shapes


def check_detections(det, cfg, batch):
    M, K = cfg.test.max_per_img, cfg.test.head_slots
    shapes = dict(bboxes_2d=(batch, M, 4), scores_2d=(batch, M), labels=(batch, M),
                  bboxes_3d=(batch, M, 8), valid=(batch, M), pose_cov=(batch, M, 4, 4))
    for name, shape in shapes.items():
        check(tuple(getattr(det, name).shape) == shape, f"{name} has shape "
              f"{tuple(getattr(det, name).shape)}, expected {shape}")
    check(det.valid.dtype == torch.bool, "valid is not a bool mask")
    for name in ("bboxes_2d", "scores_2d", "bboxes_3d", "pose_cov"):
        check(bool(torch.isfinite(getattr(det, name)).all()), f"{name} is not finite")
    valid = det.valid
    check(not bool(valid[:, K:].any()), "a slot beyond head_slots is valid")
    check(bool((det.labels[valid] >= 0).all()), "a valid slot has no label")
    check(bool((det.bboxes_3d[~valid] == 0).all()), "an invalid slot has a 3D box")
    eye = torch.eye(4, device=valid.device)
    check(bool((det.pose_cov[~valid] == eye).all()), "an invalid slot's covariance "
          "is not the identity")


def phase_serve(cfg, flush, dev, card, profile):
    sess = init_inference("kitti_multiclass", batch_size=BATCH, device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(1)
    requests = [kitti_inputs(cfg, BATCH, gen, dev) for _ in range(REQUESTS + 2)]

    # record the aligns of one forward, as the detector calls them
    recorded = []
    model = sess.model
    align = model._align

    def recording_align(feats, rois, head_cfg, out_size):
        out = align(feats, rois, head_cfg, out_size)
        recorded.append((feats, rois, head_cfg, out_size, out))
        return out

    roi_align_kernel.launches = 0
    times, dets = [], []
    for i, req in enumerate(requests):
        model._align = recording_align if i == 0 else align
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets.append(sess.run(*req))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = roi_align_kernel.launches
    model._align = align
    forwards = len(requests)
    print(f"serve launches {launches} over {forwards} forwards", flush=True)
    check(launches == 3 * forwards, f"the RoIAlign kernel launched {launches} times "
          f"in {forwards} forwards, expected {3 * forwards}")

    for det in dets:
        check_detections(det, cfg, BATCH)
    ms = statistics.median(times[2:])
    n_valid = [int(d.valid.sum()) for d in dets]
    print("serve " + json.dumps(dict(
        config="kitti_multiclass", card=card, batch=BATCH, requests=REQUESTS,
        ms_per_batch=ms, frames_per_s=BATCH * 1e3 / ms,
        ms_each=times, first_ms=times[0], valid_detections=n_valid,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
    )), flush=True)

    recs = []
    labels = ("proposals 7x7", "detections 7x7", "detections 14x14")
    with torch.inference_mode():
        for label, (feats, rois, head_cfg, out_size, out) in zip(labels, recorded):
            n_lvl = len(head_cfg.featmap_strides)
            strides = ra.align_strides(cfg.neck.lazy_lower, head_cfg.featmap_strides)
            feats = [f.contiguous() for f in feats[:n_lvl]]
            rois = rois.float().contiguous()
            plain = ra.multilevel_roi_align(
                feats, rois, strides, out_size, head_cfg.finest_scale,
                max_ratio=head_cfg.align_max_ratio, long_span_cap=ra.LONG_SPAN_CAP)
            err, ok = max_err(out, plain)
            print(f"serve align {label}: forward's kernel output against plain "
                  f"version, max abs error {err}", flush=True)
            check(ok, f"the forward's {label} align disagrees with the plain version")
            recs.append(compare_align(f"forward {label}", feats, rois, strides, out_size,
                                      head_cfg.finest_scale, head_cfg.align_max_ratio,
                                      flush))
    del recorded

    if profile:
        profile_serve(sess, requests[:3], ms, profile)
    return recs, launches


def profile_serve(sess, requests, ms_per_batch, table_path):
    """Where a forward's time goes: wall time of its stages (host clock
    around each, synchronised), device time by PyTorch op and of the
    RoIAlign kernel (torch.profiler), kernel launches, and the device's
    idle share of the unprofiled ms per batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, cfg = sess.model, sess.cfg
    raw, cam, shapes = requests[0]

    def wall_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    with torch.inference_mode():
        images, img_shapes = device_preprocess(raw, shapes, cfg.data)
        feats = model.extract_feats(images)
        pad = (cfg.data.pad_height, cfg.data.pad_width)
        stages = dict(
            preprocess=wall_ms(lambda: device_preprocess(raw, shapes, cfg.data)),
            backbone_neck=wall_ms(lambda: model.extract_feats(images)),
            heads=wall_ms(lambda: model.heads_forward(feats, cam, img_shapes, pad,
                                                      generator=sess.generator)),
        )

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for req in requests:
            sess.run(*req)
        torch.cuda.synchronize()
    avgs = prof.key_averages()

    def dev_ms(e):
        t = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if t is None else t) / 1e3 / len(requests)

    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    ops = [e for e in avgs if e.device_type == DeviceType.CPU and dev_ms(e) > 0]
    busy = sum(dev_ms(e) for e in kernels)
    align = sum(dev_ms(e) for e in kernels if "roi_align" in e.key)
    table_path.parent.mkdir(parents=True, exist_ok=True)
    table_path.write_text(avgs.table(sort_by="self_device_time_total", row_limit=80))
    print("profile " + json.dumps(dict(
        stage_ms=stages, forwards=len(requests),
        device_ms_per_forward=busy, roi_align_ms_per_forward=align,
        launches_per_forward=sum(e.count for e in kernels) / len(requests),
        device_idle_share=1.0 - busy / ms_per_batch,
        top_ops_device_ms=[[e.key, dev_ms(e), e.count / len(requests)]
                           for e in sorted(ops, key=dev_ms, reverse=True)[:15]],
    )), flush=True)


# ---- tiny configuration, GPU against CPU ---------------------------------


def tiny_config():
    cfg = get_config("kitti_multiclass")
    r = dataclasses.replace
    return r(
        cfg, compute_dtype="float32",
        backbone=r(cfg.backbone, depth=26),
        neck=r(cfg.neck, out_channels=64),
        rpn=r(cfg.rpn, feat_channels=64),
        bbox_head=r(cfg.bbox_head, fc_out_channels=128),
        global_head=r(cfg.global_head, mc_samples=2, fc_out_channels=128),
        noc_head=r(cfg.noc_head, conv_out_channels=64, carafe_compressed_channels=16,
                   roi_size=8, dense_size=16),
        score_head=r(cfg.score_head, reg_fc_out_channels=128, pose_fc_out_channels=128,
                     fc_out_channels=64),
        pose_head=r(cfg.pose_head, ransac_hypotheses=4),
        test=r(cfg.test, rpn_nms_pre=64, rpn_nms_post=64, max_per_img=12, head_slots=6),
        data=r(cfg.data, pad_height=64, pad_width=128, raw_height=64, raw_width=128),
    )


def phase_tiny():
    """The same tiny model, weights and draws on the GPU and on the CPU:
    labels and validity exact, 2D outputs to 1e-4 and 3D outputs to 1e-3
    of their scale (8 LM iterations compound float32 rounding)."""
    cfg = tiny_config()
    B, K = 2, cfg.test.head_slots
    gen = torch.Generator().manual_seed(5)
    raw = torch.randint(0, 256, (B, 64, 128, 3), generator=gen, dtype=torch.uint8)
    cam = torch.tensor([[70.0, 0, 64], [0, 70.0, 32], [0, 0, 1]]).expand(B, 3, 3)
    shapes = torch.tensor([[60.0, 120.0], [64.0, 128.0]])
    gh = cfg.global_head
    n_pts = cfg.noc_head.dense_size ** 2

    def mask(shape, keep):
        return torch.where(torch.rand(shape, generator=gen) < keep, 1.0 / keep, 0.0)

    masks = (mask((B * K, gh.mc_samples, cfg.neck.out_channels), 1 - gh.dropout2d_rate),
             mask((B * K, gh.mc_samples, gh.fc_out_channels), 1 - gh.dropout_rate),
             mask((B * K, gh.mc_samples, gh.fc_out_channels), 1 - gh.dropout_rate))
    keys = torch.rand((B * K, cfg.pose_head.ransac_hypotheses, n_pts), generator=gen)

    out = {}
    for device in ("cpu", "cuda"):
        sess = init_inference(cfg, batch_size=B, device=device, seed=7)
        d = torch.device(device)
        draws = HeadDraws(tuple(m.to(d) for m in masks), keys.to(d))
        before = roi_align_kernel.launches
        det = sess.run(raw.to(d), cam.to(d), shapes.to(d), draws)
        out[device] = to_cpu(det)
        if device == "cuda":
            check(roi_align_kernel.launches == before + 3,
                  "the tiny GPU forward did not run the kernel 3 times")
    cpu, gpu = out["cpu"], out["cuda"]
    check(torch.equal(cpu.labels, gpu.labels), "tiny config: labels differ GPU vs CPU")
    check(torch.equal(cpu.valid, gpu.valid), "tiny config: validity differs GPU vs CPU")
    errs = {}
    for name, rtol in (("bboxes_2d", 1e-4), ("scores_2d", 1e-4), ("bboxes_3d", 1e-3),
                       ("pose_cov", 1e-3)):
        a, b = getattr(gpu, name).double(), getattr(cpu, name).double()
        scale = float(b.abs().max().clamp(min=1e-6))
        errs[name] = float((a - b).abs().max()) / scale
        check(bool(((a - b).abs() <= rtol * b.abs() + rtol * scale).all()),
              f"tiny config: {name} differs GPU vs CPU (max error {errs[name]} of scale)")
    print("tiny " + json.dumps(dict(valid=int(cpu.valid.sum()),
                                    rel_err_of_scale=errs)), flush=True)


def to_cpu(det):
    """Detections moved to the CPU, without the debug maps."""
    return det._replace(**{k: v.cpu() for k, v in det._asdict().items()
                           if isinstance(v, torch.Tensor)}, extras={})


# ---- main ----------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, metavar="FILE",
                    help="profile the serving forward; write the table to FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    try:
        roi_align_kernel.build()
        print(f"build roi_align {roi_align_kernel.build_seconds:.2f} s", flush=True)
        for line in roi_align_kernel.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {line.strip()}", flush=True)

        cfg = get_config("kitti_multiclass")
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
        synthetic = phase_kernel(cfg, flush, dev)
        forward, launches = phase_serve(cfg, flush, dev, card, args.profile)
        phase_tiny()
    except SmokeFailure as e:
        print(f"FAIL {e}", file=sys.stderr)
        return 1

    kernel = dict(
        name="roi_align", route="cuda", source=KERNEL_SOURCE, replaces=REPLACES,
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in synthetic + forward),
        # one forward's three calls, on the forward's own inputs
        ms=sum(r["ms"] for r in forward),
        plain_ms=sum(r["plain_ms"] for r in forward),
        bound_ms=sum(r["bound_ms"] for r in forward),
        bound_by=("bytes" if sum(r["bytes"] / HBM_BYTES_PER_S for r in forward)
                  >= sum(r["flops"] / FP32_FLOPS for r in forward) else "operations"),
        library_ms=None,
        calls=[{k: r[k] for k in ("call", "rois", "out", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "max_abs_err")} for r in forward],
    )
    print(f"seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
