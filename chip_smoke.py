#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``monorun_tpu_torch``) on one CUDA GPU.

Run from the repository root:

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --profile FILE  # also a torch.profiler breakdown
                                          # of the serving forward; its
                                          # full table goes to FILE
    python3 chip_smoke.py --ab SOURCE     # also time another build of the
                                          # direct kernel's C interface
                                          # (an earlier roi_align.cu) in
                                          # turns with this one, phases 3-4
                                          # (repeatable)
    python3 chip_smoke.py --ab NAME=SOURCE
                                          # the same for the staged kernel
                                          # NAME of the kernels line (e.g.
                                          # roi_align_band_matmul), phase 6

Phases, each printing its own lines:

1. the card's name and power limit, as nvidia-smi gives them;
2. the build of every hand-written CUDA RoIAlign kernel
   (``monorun_tpu_torch/csrc/*.cu``, one nvcc per source, in parallel);
3. the direct kernel (``csrc/roi_align.cu``) against its plain PyTorch
   version on a kitti_multiclass-sized pyramid (batch 8, C=256, levels
   96x320, 96x320, 48x160, 24x80, 12x40) at the three main-path shapes,
   in bfloat16 and float32, with times: per call the kernel's ms, its
   bound and share of the bound, an empty launch's ms in the same timing
   harness (the fixed cost), samples, sample taps and merged distinct
   taps per bin;
4. serving kitti_multiclass at batch 8, full width, seeded random weights,
   through ``init_inference`` -> ``InferenceSession.run`` with the align
   switches unset: output shapes, finiteness, validity masks, exactly 3
   launches of the direct kernel and none of the staged ones per forward,
   no staged pyramid, the three aligns re-run on the forward's own
   features and RoIs through the kernel and the plain version (with the
   times of phase 3), ms per batch and frames/s;
5. a tiny float32 configuration served on the GPU (kernel) and on the CPU
   (plain version) with the same weights and random draws, compared;
6. each staged kernel (tile, band tiered, band packed, band matmul, and
   matmul with its row product in bfloat16) against its plain version on
   the same prepared inputs: the forward's own three aligns, in bfloat16
   and float32, with the kernel's time, the time of the call with its
   preparation, the plain version's time, the bound and its bytes, the
   bytes the kernel stages (counted from the prepared call) and the
   launch shape (all four run the staged core ``csrc/roi_align_ring.cuh``);
   with
   ``--ab NAME=SOURCE`` the other build's time in turns; in bfloat16 also
   its gap to the gather version (float32 weights) on the RoIs whose taps
   fit the staged window (lazy-level slivers overrun it, as in the JAX
   package's kernels; their count and gap are printed);
7. serving again under each align setting that selects a staged kernel
   (band + MONORUN_BAND_TIERED=1, auto + MONORUN_BAND_TIERED=1, bandmm,
   bandmm + MONORUN_BAND_T1_BF16=1): detections checked as in phase 4,
   the launches of every kernel per forward, ms per batch;
8. the align micro-bench's A/B (``monorun_tpu_torch.tools.micro_bench``
   ``align48``), the path that reaches the tile and packed kernels;
9. a ``kernels`` JSON line (the registers and local memory bytes per
   thread and dtype of the direct kernel and of the four staged kernels,
   as the loaded build reports them, among their keys; local memory, a
   spill, fails the run) and, last, the JSON result line.

Every path (phases 4, 7 and 8) runs with all launch counts set to 0 just
before it and read just after; a kernel that its path did not launch fails
the run.

Tolerances (kernel against plain version; both accumulate in float32):
bfloat16 |d| <= 2^-7 |ref| + 1e-5 max(1, max|ref|), one bfloat16 rounding
of the output apart; float32 |d| <= 1e-5 |ref| + 1e-5 max(1, max|ref|),
the summation order of up to 36 samples x 4 taps; with the row product in
bfloat16 (matmul t1), one rounding of t1 more: + 2^-8 max|x|. The staged
kernels' gap to the gather version in bfloat16 (their interpolation
weights are rounded to bfloat16, and each axis's weights sum to at most
1): |d| <= 2^-7 max|x| + 2^-7 |ref|.

Bounds: the least time for a call is the larger of the bytes it must move
(the feature rows its taps touch with non-zero weight, the RoIs and the
output, each once) over 3.35 TB/s and its bilinear FMAs (4 per channel per
computed sample, 2 FLOPs each) over 67 TFLOP/s, the H100 SXM's float32
rate outside the tensor cores. Every kernel computes the same function,
so the staged kernels share the direct kernel's bound on the same call.

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
from monorun_tpu_torch.ops import roi_align_band as rb
from monorun_tpu_torch.ops import roi_align_cuda as rc
from monorun_tpu_torch.ops import roi_align_tile as rt
from monorun_tpu_torch.ops.roi_align_cuda import roi_align_kernel
from monorun_tpu_torch.tools import micro_bench
from monorun_tpu_torch.tools.micro_bench import align_env, card_line, device_ms

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BATCH = 8
REQUESTS = 10          # timed serving requests, after 2 warm-up requests
KERNEL_SOURCE = "monorun_tpu_torch/csrc/roi_align.cu"
REPLACES = ("monorun_tpu/ops/roi_align_band.py:57 (_band_kernel), "
            "monorun_tpu/ops/roi_align_sorted.py:99 (_sorted_kernel)")
TOLERANCE = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (1e-5, 1e-5)}
ALL_KERNELS = (roi_align_kernel, *rc.STAGED_KERNELS)
KERNEL_NAMES = {roi_align_kernel: "roi_align", rc.tile_kernel: "roi_align_tile",
                rc.band_tiered_kernel: "roi_align_band_tiered",
                rc.band_packed_kernel: "roi_align_band_packed",
                rc.band_matmul_kernel: "roi_align_band_matmul"}
SOURCES = {"roi_align": KERNEL_SOURCE,
           "roi_align_tile": "monorun_tpu_torch/csrc/roi_align_tile.cu",
           "roi_align_band_tiered": "monorun_tpu_torch/csrc/roi_align_band.cu",
           "roi_align_band_packed": "monorun_tpu_torch/csrc/roi_align_mma.cu",
           "roi_align_band_matmul": "monorun_tpu_torch/csrc/roi_align_mma.cu"}
REPLACED = {"roi_align": REPLACES,
            "roi_align_tile": "monorun_tpu/ops/roi_align_pallas.py:55 (_kernel)",
            "roi_align_band_tiered": "monorun_tpu/ops/roi_align_band.py:142 "
                                     "(_band_kernel_tiered)",
            "roi_align_band_packed": "monorun_tpu/ops/roi_align_band.py:330 "
                                     "(_band_kernel_packed)",
            "roi_align_band_matmul": "monorun_tpu/ops/roi_align_band.py:227 "
                                     "(_band_kernel_matmul)"}


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


def tap_counts(feats, rois, strides, out_size, finest, max_ratio):
    """Per output bin, averaged over the call: computed samples, their
    taps (4 each, as the unmerged version loads them) and the distinct
    taps the direct kernel loads after merging (``merged_bin_taps``)."""
    sizes = [(f.shape[1], f.shape[2]) for f in feats]
    samples = distinct = 0
    for start in range(0, rois.shape[0], 1024):
        r = rois[start:start + 1024].float()
        _, w, avg = ra.sample_taps(sizes, r, strides, out_size, finest, max_ratio,
                                   ra.LONG_SPAN_CAP)
        samples += int(((w.sum(0) > 0) & (avg > 0)).sum())
        t = ra.merged_bin_taps(sizes, r, strides, out_size, finest, max_ratio,
                               ra.LONG_SPAN_CAP)
        n_rows, n_cols = (t.row_w != 0).sum(-1), (t.col_w != 0).sum(-1)
        distinct += int((n_rows[:, :, None] * n_cols[:, None, :]).sum())
    bins = rois.shape[0] * out_size[0] * out_size[1]
    return dict(samples_per_bin=samples / bins, sample_taps_per_bin=4 * samples / bins,
                distinct_taps_per_bin=distinct / bins)


def compare_align(label, feats, rois, strides, out_size, finest, max_ratio, flush, ab=()):
    """Kernel against plain version on one call; prints one line and
    returns its record. ``ab``: other builds of the kernel, each timed in
    turns with this one (other, kernel, kernel, other), its agreement with
    the plain version reported (a diagnostic build may skip work)."""
    def kernel(k=roi_align_kernel):
        return k(feats, rois, strides, out_size, finest, max_ratio, ra.LONG_SPAN_CAP)

    def plain():
        return ra.multilevel_roi_align(feats, rois, strides, out_size, finest,
                                       max_ratio=max_ratio, long_span_cap=ra.LONG_SPAN_CAP)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err, ok = max_err(got, ref)
    rec = dict(call=label, dtype=str(feats[0].dtype).replace("torch.", ""),
               rois=int(rois.shape[0]), out=list(out_size), max_ratio=max_ratio,
               max_abs_err=err, max_abs_ref=float(ref.float().abs().max()))
    nbytes, flops = align_work(feats, rois, strides, out_size, finest, max_ratio)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    rec.update(
        ms=device_ms(kernel, 15, flush), plain_ms=device_ms(plain, 10, flush),
        empty_ms=device_ms(roi_align_kernel.empty_launch, 15, flush),
        bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        **tap_counts(feats, rois, strides, out_size, finest, max_ratio),
    )
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["ab"] = []
    for other in ab:
        ab_err, ab_ok = max_err(kernel(other), ref)
        turns = [device_ms(lambda: kernel(k), 15, flush)
                 for k in (other, roi_align_kernel, roi_align_kernel, other)]
        rec["ab"].append(dict(source=str(other.source), max_abs_err=ab_err,
                              agrees=ab_ok, ms_turns=turns,
                              ms=statistics.median([turns[0], turns[3]]),
                              this_ms=statistics.median(turns[1:3])))
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


def phase_kernel(cfg, flush, dev, ab=()):
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
                                      finest, mr, flush, ab=ab))
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


def reset_counts() -> None:
    for k in ALL_KERNELS:
        k.launches = 0


def read_counts() -> dict:
    return {KERNEL_NAMES[k]: k.launches for k in ALL_KERNELS}


def serve_requests(sess, requests, record=False):
    """Serves each request, synchronised; returns (ms each, detections,
    the first forward's aligns as (feats, rois, head_cfg, out_size,
    pyramid, out) when ``record``)."""
    recorded = []
    model = sess.model
    align = model._align

    def recording_align(feats, rois, head_cfg, out_size, tile_h, pyramid):
        out = align(feats, rois, head_cfg, out_size, tile_h, pyramid)
        recorded.append((feats, rois, head_cfg, out_size, pyramid, out))
        return out

    times, dets = [], []
    try:
        for i, req in enumerate(requests):
            model._align = recording_align if (record and i == 0) else align
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dets.append(sess.run(*req))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        model._align = align
    return times, dets, recorded


def check_launches(counts: dict, per_forward: dict, forwards: int, what: str) -> None:
    want = {name: per_forward.get(name, 0) * forwards for name in counts}
    print(f"launches {what}: {json.dumps(counts)} over {forwards} forwards", flush=True)
    check(counts == want, f"{what}: launches {counts} in {forwards} forwards, "
                          f"expected {want}")


def phase_serve(cfg, flush, dev, card, profile, ab=()):
    sess = init_inference("kitti_multiclass", batch_size=BATCH, device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(1)
    requests = [kitti_inputs(cfg, BATCH, gen, dev) for _ in range(REQUESTS + 2)]

    with align_env({}):
        reset_counts()
        times, dets, recorded = serve_requests(sess, requests, record=True)
        counts = read_counts()
    forwards = len(requests)
    check_launches(counts, {"roi_align": 3}, forwards, "serve default")
    check(all(r[4] is None for r in recorded),
          "the default path built a staged pyramid")

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

    recs, calls = [], []
    labels = ("proposals 7x7", "detections 7x7", "detections 14x14")
    with torch.inference_mode():
        for label, (feats, rois, head_cfg, out_size, _, out) in zip(labels, recorded):
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
                                      flush, ab=ab))
            calls.append((label, feats, rois, strides, out_size, head_cfg.finest_scale,
                          head_cfg.align_max_ratio, recs[-1]))
    del recorded

    if profile:
        profile_serve(sess, requests[:3], ms, profile)
    return recs, counts, sess, requests, calls


# ---- staged kernels against their plain version -----------------------------

# variant -> (kernel, prepare keywords); tile_h rounds to 32 on every align
VARIANTS = {
    "tile": (rc.tile_kernel, {}),
    "tiered": (rc.band_tiered_kernel, dict(tiered=True, kroi=4)),
    "packed": (rc.band_packed_kernel, dict(packed=True, kroi=4)),
    "matmul": (rc.band_matmul_kernel, dict(matmul=True, kroi=16)),
    "matmul t1 bf16": (rc.band_matmul_kernel,
                       dict(matmul=True, kroi=16, t1_dtype=torch.bfloat16)),
}


def staged_ok(got, ref, feats, t1_rounded):
    """(max abs error, within the dtype's tolerance)."""
    rtol, atol_rel = TOLERANCE[ref.dtype]
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    bound = rtol * ref.abs() + atol_rel * ref.abs().max().clamp(min=1.0)
    if t1_rounded:
        bound = bound + 2.0 ** -8 * max(float(f.float().abs().max()) for f in feats)
    return float(d.max()), bool(torch.isfinite(got).all()) and bool((d <= bound).all())


def call_weights(call):
    """(Y, X) of a prepared tile or band call."""
    return (call.geo.Y, call.geo.X) if isinstance(call, rt.TileCall) else (call.Y, call.X)


def launch_shape_of(kernel, call) -> dict:
    """The launch shape the kernel's C launcher picks for this call."""
    Y, X = call_weights(call)
    kroi = 1 if isinstance(call, rt.TileCall) else call.kroi
    return kernel.launch_shape(Y.dtype, kroi, Y.shape[1], X.shape[2])


def staged_bytes_host(kernel, call) -> int:
    """Bytes of the feature buffers the kernel copies into shared memory in
    one call, counted on the host from the prepared call (not measured), as
    the staged core's launcher and kernel choose them: for each block of A
    rows with a real slot, K rows (the union of its slots' window rows,
    ``rb.core_slots``, rounded up to 16, at most 64 or a tile's th) by the
    ring chunks of ``stage_cols`` columns from the union's first column
    that some slot's window touches, cut at the buffer's edge, once per
    block of output columns. All channels."""
    bufs = call_buffers(call)
    C, item = bufs[0].shape[-1], bufs[0].element_size()
    slots = rb.core_slots(call)
    kroi, oh = slots.kroi, call_weights(call)[0].shape[1]
    shape = launch_shape_of(kernel, call)
    ch = shape["stage_cols"]
    real = (slots.dst >= 0).view(-1, kroi)
    dev = real.device
    blk_buf = slots.buf.view(-1, kroi)[:, 0]
    bcols = torch.tensor([b.shape[1] for b in bufs], device=dev)[blk_buf][:, None]
    c0, width = slots.col0.view(-1, kroi), slots.width.view(-1, kroi)
    rw0, rows = slots.row0.view(-1, kroi), slots.rows.view(-1, kroi)
    g = torch.arange(kroi, device=dev)
    rows_per, big, total = shape["m_tiles"] * 16, 1 << 30, 0
    for mg in range(shape["m_groups"]):
        m = real & (g * oh < (mg + 1) * rows_per) & ((g + 1) * oh > mg * rows_per)
        if not bool(m.any()):
            continue
        cmin = torch.where(m, c0, big).amin(1, keepdim=True)
        q_lo = torch.where(m, (c0 - cmin) // ch, 0)
        q_hi = torch.where(m, (c0 + width - 1 - cmin) // ch + 1, 0)
        nq = int(q_hi.max())
        diff = torch.zeros(c0.shape[0], nq + 1, dtype=torch.long, device=dev)
        diff.scatter_add_(1, q_lo, m.long()).scatter_add_(1, q_hi, -m.long())
        used = diff.cumsum(1)[:, :nq] > 0
        x0 = cmin + torch.arange(nq, device=dev) * ch
        cols = torch.where(used, (bcols - x0).clamp(0, ch), 0).sum(1)
        span = (torch.where(m, rw0 + rows, -big).amax(1) - torch.where(m, rw0, big).amin(1))
        K = ((span + 15) // 16 * 16).clamp(max=slots.kmax)
        total += int((K * cols)[m.any(1)].sum())
    return total * shape["j_groups"] * C * item


def call_buffers(call):
    return call.bufs if hasattr(call, "bufs") else call.pyramid.bufs


def phase_staged(calls, flush, ab=None):
    """Each staged kernel against its plain version on the forward's own
    aligns, in bfloat16 and float32. ``ab``: kernel -> other builds of it,
    each timed in turns with it (other, kernel, kernel, other)."""
    ab = ab or {}
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        feats_all = [f.to(dtype) for f in calls[0][1]]
        pyramid = rt.prepare_flat_pyramid(feats_all)
        pyramid_ms = device_ms(lambda: rt.prepare_flat_pyramid(feats_all), 10, flush)
        print(f"staged pyramid {dname}: {pyramid_ms} ms", flush=True)
        for label, feats, rois, strides, out_size, finest, mr, _ in calls:
            feats = [f.to(dtype) for f in feats]
            gather = ra.multilevel_roi_align(feats, rois, strides, out_size, finest,
                                             max_ratio=mr, long_span_cap=ra.LONG_SPAN_CAP)
            nbytes, flops = align_work(feats, rois, strides, out_size, finest, mr)
            # RoIs whose taps overrun the staged window (lazy-level slivers,
            # see roi_align_tile.TileGeometry.fits) are held to their plain
            # version only
            fits = rt.roi_tile_geometry(rois, pyramid.sizes, strides, out_size, finest, mr,
                                        rt.MAX_TH, rt.MAX_TW, dtype).fits
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
            for variant, (kernel, kw) in VARIANTS.items():
                def prepare():
                    if variant == "tile":
                        return rt.prepare_tile_call(feats, rois, strides, out_size, finest,
                                                    mr, pyramid=pyramid)
                    return rb.prepare_band_call(feats, rois, strides, out_size, finest, mr,
                                                pyramid=pyramid, **kw)
                plain = rt.tile_call_plain if variant == "tile" else rb.band_call_plain
                with torch.inference_mode():
                    call = prepare()
                    got, ref = kernel(call), plain(call)
                    torch.cuda.synchronize()
                    t1_rounded = kw.get("t1_dtype") is not None
                    err, ok = staged_ok(got, ref, feats, t1_rounded)
                    gap = (got.float() - gather.float()).abs()
                    xmax = max(float(f.float().abs().max()) for f in feats)
                    gap_ok = bool((gap <= 2.0 ** -7 * xmax
                                   + 2.0 ** -7 * gather.float().abs())[fits].all())
                    rec = dict(kernel=KERNEL_NAMES[kernel], variant=variant,
                               call=f"forward {label}", dtype=dname, rois=int(rois.shape[0]),
                               out=list(out_size), max_abs_err=err,
                               max_abs_ref=float(ref.float().abs().max()),
                               gap_to_gather=float(gap[fits].max()),
                               rois_overrunning=int((~fits).sum()),
                               gap_overrunning=float(gap[~fits].max()) if (~fits).any()
                               else 0.0,
                               ms=device_ms(lambda: kernel(call), 10, flush),
                               call_ms=device_ms(lambda: kernel(prepare()), 10, flush),
                               plain_ms=device_ms(lambda: plain(call), 3, flush),
                               bound_ms=max(t_bytes, t_ops), bound_bytes=nbytes,
                               bound_by="bytes" if t_bytes >= t_ops else "operations",
                               staged_bytes_host=staged_bytes_host(kernel, call))
                    rec["launch_shape"] = launch_shape_of(kernel, call)
                    rec["ab"] = []
                    for other in ab.get(kernel, ()):
                        ab_err, ab_ok = staged_ok(other(call), ref, feats, t1_rounded)
                        turns = [device_ms(lambda: k(call), 10, flush)
                                 for k in (other, kernel, kernel, other)]
                        rec["ab"].append(dict(
                            source=str(other.source), max_abs_err=ab_err, agrees=ab_ok,
                            ms_turns=turns, ms=statistics.median([turns[0], turns[3]]),
                            this_ms=statistics.median(turns[1:3])))
                print("staged " + json.dumps(rec), flush=True)
                check(ok, f"{variant} kernel and its plain version disagree on {label} "
                          f"({dname}): max abs error {err}")
                check(gap_ok, f"{variant} kernel is farther than the weight rounding from "
                              f"the gather version on {label} ({dname})")
                recs.append(rec)
            del gather
        del pyramid, feats_all
    return recs


# ---- serving under the staged settings --------------------------------------

SERVE_VARIANTS = (
    ("band tiered", {"MONORUN_ALIGN_IMPL": "band", "MONORUN_BAND_TIERED": "1"},
     {"roi_align_band_tiered": 3}),
    ("auto tiered", {"MONORUN_BAND_TIERED": "1"},
     {"roi_align_band_tiered": 1, "roi_align": 2}),
    ("bandmm", {"MONORUN_ALIGN_IMPL": "bandmm"}, {"roi_align_band_matmul": 3}),
    ("bandmm t1 bf16", {"MONORUN_ALIGN_IMPL": "bandmm", "MONORUN_BAND_T1_BF16": "1"},
     {"roi_align_band_matmul": 3}),
)
SERVE_VARIANT_REQUESTS = 5     # 2 warm-up, 3 timed


def phase_serve_variants(sess, requests, cfg, card):
    paths = {}
    for name, env, per_forward in SERVE_VARIANTS:
        with align_env(env):
            reset_counts()
            times, dets, _ = serve_requests(sess, requests[:SERVE_VARIANT_REQUESTS])
            counts = read_counts()
        check_launches(counts, per_forward, len(times), f"serve {name}")
        for det in dets:
            check_detections(det, cfg, BATCH)
        ms = statistics.median(times[2:])
        print("serve " + json.dumps(dict(
            config="kitti_multiclass", setting=name, env=env, card=card, batch=BATCH,
            ms_per_batch=ms, frames_per_s=BATCH * 1e3 / ms, ms_each=times,
            valid_detections=[int(d.valid.sum()) for d in dets])), flush=True)
        paths[name] = counts
    return paths


def phase_micro():
    """The align micro-bench's A/B: every implementation at 48 RoIs per
    image, the path of the tile and packed kernels."""
    reset_counts()
    micro_bench.run(BATCH, ("align48",), reps=3)
    counts = read_counts()
    print(f"launches micro-bench align48: {json.dumps(counts)}", flush=True)
    for name, n in counts.items():
        check(n > 0, f"the micro-bench A/B did not launch {name}")
    return counts


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


def kernel_record(name, launches, recs):
    """One entry of the kernels line: agreement over every comparison, and
    the times and bound of the three main-path calls in bfloat16 summed
    (one forward's aligns)."""
    timed = [r for r in recs if r["dtype"] == "bfloat16" and "ms" in r]
    return dict(
        name=name, route="cuda", source=SOURCES[name], replaces=REPLACED[name],
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in recs),
        ms=sum(r["ms"] for r in timed), plain_ms=sum(r["plain_ms"] for r in timed),
        bound_ms=sum(r["bound_ms"] for r in timed),
        bound_by=max(timed, key=lambda r: r["bound_ms"])["bound_by"],
        library_ms=None,
        calls=[{k: r[k] for k in ("call", "variant", "dtype", "rois", "out", "ms", "call_ms",
                                  "plain_ms", "empty_ms", "bound_ms", "bound_by",
                                  "bound_share", "max_abs_err")
                if k in r} for r in recs],
    )


def clocks_line() -> str:
    """The card's SM and memory clocks (now and maximum), temperature and
    power draw, as nvidia-smi gives them: times move with them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,clocks.max.sm,clocks.max.mem,"
         "temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, metavar="FILE",
                    help="profile the serving forward; write the table to FILE")
    ap.add_argument("--ab", metavar="[NAME=]SOURCE", action="append", default=[],
                    help="also time SOURCE, another build of kernel NAME's C interface "
                         "(a name of the kernels line; default roi_align, the direct "
                         "kernel), in turns with this one: phases 3-4 for the direct "
                         "kernel, phase 6 for a staged one (repeatable)")
    args = ap.parse_args()
    by_name = {name: k for k, name in KERNEL_NAMES.items()}
    ab_specs = []
    for spec in args.ab:
        name, _, src = spec.rpartition("=")
        name = name or "roi_align"
        if name not in by_name:
            ap.error(f"--ab {spec}: {name!r} is not one of {sorted(by_name)}")
        ab_specs.append((by_name[name], Path(src)))
    if not torch.cuda.is_available():
        print("FAIL no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card {card}", flush=True)
    print(f"clocks {clocks_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    try:
        rc.build_all()
        print(f"build {len(rc.build_all.libs)} libraries {rc.build_all.seconds:.2f} s",
              flush=True)
        for line in rc.build_all.log.splitlines():
            if line.startswith("==") or "registers" in line or "spill" in line:
                print(f"build {line.strip()}", flush=True)
        attributes = {roi_align_kernel: roi_align_kernel.attributes()}
        attributes.update({k: k.attributes() for k in rc.STAGED_KERNELS})
        for k, attr in attributes.items():
            print(f"build {KERNEL_NAMES[k]} " + json.dumps(attr), flush=True)
            check(all(a["local_bytes"] == 0 for a in attr.values()),
                  f"{KERNEL_NAMES[k]} uses local memory (spills or stack): {attr}")
        ab = [rc.RoIAlignKernel(source=src) for k, src in ab_specs if k is roi_align_kernel]
        ab_staged = {}
        for k, src in ab_specs:
            if k is not roi_align_kernel:
                ab_staged.setdefault(k, []).append(k.with_source(src))
        for other in ab + [o for v in ab_staged.values() for o in v]:
            other.build()
            for line in other.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"build ab {other.source.name} {line.strip()}", flush=True)

        cfg = get_config("kitti_multiclass")
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
        with align_env({}):
            synthetic = phase_kernel(cfg, flush, dev, ab)
        forward, default_counts, sess, requests, calls = phase_serve(cfg, flush, dev, card,
                                                                     args.profile, ab)
        with align_env({}):
            phase_tiny()
        staged = phase_staged(calls, flush, ab_staged)
        del calls
        paths = phase_serve_variants(sess, requests, cfg, card)
        micro = phase_micro()
    except SmokeFailure as e:
        print(f"FAIL {e}", file=sys.stderr)
        return 1

    direct = kernel_record("roi_align", default_counts["roi_align"], forward)
    direct["max_abs_err"] = max(r["max_abs_err"] for r in synthetic + forward)
    launches = {"roi_align_tile": micro["roi_align_tile"],
                "roi_align_band_tiered": paths["band tiered"]["roi_align_band_tiered"],
                "roi_align_band_packed": micro["roi_align_band_packed"],
                "roi_align_band_matmul": paths["bandmm"]["roi_align_band_matmul"]}
    kernels = [direct] + [
        kernel_record(name, n, [r for r in staged if r["kernel"] == name
                                and r["variant"] != "matmul t1 bf16"])
        for name, n in launches.items()]
    for rec in kernels:
        rec["attributes"] = attributes[by_name[rec["name"]]]
    print(f"clocks {clocks_line()}", flush=True)
    print(f"seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
