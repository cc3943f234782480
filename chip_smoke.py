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
   (``monorun_tpu_torch/csrc/*.cu``, one nvcc per source, in parallel),
   and the global atomics in the backward's SASS (``cuobjdump -sass``):
   the run fails unless each is a vector reduction of 4 float32;
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
9. the direct kernel's backward (``csrc/roi_align_bwd.cu``) against the
   plain version's autograd on the batch-8 pyramid of phase 3 at the
   training step's three shapes (1536 sampled RoIs at 7x7, 384 positives
   at 7x7 and 14x14), in bfloat16 and float32, both outputs (the level
   and the RoI gradients), with the kernel's time, its bound and share of
   the bound, the plain version's time and an empty launch's time;
10. training kitti_multiclass at full width (batch samples_per_device=3,
   384x1280, bfloat16 compute, seeded random weights, a seeded
   ``synthetic_train_batch``) through ``create_train_state`` ->
   ``train_step``: 3 AdamW steps, every loss present and finite, no
   non-finite gradient leaf, frozen parameters fixed and trainable ones
   moved, exactly 3 forward and 3 backward launches of the direct kernels
   per step and none of a staged kernel, each of the first step's three
   aligns (1536 sampled RoIs and 384 positives, bfloat16) against the plain
   version on its own features and RoIs, the backward re-run on the
   step's own features, RoIs and output gradients through the kernel and
   the plain version (with times as in phase 9), ms per step (median over
   the steps after the first) and peak memory;
11. a tiny float32 training step on the GPU (kernels) and on the CPU
   (plain version) with the same weights and batch, and the draws of one
   seeded CPU generator (``utils/draws.py``): every
   loss and every parameter's gradient compared, and the share of
   rpn_reg's gradient that comes by the proposals (the RoI path);
12. a ``kernels`` JSON line (the registers and local memory bytes per
   thread and dtype of the direct kernel, its backward and the four
   staged kernels, as the loaded build reports them, among their keys;
   local memory, a spill, fails the run) and, last, the JSON result line.

Every path (phases 4, 7, 8 and 10) runs with all launch counts set to 0
just before it and read just after; a kernel that its path did not launch
fails the run.

Tolerances (kernel against plain version; both accumulate in float32):
bfloat16 |d| <= 2^-7 |ref| + 1e-5 max(1, max|ref|), one bfloat16 rounding
of the output apart; float32 |d| <= 1e-5 |ref| + 1e-5 max(1, max|ref|),
the summation order of up to 36 samples x 4 taps; with the row product in
bfloat16 (matmul t1), one rounding of t1 more: + 2^-8 max|x|. The staged
kernels' gap to the gather version in bfloat16 (their interpolation
weights are rounded to bfloat16, and each axis's weights sum to at most
1): |d| <= 2^-7 max|x| + 2^-7 |ref|.

The backward kernel against the plain version's autograd in float32 on
the same (upcast) inputs and output gradient, rounded once to the level's
dtype: level gradients |d| <= r |ref| + 1e-5 max|ref|, r = 1e-5 in float32
(float32 atomics sum hundreds of taps in another order) and 2^-7 in
bfloat16 (both sides one bfloat16 rounding of float32 sums); RoI
gradients (float32 in both) |d| <= 1e-4 |ref| + 1e-4 max|ref| (channel
sums over hundreds of taps in another order). The tiny training step, GPU against
CPU: losses to 1e-4 relative (1e-3 after the PnP), each gradient to 1e-3
of its leaf's largest entry (cuDNN's convolution backward and the atomics
sum in other orders).

Bounds: the least time for a call is the larger of the bytes it must move
(the feature rows its taps touch with non-zero weight, the RoIs and the
output, each once) over 3.35 TB/s and its bilinear FMAs (4 per channel per
computed sample, 2 FLOPs each) over 67 TFLOP/s, the H100 SXM's float32
rate outside the tensor cores. Every kernel computes the same function,
so the staged kernels share the direct kernel's bound on the same call.
The backward's bound (``backward_work``): the output gradient read, each
touched level cell read once (for the RoI gradient), the dense level
gradient written once in the level's dtype, the RoIs read and their
gradient written; operations 2 FLOPs per channel per distinct tap of a
bin (the level gradient) and 2 x 2 per channel per tap of a computed
sample (the RoI gradient along each axis). Printed apart as
``design_bytes`` and ``design_ms`` (over 3.35 TB/s): the bytes this
kernel's design moves, which adds the float32 scratch of every level
zero-filled, a float32 read-modify-write of each touched cell, and for
bfloat16 levels the cast (4 bytes read, 2 written per element).

Any failed phase, or no GPU, exits non-zero without the last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from monorun_tpu_torch.apis.inference import init_inference
from monorun_tpu_torch.config import get_config
from monorun_tpu_torch.data.pipeline import device_preprocess
from monorun_tpu_torch.models.detector import (
    HeadDraws, MonoRUn, init_random_weights,
)
from monorun_tpu_torch.train import create_train_state, train_step
from monorun_tpu_torch.utils.synthetic import synthetic_train_batch
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
ALL_KERNELS = (roi_align_kernel, rc.roi_align_backward_kernel, *rc.STAGED_KERNELS)
KERNEL_NAMES = {roi_align_kernel: "roi_align",
                rc.roi_align_backward_kernel: "roi_align_backward",
                rc.tile_kernel: "roi_align_tile",
                rc.band_tiered_kernel: "roi_align_band_tiered",
                rc.band_packed_kernel: "roi_align_band_packed",
                rc.band_matmul_kernel: "roi_align_band_matmul"}
SOURCES = {"roi_align": KERNEL_SOURCE,
           "roi_align_backward": "monorun_tpu_torch/csrc/roi_align_bwd.cu",
           "roi_align_tile": "monorun_tpu_torch/csrc/roi_align_tile.cu",
           "roi_align_band_tiered": "monorun_tpu_torch/csrc/roi_align_band.cu",
           "roi_align_band_packed": "monorun_tpu_torch/csrc/roi_align_mma.cu",
           "roi_align_band_matmul": "monorun_tpu_torch/csrc/roi_align_mma.cu"}
REPLACED = {"roi_align": REPLACES,
            "roi_align_backward": "monorun_tpu/ops/roi_align_sorted.py:99 (_sorted_kernel, "
                                  "every align of the training step): its gradient, "
                                  "jax.grad through monorun_tpu/ops/roi_align.py:186",
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


def backward_reductions() -> dict:
    """The global atomics and reductions in the loaded backward build's
    SASS (``cuobjdump -sass``), counted by instruction."""
    lib = rc.build_all.libs["roi_align_bwd"]._name
    cuobjdump = Path(rc._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    ops = re.findall(r"\b((?:RED|ATOM)G?\.[A-Za-z0-9_.]+)", sass)
    return {op: ops.count(op) for op in sorted(set(ops))}


def touched_cells(feats, rois, strides, out_size, finest, max_ratio):
    """(level cells the call's taps touch with non-zero weight, computed
    samples)."""
    sizes = [(f.shape[1], f.shape[2]) for f in feats]
    rows, samples = [], 0
    for start in range(0, rois.shape[0], 1024):
        r, w, avg = ra.sample_taps(sizes, rois[start:start + 1024].float(), strides,
                                   out_size, finest, max_ratio, ra.LONG_SPAN_CAP)
        rows.append(torch.unique(r[(w > 0) & (avg > 0)]))
        samples += int(((w.sum(0) > 0) & (avg > 0)).sum())
    return int(torch.unique(torch.cat(rows)).numel()), samples


def align_work(feats, rois, strides, out_size, finest, max_ratio):
    """(bytes, FLOPs) one align call must move and do on these inputs."""
    C, item = feats[0].shape[-1], feats[0].element_size()
    touched, samples = touched_cells(feats, rois, strides, out_size, finest, max_ratio)
    n = rois.shape[0]
    nbytes = touched * C * item + n * 5 * 4 + n * out_size[0] * out_size[1] * C * item
    return nbytes, 2 * 4 * C * samples


def backward_work(feats, rois, strides, out_size, finest, max_ratio):
    """(bytes, FLOPs, design bytes) of one backward call on these inputs:
    what the function must move and do (the bound of the module
    docstring), and the bytes the kernel's design moves (with the float32
    scratch's zero fill, read-modify-write and cast)."""
    C, item = feats[0].shape[-1], feats[0].element_size()
    touched, samples = touched_cells(feats, rois, strides, out_size, finest, max_ratio)
    n = rois.shape[0]
    bins = n * out_size[0] * out_size[1]
    cells = sum(f.shape[0] * f.shape[1] * f.shape[2] for f in feats)
    nbytes = bins * C * item + touched * C * item + cells * C * item + n * 5 * 4 * 2
    cast = 6 if feats[0].dtype == torch.bfloat16 else 0
    design = (bins * C * item + touched * C * (item + 8) + cells * C * (4 + cast)
              + n * 5 * 4 * 2)
    distinct = tap_counts(feats, rois, strides, out_size, finest, max_ratio)[
        "distinct_taps_per_bin"] * bins
    return nbytes, int(2 * C * distinct + 2 * 2 * 4 * C * samples), design


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
        # the A/B times forward aligns only
        check((n > 0) != (name == "roi_align_backward"),
              f"the micro-bench A/B launched {name} {n} times")
    return counts


# ---- the direct kernel's backward ---------------------------------------------

# (rtol, atol share of max |ref|) of the level and the RoI gradients
GRAD_TOLERANCE = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (1e-5, 1e-5)}
ROI_GRAD_TOLERANCE = (1e-4, 1e-4)
TRAIN_STEPS = 3
TRAIN_LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "loss_dim",
                "loss_proj", "loss_calib", "loss_score", "mean_iou", "total_loss")
AFTER_PNP = ("loss_score", "mean_iou")


def plain_grads(feats, rois, strides, out_size, finest, max_ratio, grad_out):
    """The plain version's autograd in float32 on the upcast inputs:
    (level gradients, RoI gradient)."""
    f32 = [f.detach().float().requires_grad_() for f in feats]
    r32 = rois.detach().float().requires_grad_()
    out = ra.multilevel_roi_align(f32, r32, strides, out_size, finest, max_ratio=max_ratio,
                                  long_span_cap=ra.LONG_SPAN_CAP)
    grads = torch.autograd.grad(out, f32 + [r32], grad_out.float())
    return list(grads[:-1]), grads[-1]


def grad_err(got, ref, rtol, atol_rel):
    """(max abs error, within rtol |ref| + atol_rel max |ref|)."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    bound = rtol * ref.abs() + atol_rel * ref.abs().max()
    return float(d.max()), bool(torch.isfinite(got).all()) and bool((d <= bound).all())


def compare_backward(label, feats, rois, grad_out, strides, out_size, finest, max_ratio,
                     flush):
    """Backward kernel against the plain version's autograd on one call;
    prints one line and returns its record."""
    kernel = rc.roi_align_backward_kernel
    dtype = feats[0].dtype

    def run_kernel():
        return kernel(feats, rois, grad_out, strides, out_size, finest, max_ratio,
                      ra.LONG_SPAN_CAP)

    def run_plain():
        return plain_grads(feats, rois, strides, out_size, finest, max_ratio, grad_out)

    (d_levels, d_rois), (ref_levels, ref_rois) = run_kernel(), run_plain()
    torch.cuda.synchronize()
    errs = [grad_err(g, r.to(dtype), *GRAD_TOLERANCE[dtype])
            for g, r in zip(d_levels, ref_levels)]
    roi_err, roi_ok = grad_err(d_rois, ref_rois, *ROI_GRAD_TOLERANCE)
    nbytes, flops, design = backward_work(feats, rois, strides, out_size, finest, max_ratio)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    rec = dict(call=label, dtype=str(dtype).replace("torch.", ""), rois=int(rois.shape[0]),
               out=list(out_size), max_ratio=max_ratio,
               max_abs_err_levels=max(e for e, _ in errs), max_abs_err_rois=roi_err,
               max_abs_ref_levels=max(float(r.abs().max()) for r in ref_levels),
               max_abs_ref_rois=float(ref_rois.abs().max()),
               ms=device_ms(run_kernel, 15, flush), plain_ms=device_ms(run_plain, 3, flush),
               empty_ms=device_ms(roi_align_kernel.empty_launch, 15, flush),
               bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               design_bytes=design, design_ms=design / HBM_BYTES_PER_S * 1e3,
               launch_shape=kernel.launch_shape(int(rois.shape[0]), out_size))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["max_abs_err"] = max(rec["max_abs_err_levels"], roi_err)
    print("backward " + json.dumps(rec), flush=True)
    check(all(ok for _, ok in errs), f"backward kernel and plain autograd disagree on the "
                                     f"level gradients of {label} ({rec['dtype']})")
    check(roi_ok, f"backward kernel and plain autograd disagree on the RoI gradient of "
                  f"{label} ({rec['dtype']}): max abs error {roi_err}")
    return rec


def phase_backward(cfg, flush, dev):
    """The backward kernel on the batch-8 pyramid of phase 3 at the training
    step's three align shapes (per image: 512 sampled RoIs and 128
    positives at batch 3, so 1536 and 384), in both dtypes."""
    gen = torch.Generator(device=dev).manual_seed(2)
    H, W = cfg.data.pad_height, cfg.data.pad_width
    strides = ra.align_strides(cfg.neck.lazy_lower, cfg.bbox_head.featmap_strides)
    feats32 = [torch.randn(BATCH, H // s, W // s, cfg.neck.out_channels, generator=gen,
                           device=dev) for s in strides]
    tr = cfg.train
    n_sampled = tr.samples_per_device * tr.rcnn_num_samples // BATCH
    n_pos = tr.samples_per_device * tr.max_pos // BATCH
    sampled = synthetic_rois(n_sampled, BATCH, (375, 1242), 2.0, 600.0, gen, dev)
    pos = synthetic_rois(n_pos, BATCH, (375, 1242), 10.0, 400.0, gen, dev)
    bh, nh = cfg.bbox_head, cfg.noc_head
    calls = (
        ("sampled 7x7", sampled, (7, 7), bh.finest_scale, bh.align_max_ratio),
        ("positives 7x7", pos, (7, 7), bh.finest_scale, bh.align_max_ratio),
        ("positives 14x14", pos, (nh.roi_size,) * 2, nh.finest_scale, nh.align_max_ratio),
    )
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        feats = [f.to(dtype) for f in feats32]
        for label, rois, out_size, finest, mr in calls:
            grad_out = torch.randn((rois.shape[0],) + out_size + (feats[0].shape[-1],),
                                   generator=gen, device=dev).to(dtype)
            recs.append(compare_backward(f"synthetic {label}", feats, rois, grad_out,
                                         strides, out_size, finest, mr, flush))
        del feats
    return recs


# ---- training ----------------------------------------------------------------


def check_train_metrics(m, what):
    missing = set(TRAIN_LOSSES) - set(m)
    check(not missing, f"{what}: metrics miss {sorted(missing)}")
    for k in TRAIN_LOSSES:
        check(bool(torch.isfinite(torch.as_tensor(m[k])).all()), f"{what}: {k} is not finite")
    check(int(m["nonfinite_grad_leaves"]) == 0,
          f"{what}: {int(m['nonfinite_grad_leaves'])} non-finite gradient leaves")


def phase_train(flush, dev, card):
    """kitti_multiclass training at full width: 3 AdamW steps on a seeded
    synthetic batch, with the checks of the module docstring (phase 10)."""
    cfg = get_config("kitti_multiclass")
    Bt = cfg.train.samples_per_device
    H, W = cfg.data.pad_height, cfg.data.pad_width
    model, state, opt = create_train_state(cfg, total_steps=1000, device="cuda", seed=0)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_train_batch(cfg, Bt, (H, W), seed=0).items()}
    gen = torch.Generator(device=dev).manual_seed(3)
    # frozen stages, and the calibration scales (their only loss is off
    # before step 100)
    fixed = ("backbone.conv1.weight", "backbone.layer1.0.conv1.weight",
              "roi_head.pose_head.cov_calib_logscale")
    trainable = ("backbone.layer2.0.conv1.weight", "neck.lateral_convs.0.conv.weight",
                 "rpn_head.rpn_reg.weight", "roi_head.noc_head.convs.0.conv.weight")
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone() for n in fixed + trainable}

    recorded = []
    align = model._align

    def recording_align(feats, rois, head_cfg, out_size, tile_h, pyramid):
        out = align(feats, rois, head_cfg, out_size, tile_h, pyramid)
        rec = [feats, rois.detach(), head_cfg, out_size, out.detach(), None]
        out.register_hook(lambda g: rec.__setitem__(5, g.detach()))
        recorded.append(rec)
        return out

    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    with align_env({}):
        reset_counts()
        try:
            for i in range(TRAIN_STEPS):
                model._align = recording_align if i == 0 else align
                start = read_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = train_step(model, opt, state, batch, generator=gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                step = {k: v - start[k] for k, v in read_counts().items()}
                check_launches(step, {"roi_align": 3, "roi_align_backward": 3}, 1,
                               f"train step {i}")
                check_train_metrics(m, f"train step {i}")
                check(float(m["loss_calib"]) == 0.0, "loss_calib is on before step 100")
                losses.append({k: float(m[k]) for k in TRAIN_LOSSES})
        finally:
            model._align = align
        counts = read_counts()
    check_launches(counts, {"roi_align": 3, "roi_align_backward": 3}, TRAIN_STEPS, "train")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for n in fixed:
        check(torch.equal(params[n], before[n]), f"parameter {n} moved")
    for n in trainable:
        check(not torch.equal(params[n], before[n]), f"trainable parameter {n} did not move")
    ms = statistics.median(times[1:])
    print("train " + json.dumps(dict(
        config="kitti_multiclass", card=card, batch=Bt, canvas=[H, W],
        compute_dtype=cfg.compute_dtype, steps=TRAIN_STEPS, ms_per_step=ms, ms_each=times,
        first_ms=times[0], losses=losses, peak_mem_gib=peak, step=state.step,
        loss_ema=float(state.loss_ema))), flush=True)

    recs = []
    labels = ("sampled 7x7", "positives 7x7", "positives 14x14")
    for label, (feats, rois, head_cfg, out_size, out, grad_out) in zip(labels, recorded):
        check(grad_out is not None, f"the step's {label} align got no output gradient")
        n_lvl = len(head_cfg.featmap_strides)
        strides = ra.align_strides(cfg.neck.lazy_lower, head_cfg.featmap_strides)
        feats = [f.detach().contiguous() for f in feats[:n_lvl]]
        rois = rois.float().contiguous()
        with torch.no_grad():
            plain = ra.multilevel_roi_align(
                feats, rois, strides, out_size, head_cfg.finest_scale,
                max_ratio=head_cfg.align_max_ratio, long_span_cap=ra.LONG_SPAN_CAP)
        err, ok = max_err(out, plain)
        print(f"train align {label}: the step's kernel output ({out.dtype}, "
              f"{rois.shape[0]} RoIs) against plain version, max abs error {err}", flush=True)
        check(ok, f"the step's {label} align disagrees with the plain version")
        recs.append(compare_backward(
            f"train {label}", feats, rois, grad_out.contiguous(), strides, out_size,
            head_cfg.finest_scale, head_cfg.align_max_ratio, flush))
    del recorded, model, opt
    torch.cuda.empty_cache()
    return recs, counts, dict(ms_per_step=ms, peak_mem_gib=peak)


def tiny_train_config():
    cfg = tiny_config()
    r = dataclasses.replace
    return r(
        cfg,
        rpn=r(cfg.rpn, nms_pre=32, nms_post=32, train_nms_pre=32),
        train=r(cfg.train, rcnn_num_samples=32, max_pos=8, rpn_num_samples=32),
        noc_head=r(cfg.noc_head, with_lidar_loss=True, dropout2d_rate=0.5),
    )


def phase_tiny_train():
    """The same tiny float32 training step on the GPU and on the CPU: same
    weights, batch and draws; losses to 1e-4 (1e-3 after the PnP), each
    gradient to 1e-3 of its leaf's scale; and the RoI path's share of
    rpn_reg's gradient on both."""
    cfg = tiny_train_config()
    B, H, W = 2, cfg.data.pad_height, cfg.data.pad_width
    batch_np = synthetic_train_batch(cfg, B, (H, W), num_gt=6, num_pts=32, seed=1)
    cpu_model = init_random_weights(MonoRUn(cfg), torch.Generator().manual_seed(11))
    sd = cpu_model.state_dict()
    cpu_batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    out = {}
    for device in ("cpu", "cuda"):
        model = MonoRUn(cfg)
        model.load_state_dict(sd)
        model.to(device)
        batch = {k: v.to(device) for k, v in cpu_batch.items()}
        start = read_counts()
        # the draws come from a CPU generator of the same seed on both devices
        total, (losses, _) = model.train_forward(batch, torch.ones((), device=device),
                                                 generator=torch.Generator().manual_seed(12))
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        grads = torch.autograd.grad(total, params, retain_graph=True)
        rpn_only = torch.autograd.grad(losses["loss_rpn_cls"] + losses["loss_rpn_bbox"],
                                       model.rpn_head.rpn_reg.weight)[0]
        g_reg = grads[names.index("rpn_head.rpn_reg.weight")]
        share = float((g_reg - rpn_only).norm() / g_reg.norm())
        if device == "cuda":
            torch.cuda.synchronize()
            step = {k: v - start[k] for k, v in read_counts().items()}
            check_launches(step, {"roi_align": 3, "roi_align_backward": 3}, 1,
                           "tiny train step")
        out[device] = ({k: float(v.detach()) for k, v in dict(losses, total_loss=total).items()},
                       dict(zip(names, grads)), share)
    (cl, cg, cshare), (gl, gg, gshare) = out["cpu"], out["cuda"]
    loss_err = {}
    for k, v in cl.items():
        a, b = gl[k], v
        rtol = 1e-3 if k in AFTER_PNP else 1e-4
        loss_err[k] = abs(a - b) / max(abs(b), 1e-6)
        check(abs(a - b) <= rtol * max(abs(b), 1e-5), f"tiny train: {k} differs GPU vs CPU "
                                                      f"({a} against {b})")
    grad_rel = {}
    for n, ref in cg.items():
        got = gg[n].cpu().double()
        scale = float(ref.abs().max())
        grad_rel[n] = float((got - ref.double()).abs().max()) / max(scale, 1e-30)
        check(bool(((got - ref.double()).abs() <= 1e-3 * scale).all()),
              f"tiny train: the gradient of {n} differs GPU vs CPU "
              f"({grad_rel[n]} of its scale)")
    worst = max(grad_rel, key=grad_rel.get)
    print("tiny_train " + json.dumps(dict(
        losses=cl, loss_rel_err=loss_err,
        grad_max_err_of_scale=grad_rel[worst], worst_leaf=worst,
        zero_grad_leaves=sum(1 for v in cg.values() if not bool(v.any())),
        roi_path_share_of_rpn_reg_grad=dict(cpu=cshare, gpu=gshare))), flush=True)


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
        if name not in by_name or name == "roi_align_backward":
            ap.error(f"--ab {spec}: {name!r} is not a forward kernel of "
                     f"{sorted(set(by_name) - {'roi_align_backward'})}")
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
        attributes = {roi_align_kernel: roi_align_kernel.attributes(),
                      rc.roi_align_backward_kernel: rc.roi_align_backward_kernel.attributes()}
        attributes.update({k: k.attributes() for k in rc.STAGED_KERNELS})
        for k, attr in attributes.items():
            print(f"build {KERNEL_NAMES[k]} " + json.dumps(attr), flush=True)
            check(all(a["local_bytes"] == 0 for a in attr.values()),
                  f"{KERNEL_NAMES[k]} uses local memory (spills or stack): {attr}")
        reductions = backward_reductions()
        print("build roi_align_backward global atomics in the SASS " + json.dumps(reductions),
              flush=True)
        check(bool(reductions) and all("F32x4" in op for op in reductions),
              f"the backward's level gradient is not one vector reduction per 4 channels: "
              f"{reductions}")
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
        del sess, requests
        torch.cuda.empty_cache()
        with align_env({}):
            backward = phase_backward(cfg, flush, dev)
        train_recs, train_counts, _ = phase_train(flush, dev, card)
        with align_env({}):
            phase_tiny_train()
    except SmokeFailure as e:
        print(f"FAIL {e}", file=sys.stderr)
        return 1

    direct = kernel_record("roi_align", default_counts["roi_align"], forward)
    direct["max_abs_err"] = max(r["max_abs_err"] for r in synthetic + forward)
    launches = {"roi_align_tile": micro["roi_align_tile"],
                "roi_align_band_tiered": paths["band tiered"]["roi_align_band_tiered"],
                "roi_align_band_packed": micro["roi_align_band_packed"],
                "roi_align_band_matmul": paths["bandmm"]["roi_align_band_matmul"]}
    kernels = [direct, kernel_record("roi_align_backward", train_counts["roi_align_backward"],
                                     train_recs)] + [
        kernel_record(name, n, [r for r in staged if r["kernel"] == name
                                and r["variant"] != "matmul t1 bf16"])
        for name, n in launches.items()]
    kernels[1]["max_abs_err"] = max(r["max_abs_err"] for r in backward + train_recs)
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
