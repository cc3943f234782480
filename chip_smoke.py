#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``monorun_tpu_torch``) on one CUDA GPU.

Run from the repository root:

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --profile FILE  # phase 20's whole profiler table
                                          # (tools.profile_trace) to FILE
    python3 chip_smoke.py --ab SOURCE     # also time another build of the
                                          # direct kernel's C interface
                                          # (an earlier roi_align.cu) in
                                          # turns with this one, phases 3-4
                                          # (repeatable)
    python3 chip_smoke.py --ab NAME=SOURCE
                                          # the same for the staged kernel
                                          # NAME of the kernels line (e.g.
                                          # roi_align_band_matmul), phase 6,
                                          # or the backward
                                          # (roi_align_backward), phases 9-10

Phases, each printing its own lines:

1. the card's name and power limit, as nvidia-smi gives them;
2. the build of every hand-written CUDA RoIAlign kernel
   (``monorun_tpu_torch/csrc/*.cu``, one nvcc per source, in parallel),
   and the atomics in the backward's SASS (``cuobjdump -sass``): the run
   fails on any (the backward sums in a fixed order);
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
   the bound, its design's bytes, the plain version's time and an empty
   launch's time; a second call bit-equal to the first; the heaviest
   tile's RoI count (from the kernel's own index pass, the RoIs whose
   output gradient is zero left out as the kernel leaves them); the parts
   timed alone (the index pass, the levels' gradient with it, the RoIs'
   gradient); with ``--ab roi_align_backward=SOURCE`` (a build of the
   current interface) that build in turns with this one, its agreement
   with the plain version and whether it equals this one bit for bit,
   its design bytes, and its parts alone (the index pass, the levels',
   the RoIs');
10. training kitti_multiclass at full width (batch samples_per_device=3,
   384x1280, bfloat16 compute, seeded random weights, a seeded
   ``synthetic_train_batch``) through ``create_train_state`` ->
   ``train_step``: 3 AdamW steps, every loss present and finite, no
   non-finite gradient leaf, frozen parameters fixed and trainable ones
   moved, exactly 3 forward launches of the direct kernel and 9 of its
   backward per step (3 per align: the per-RoI kernel, the bucket sort,
   the tile kernel; ``STEP_LAUNCHES``) and none of a staged kernel, each
   of the first step's three
   aligns (1536 sampled RoIs and 384 positives, bfloat16) against the plain
   version on its own features and RoIs, the backward re-run on the
   step's own features, RoIs and output gradients through the kernel and
   the plain version (with times as in phase 9), and again on them cast
   to float32 (phase 16's compute dtype), ms per step (median over
   the steps after the first) and peak memory;
11. a tiny float32 training step on the GPU (kernels) and on the CPU
   (plain version) with the same weights and batch, and the draws of one
   seeded CPU generator (``utils/draws.py``): every
   loss and every parameter's gradient compared, and the share of
   rpn_reg's gradient that comes by the proposals (the RoI path);
12. evaluation: a mini-KITTI of 16 random 375x1242 PNGs in KITTI's calib
   and label layout (under the git-ignored ``build/``), then
   ``python -m monorun_tpu_torch.tools.test kitti_multiclass --val-set``
   run in-process at full width, batch 4, with ``--result-dir`` and
   ``--summary-file``: 16 result files, every AP key of the evaluator and
   each finite, exactly 3 direct-kernel launches per batch and none of
   another kernel, the first batch's three aligns (4000 proposals, 192
   detections) against the plain version on their own features and RoIs
   (with times as in phase 3); img/s over the whole ``run_eval`` (loading included),
   ms per batch of ``InferenceSession.run`` (host clock, synchronised),
   and the host's parts, each timed alone: decode, normalise and pad,
   the pinned upload of a batch, the detections' copy back, the evaluator
   (its native library built or loaded before the timed window, and that
   time printed apart);
13. the tiny float32 configuration (``test_scale`` 0.1) through
   ``run_eval`` on the same 16 images on the GPU and on the CPU, with the
   same weights and per-batch draws: validity masks and labels equal,
   results within phase 5's tolerances, the same AP dict; then again on
   labels made from the CPU's results, where that AP dict is not all 0;
14. ``python -m monorun_tpu_torch.demo.infer_imgs --device cuda`` on 4 of
   those PNGs: 4 visualisations, 3 direct-kernel launches per image, the
   first image's three aligns (batch 1: 1000 proposals, 48 detections)
   against the plain version (with times as in phase 3);
15. the training loop: a mini-KITTI of 12 training and 4 validation
   375x1242 PNGs (under ``build/``), then ``python -m
   monorun_tpu_torch.tools.train kitti_multiclass`` run in-process at full
   width (batch 3, 384x1280, bf16, seeded random weights): a first call of
   4 steps (``--max-steps 4``, one epoch) and a second that resumes from
   its ``step_4`` for the second epoch, a checkpoint and a validation
   (``_run_val``, batch 2) every epoch, a log record every step: exactly
   3 direct and 9 backward launches per step and 3 direct launches per
   validation batch, none of another kernel; the first step's three
   aligns against the plain version, forward and backward (as in phase
   10), and the first validation batch's (batch 2: 2000 proposals, 96
   detections; the shapes ``step_8`` is served at below) as in phase 3;
   finite losses in ``train_log.jsonl``; the frozen stages unmoved;
   the resumed steps continuing from 4; ``step_8`` loaded into a fresh
   model and optimizer on the card bit-equal to the trained state;
   ``init_inference`` on ``step_8`` holding the trained weights, with
   valid detections; ms per step inside the loop (loader, upload and
   logging included) beside phase 10's bare step, training img/s, the
   loop's wait on the loader, the upload, checkpoint save and load ms and
   MB, ``_run_val``'s ms and peak memory; the checkpoints removed after;
16. data parallelism (``monorun_tpu_torch/parallel/``), in spawned
   processes: (i) two ranks sharing the one card over Gloo
   (``parallel.process_group(backend="gloo", device="cuda:0")``) take one
   ``train_step`` of kitti_multiclass at full width in float32, rank r on
   rows 3r..3r+2 of a seeded global ``synthetic_train_batch`` of 6
   (384x1280) with its slice of one set of global ``TrainDraws``, against
   one process here on all 6 with the same weights and draws: the ranks'
   summed losses to 1e-4 relative (1e-3 after the PnP) and rank 0's
   all-reduced gradients to 1e-3 of each leaf's scale (phase 11's
   tolerances), the ranks' parameters, buffers and ``loss_ema`` bit-equal,
   3 direct and 9 backward launches per rank and none of a staged kernel,
   each rank's aligns against the plain version (as in phase 10); (iii)
   the same two ranks through ``train_detector`` at kitti_multiclass (bf16,
   a global batch of 6) on phase 15's 12 training images for 3 epochs:
   3 + 9 launches per step per rank, ms per step per rank (between the
   ends of an epoch's consecutive steps), global img/s and the gradient
   all-reduce's ms and share of a step, beside phase 15's world-1 loop;
   then one validation on phase 15's 4 validation images, run by both
   ranks (``_run_val``: each detects one of the two batches of 2, with 3
   direct-kernel launches, and both return the same AP dict), each rank's
   seconds in it;
   (ii) one rank under NCCL at world size 1: ``tools.train
   kitti_multiclass --distributed`` (bf16, batch 3, 2 steps, a checkpoint
   and a validation) on phase 15's mini-KITTI, the collectives the layer
   uses on the card, and ``tools.test --distributed`` (batch 4) on phase
   12's, whose results must match phase 12's within phase 13's tolerances
   with validity masks and labels equal;
17. the five fast serving presets (``kitti_multiclass_fast``, ``_fast_r50``,
   ``_fast2``, ``_fast2_r50``, ``_fast3_r50``), each at full width, depth
   and canvas with seeded random weights, served at batch 8 through
   ``init_inference(raw=True)`` -> ``InferenceSession.run`` as in phase 4:
   detections checked, exactly 3 direct-kernel launches per forward,
   each rung's three aligns (its proposals: 4096, 2048 or 1536 RoIs;
   detections 8 x 48, 24 or 16) against the plain version with times, ms
   per batch and frames/s beside phase 4's kitti_multiclass; then phase
   5's tiny check at the no-CARAFE cut (``dense_size == roi_size``, a
   196-point PnP);
18. the training closure (``tests/torch_e2e_closure.py``, the port's
   ``tests/test_e2e_synthetic.py``): a nano kitti_car_lidar_supv trained
   on 12 synthetic scenes through ``create_train_state`` -> ``train_step``
   on the card (up to 420 steps, JAX's early stop), served by
   ``InferenceSession`` and scored by the port's ``kitti_eval``, in
   float32 with every one of JAX's bars (finite gradients, ``mean_iou``,
   the moderate APs, the head-slot, crowded-scene, proposal-cut and 0.75x
   resolution guards, and the fast2 guard's second training at
   ``dense_size`` 14), a missed bar failing the run; then the base
   training once more in bfloat16 (finiteness and ``mean_iou`` its only
   bars; its APs a reading): 3 direct and 9 backward launches a step and 3
   direct launches a served batch, the first step's aligns forward and
   backward against the plain version (as in phase 10), the APs, steps
   and seconds of every training;
19. the released-checkpoint parity runbook: a mini-KITTI of 8 random
   375x1242 PNGs under ``KITTI_ROOT/training/`` (with
   ``mono3dsplit_val_list.txt``) and a ``.pth`` of seeded random
   kitti_multiclass weights under the reference key names (the RPN's and
   the bbox head's box regressors scaled by 1e-2, so that the boxes stay
   near their anchors and above KITTI's 25-pixel least height), then ``python
   -m monorun_tpu_torch.tools.parity KITTI_ROOT CKPT --activations``
   in-process at full width, batch 4: the deviations-OFF line, float32
   weights, the dense stride-2 level, ``head_slots`` 0 and TF32 off in
   effect; every torso stage (backbone, FPN, RPN) within 1e-3 of its std
   of the plain-torch replica on the CPU (``tests/torch_ref``); exactly 3
   direct-kernel launches per forward and none of another kernel; the
   first batch's aligns (4000 proposals on the 192x640 level 0, 400
   detections at 7x7 and 14x14) against the plain version with times;
   the AP keys of the evaluator, finite; then again on labels made from
   its own result files, where some AP is not 0; seconds, img/s and the
   stage deviations;
20. the profiling tools at full width: ``tools.profile_stages 8`` (the
   median over forwards of a forward's stage sum over its unsplit partner
   within 15 % of 1; one direct-kernel launch in each of align_proposals,
   global_head_mc and noc_head and none elsewhere), ``tools.flop_budget
   1`` (the backbone within 10 % of ResNet-101's 7.8 G multiply-adds at
   224x224 scaled to 384x1280, 152.8 GFLOP per image) and
   ``tools.profile_trace 8`` (the stages hold at least 90 % of its device
   time), each tool's tables printed: readings, not claims;
21. the cold start: ``python -m monorun_tpu_torch.tools.cold_profile 8``
   in four processes, one after another, under the git-ignored
   ``build/`` (``--cache-dir``): on one fresh builds' root (i) cold, (ii)
   again, now cached, (iii) ``--warm`` (``init_inference(warm=True)``),
   then (iv) ``--warm`` on a second fresh root, where the warm-up's
   build overlaps the weights' init; every mark of each, ``warm_start``'s
   pieces and the ``nvcc`` jobs each started, beside phase 2's build of
   every library. The run fails if (i) or (iv) builds another library
   than those of the kernels its requests launched, if (ii) or (iii)
   starts an ``nvcc`` job, if (iii)'s or (iv)'s first request starts a
   build, if a run's two requests do not launch the direct kernel
   exactly 3 times each, or if (iii)'s or (iv)'s first request gives
   other validity masks or labels than (i)'s (the same weights, inputs
   and seed, unwarmed) or results outside phase 5's tolerances; the
   times are readings;
22. a ``kernels`` JSON line (the registers and local memory bytes per
   thread and dtype of the direct kernel, its backward and the four
   staged kernels, as the loaded build reports them, among their keys;
   local memory, a spill, fails the run; each path's launches of the
   direct kernel and its backward under ``launches_by_path``, the
   processes of phase 16 summed, phase 21's requests under
   ``cold_start`` and every session's warm-up under ``warm_start``) and,
   last, the JSON result line.

Every path (phases 4, 7, 8, 10, 12, 14, 15, each of 16's, each rung of 17,
each closure of 18, both parity runs of 19, each tool of 20 and each run
of 21) runs with all launch counts set to 0 just before it and read just
after (in the process that runs it); a kernel that its path did not
launch fails the run. A session built on the card warms itself
(``utils/warm_start.py``: one forward, 3 launches of the direct kernel);
those launches, checked at each warm-up, move from the kernels' counts to
``warm_start``'s (``warm_apart``), so that a path whose session is built
inside its count window counts its own requests.

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
(the tile kernel sums hundreds of taps in another order) and 2^-7 in
bfloat16 (both sides one bfloat16 rounding of float32 sums); RoI
gradients (float32 in both) |d| <= 1e-4 |ref| + 1e-4 max|ref| (channel
sums over hundreds of taps in another order). The tiny training step, GPU against
CPU: losses to 1e-4 relative (1e-3 after the PnP), each gradient to 1e-3
of its leaf's largest entry (cuDNN's convolution backward and the align
backward sum in other orders than the CPU).

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
``design_bytes`` and ``design_ms`` (over 3.35 TB/s): the bytes the
kernels' design moves, which reads the output gradient once in the
per-RoI kernel and again for every tile a RoI meets (the bins staged
there, counted from the kernel's own index pass by ``tile_loads``), and
writes the tap lists once and reads them for every such tile.

Any failed phase, or no GPU, exits non-zero without the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from monorun_tpu_torch.apis.inference import (
    InferenceSession, detections_to_host, init_inference, upload,
)
from monorun_tpu_torch import parallel
from monorun_tpu_torch.apis import inference as apis_inference
from monorun_tpu_torch import train as ttrain
from monorun_tpu_torch.apis import train as apis_train
from monorun_tpu_torch.apis.test import run_eval
from monorun_tpu_torch.config import get_config
from monorun_tpu_torch.data.kitti import KITTI3DDataset
from monorun_tpu_torch.data.loader import PrefetchLoader
from monorun_tpu_torch.data.pipeline import (
    collate, load_image, prepare_test_sample, prepare_train_sample,
)
from monorun_tpu_torch.demo import infer_imgs
from monorun_tpu_torch.eval import _native as kitti_native
from monorun_tpu_torch.eval.kitti_eval import kitti_eval
from monorun_tpu_torch.models.detector import (
    HeadDraws, MonoRUn, init_random_weights,
)
from monorun_tpu_torch.train import create_train_state, make_optimizer, train_step
from monorun_tpu_torch.utils import checkpoint as ckpt
from monorun_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from monorun_tpu_torch.utils.draws import train_draws
from monorun_tpu_torch.utils.synthetic import synthetic_train_batch
from monorun_tpu_torch.utils.warm_start import serving_stems
from monorun_tpu_torch.ops import roi_align as ra
from monorun_tpu_torch.ops import roi_align_band as rb
from monorun_tpu_torch.ops import roi_align_cuda as rc
from monorun_tpu_torch.ops import roi_align_tile as rt
from monorun_tpu_torch.ops.roi_align_cuda import roi_align_kernel
from monorun_tpu_torch.tools import flop_budget, micro_bench, profile_stages, profile_trace
from monorun_tpu_torch.tools import parity as parity_tool
from monorun_tpu_torch.tools import test as tools_test
from monorun_tpu_torch.tools import train as tools_train
from monorun_tpu_torch.tools.micro_bench import align_env, card_line, device_ms

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
import torch_e2e_closure as closure  # noqa: E402  (the closure's helper, no JAX)

# phase 18 runs under torch's deterministic algorithms, and cuBLAS's need
# this before CUDA starts
os.environ.setdefault(*closure.CUBLAS_CONFIG)

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BATCH = 8
REQUESTS = 10          # timed serving requests, after 2 warm-up requests
KERNEL_SOURCE = "monorun_tpu_torch/csrc/roi_align.cu"
REPLACES = ("monorun_tpu/ops/roi_align_band.py:57 (_band_kernel), "
            "monorun_tpu/ops/roi_align_sorted.py:99 (_sorted_kernel)")
TOLERANCE = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (1e-5, 1e-5)}
ALL_KERNELS = tuple(rc.KERNELS.values())
KERNEL_NAMES = {k: name for name, k in rc.KERNELS.items()}
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


@contextlib.contextmanager
def patched(owner, name, value):
    """``owner.name`` set to ``value``, restored afterwards."""
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def wall_ms(fn, reps=5, sync=True):
    """Median host-clock ms of ``fn`` over ``reps`` calls, each synchronised
    with the card before and after when ``sync``."""
    times = []
    for _ in range(reps):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_err(got: torch.Tensor, ref: torch.Tensor):
    """(max abs error, whether it is within the dtype's tolerance)."""
    rtol, atol_rel = TOLERANCE[ref.dtype]
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    bound = rtol * ref.abs() + atol_rel * ref.abs().max().clamp(min=1.0)
    ok = bool(torch.isfinite(got).all()) and bool((d <= bound).all())
    return float(d.max()), ok


def backward_reductions() -> dict:
    """The atomics and reductions in memory (global or shared) in the loaded
    backward build's SASS (``cuobjdump -sass``), counted by instruction."""
    lib = rc.build_all.libs["roi_align_bwd"]._name
    cuobjdump = Path(rc._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    # a barrier's reduction (BAR.RED, __syncthreads_or) is not one
    ops = re.findall(r"(?<!BAR\.)\b((?:RED|ATOM)[GS]?\.[A-Za-z0-9_.]+)", sass)
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


def backward_work(feats, rois, strides, out_size, finest, max_ratio, tiles):
    """(bytes, FLOPs, design bytes) of one backward call on these inputs:
    what the function must move and do (the bound of the module
    docstring), and the bytes the kernels' design moves from memory: the
    per-RoI kernel's (the output gradient and the touched cells read once,
    the tap lists, rectangles, keys and flags written), the sort's, and
    the tile kernel's as ``tiles`` (``tile_loads``) counts them from the
    kernel's own index pass (each hit's staged bins, its lists and its
    bucket's walk, again for every tile it meets), then the level
    gradient written once."""
    C, item = feats[0].shape[-1], feats[0].element_size()
    touched, samples = touched_cells(feats, rois, strides, out_size, finest, max_ratio)
    n = rois.shape[0]
    bins = n * out_size[0] * out_size[1]
    cells = sum(f.shape[0] * f.shape[1] * f.shape[2] for f in feats)
    nbytes = bins * C * item + touched * C * item + cells * C * item + n * 5 * 4 * 2
    lists = n * sum(out_size) * 2 * max_ratio * 8
    design = (bins * C * item + touched * C * item + cells * C * item + lists
              + tiles["staged_grad_bytes"] + tiles["list_read_bytes"]
              + tiles["bucket_read_bytes"] + n * (5 * 4 * 2 + 4 * 4 * 2 + 4 * 3 + 4 * 4))
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
    return rc.launch_counts()


def check_recorded_aligns(what, recorded, cfg, flush, ab=()):
    """One forward's three aligns, as recorded: each output against the
    plain version on the same features and RoIs, then the kernel timed
    against it there (``compare_align``). Returns (records, the calls)."""
    recs, calls = [], []
    labels = ("proposals 7x7", "detections 7x7", "detections 14x14")
    with torch.inference_mode():
        for label, (feats, rois, head_cfg, out_size, _, out, _) in zip(labels, recorded):
            n_lvl = len(head_cfg.featmap_strides)
            strides = ra.align_strides(cfg.neck.lazy_lower, head_cfg.featmap_strides)
            feats = [f.contiguous() for f in feats[:n_lvl]]
            rois = rois.float().contiguous()
            plain = ra.multilevel_roi_align(
                feats, rois, strides, out_size, head_cfg.finest_scale,
                max_ratio=head_cfg.align_max_ratio, long_span_cap=ra.LONG_SPAN_CAP)
            err, ok = max_err(out, plain)
            print(f"{what} align {label}: the kernel's output against plain "
                  f"version, max abs error {err}", flush=True)
            check(ok, f"the {what}'s {label} align disagrees with the plain version")
            recs.append(compare_align(f"{what} {label}", feats, rois, strides, out_size,
                                      head_cfg.finest_scale, head_cfg.align_max_ratio,
                                      flush, ab=ab))
            calls.append((label, feats, rois, strides, out_size, head_cfg.finest_scale,
                          head_cfg.align_max_ratio, recs[-1]))
    return recs, calls


@contextlib.contextmanager
def recording_aligns(recorded, n=3, grad=False):
    """Every model's ``_align`` keeps its first ``n`` calls as [feats, rois,
    head_cfg, out_size, pyramid, out, output gradient]. With ``grad`` only
    calls under autograd count (a training step's three aligns), and the
    output gradient arrives with the backward; else it stays None."""
    align = MonoRUn._align

    def record(self, feats, rois, head_cfg, out_size, tile_h, pyramid):
        out = align(self, feats, rois, head_cfg, out_size, tile_h, pyramid)
        if len(recorded) < n and (out.requires_grad or not grad):
            rec = [feats, rois.detach(), head_cfg, out_size, pyramid, out.detach(), None]
            if grad:
                out.register_hook(lambda g: rec.__setitem__(6, g.detach()))
            recorded.append(rec)
        return out

    with patched(MonoRUn, "_align", record):
        yield


def serve_requests(sess, requests, record=False):
    """Serves each request, synchronised; returns (ms each, detections,
    the first forward's aligns as ``recording_aligns`` keeps them when
    ``record``)."""
    recorded = []
    model = sess.model
    align = model._align

    def recording_align(feats, rois, head_cfg, out_size, tile_h, pyramid):
        out = align(feats, rois, head_cfg, out_size, tile_h, pyramid)
        recorded.append((feats, rois, head_cfg, out_size, pyramid, out, None))
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


WARM_LAUNCHES = dict.fromkeys(rc.KERNELS, 0)
WARM_FORWARD = {"roi_align": 3}       # one serving forward's launches


def warm_apart() -> None:
    """Wraps ``InferenceSession``'s warm-up (``utils/warm_start.py``) in this
    process: each warm-up must launch the direct kernel 3 times (its one
    forward) and no other kernel, and its launches move from the kernels'
    counts to ``WARM_LAUNCHES``."""
    real = apis_inference.warm_start

    def warm_start(*args, **kw):
        before = read_counts()
        seconds = real(*args, **kw)
        got = {k: v - before[k] for k, v in read_counts().items()}
        want = {k: WARM_FORWARD.get(k, 0) for k in got}
        check(got == want, f"a session's warm-up launched {got}, expected {want}")
        for name, k in rc.KERNELS.items():
            WARM_LAUNCHES[name] += got[name]
            k.launches = before[name]
        return seconds

    apis_inference.warm_start = warm_start


def check_launches(counts: dict, per_forward: dict, forwards: int, what: str) -> None:
    want = {name: per_forward.get(name, 0) * forwards for name in counts}
    print(f"launches {what}: {json.dumps(counts)} over {forwards} forwards", flush=True)
    check(counts == want, f"{what}: launches {counts} in {forwards} forwards, "
                          f"expected {want}")


def phase_serve(cfg, flush, dev, card, ab=()):
    sess = init_inference("kitti_multiclass", batch_size=BATCH, device="cuda", seed=0,
                          raw=True)
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

    recs, calls = check_recorded_aligns("forward", recorded, cfg, flush, ab)
    del recorded
    return recs, counts, sess, requests, calls, ms


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
# launches of one align's backward (the per-RoI kernel, the bucket sort and
# the tile kernel), and of a training step's three aligns, forward and back
BACKWARD_LAUNCHES = 3
STEP_LAUNCHES = {"roi_align": 3, "roi_align_backward": 3 * BACKWARD_LAUNCHES}
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


def tile_loads(kernel, feats, rois, grad_out, strides, out_size, finest, max_ratio):
    """The tile kernel's work on a call, from the kernel's own index pass
    and without the RoIs whose output gradient is zero (which it leaves
    out): the most RoIs a tile walks (the stride-4 levels are where they
    pile up), the mean over tiles that walk any, and the tiles that do,
    with the tile shape and the RoIs left out; and the bytes it reads
    again for every tile a RoI meets: the output gradient of the bins it
    stages there (the span of bin rows whose row list reaches the tile's
    rows times the span of bin columns whose column list reaches its
    columns, as the kernel stages them), the RoI's lists, and for every
    block its bucket's order and rectangles."""
    ix = kernel.index(feats, rois, strides, out_size, finest, max_ratio, ra.LONG_SPAN_CAP)
    tile = kernel.tile(feats[0].dtype)
    th, tw = tile["rows"], tile["cols"]
    L, C, item = len(feats), feats[0].shape[-1], feats[0].element_size()
    slices = -(-C // tile["channels"])
    oh = out_size[0]
    zero = (grad_out.flatten(1) == 0).all(1)
    rects = ix.rects.long()
    kept = ~zero & (rects[:, 1] > rects[:, 0]) & (rects[:, 3] > rects[:, 2])
    taps = ix.lists[..., 0].long()
    live = (taps >= 0) & (ix.lists[..., 1].view(torch.float32) != 0)

    def spans(lists, live, lo, hi, size):
        """Per RoI, the sum over the tiles [lo, hi] it meets along one axis
        of the span of bins whose list reaches the tile."""
        idx = torch.where(live, lists // size, -1)
        total = torch.zeros_like(lo)
        for k in range(int((hi - lo).max()) + 1 if lo.numel() else 0):
            reach = (idx == (lo + k)[:, None, None]).any(-1)          # (m, bins of the axis)
            has = reach.any(1)
            first = reach.int().argmax(1)
            last = reach.shape[1] - 1 - reach.flip(1).int().argmax(1)
            total += torch.where(has & (lo + k <= hi), last - first + 1, 0)
        return total

    r = rects[kept]
    ty0, ty1 = r[:, 0] // th, (r[:, 1] - 1) // th
    tx0, tx1 = r[:, 2] // tw, (r[:, 3] - 1) // tw
    staged = (spans(taps[kept, :oh], live[kept, :oh], ty0, ty1, th)
              * spans(taps[kept, oh:], live[kept, oh:], tx0, tx1, tw))
    hits = int(((ty1 - ty0 + 1) * (tx1 - tx0 + 1)).sum())
    grids = {}
    keys = ix.keys.cpu().numpy()
    for key, (r0, r1, c0, c1) in zip(keys[kept.cpu().numpy()], r.cpu().numpy()):
        b, lvl = divmod(int(key), L)
        H, W = feats[lvl].shape[1:3]
        g = grids.setdefault((b, lvl), np.zeros((-(-H // th), -(-W // tw)), np.int64))
        g[r0 // th:(r1 - 1) // th + 1, c0 // tw:(c1 - 1) // tw + 1] += 1
    # every block of a level walks its bucket's order and rectangles
    counts = np.bincount(keys[(~zero).cpu().numpy()], minlength=feats[0].shape[0] * L)
    walked = sum(int(counts[b * L + lvl]) * -(-f.shape[1] // th) * -(-f.shape[2] // tw)
                 for lvl, f in enumerate(feats) for b in range(f.shape[0])) * slices
    loads = np.concatenate([g.ravel() for g in grids.values()]) if grids else np.zeros(1)
    busy = loads[loads > 0]
    worst = max(grids, key=lambda k: grids[k].max()) if grids else (0, 0)
    return dict(tile=tile, zero_gradient_rois=int(zero.sum()), max_rois_per_tile=int(loads.max()),
                max_tile_level=int(worst[1]),
                mean_rois_per_busy_tile=float(busy.mean()) if busy.size else 0.0,
                busy_tiles=int(busy.size), tile_hits=hits,
                staged_bins=int(staged.sum()),
                staged_grad_bytes=int(staged.sum()) * C * item,
                list_read_bytes=hits * slices * ix.lists[0].numel() * 4,
                bucket_read_bytes=walked * (4 + 16))


def compare_backward(label, feats, rois, grad_out, strides, out_size, finest, max_ratio,
                     flush, split=False, ab=()):
    """Backward kernel against the plain version's autograd on one call,
    with its bit-repeatability and its tiles' load; ``split`` also times
    its parts alone (the index pass, the levels' gradient, the RoIs'), and
    ``ab`` other builds (``RoIAlignBackwardKernel`` of another source) in
    turns with this one (other, this, this, other),
    their parts, design bytes, and whether their outputs equal this one's
    bit for bit. Prints one line and returns its record."""
    kernel = rc.roi_align_backward_kernel
    dtype = feats[0].dtype
    spec = (strides, out_size, finest, max_ratio, ra.LONG_SPAN_CAP)

    def run_kernel(**kw):
        return kernel(feats, rois, grad_out, *spec, **kw)

    def run_plain():
        return plain_grads(feats, rois, strides, out_size, finest, max_ratio, grad_out)

    (d_levels, d_rois), (ref_levels, ref_rois) = run_kernel(), run_plain()
    again_levels, again_rois = run_kernel()
    torch.cuda.synchronize()
    repeats = (all(torch.equal(a, b) for a, b in zip(d_levels, again_levels))
               and torch.equal(d_rois, again_rois))
    del again_levels, again_rois
    errs = [grad_err(g, r.to(dtype), *GRAD_TOLERANCE[dtype])
            for g, r in zip(d_levels, ref_levels)]
    roi_err, roi_ok = grad_err(d_rois, ref_rois, *ROI_GRAD_TOLERANCE)
    tiles = tile_loads(kernel, feats, rois, grad_out, *spec[:-1])
    nbytes, flops, design = backward_work(feats, rois, strides, out_size, finest, max_ratio,
                                          tiles)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    rec = dict(call=label, dtype=str(dtype).replace("torch.", ""), rois=int(rois.shape[0]),
               out=list(out_size), max_ratio=max_ratio,
               max_abs_err_levels=max(e for e, _ in errs), max_abs_err_rois=roi_err,
               max_abs_ref_levels=max(float(r.abs().max()) for r in ref_levels),
               max_abs_ref_rois=float(ref_rois.abs().max()), bit_repeatable=repeats,
               ms=device_ms(run_kernel, 15, flush), plain_ms=device_ms(run_plain, 3, flush),
               empty_ms=device_ms(roi_align_kernel.empty_launch, 15, flush),
               bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               design_bytes=design, design_ms=design / HBM_BYTES_PER_S * 1e3,
               launch_shape=kernel.launch_shape(int(rois.shape[0]), out_size), **tiles)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["max_abs_err"] = max(rec["max_abs_err_levels"], roi_err)
    if split:
        rec["split_ms"] = dict(
            index=device_ms(lambda: kernel.index(feats, rois, *spec), 15, flush),
            levels=device_ms(lambda: run_kernel(need_rois=False), 15, flush),
            rois=device_ms(lambda: run_kernel(need_features=False), 15, flush))
    rec["ab"] = []
    for other in ab:
        args = (feats, rois, grad_out) + spec
        (o_levels, o_rois) = other(*args)
        o_errs = [grad_err(g, r.to(dtype), *GRAD_TOLERANCE[dtype])
                  for g, r in zip(o_levels, ref_levels)]
        o_ok = all(ok for _, ok in o_errs) and grad_err(o_rois, ref_rois,
                                                        *ROI_GRAD_TOLERANCE)[1]
        same = (all(torch.equal(a, b) for a, b in zip(o_levels, d_levels))
                and torch.equal(o_rois, d_rois))
        del o_levels, o_rois
        calls = {other: lambda: other(*args), kernel: run_kernel}
        turns = [device_ms(calls[k], 15, flush) for k in (other, kernel, kernel, other)]
        parts = dict(
            index=device_ms(lambda: other.index(feats, rois, *spec), 15, flush),
            levels=device_ms(lambda: other(*args, need_rois=False), 15, flush),
            rois=device_ms(lambda: other(*args, need_features=False), 15, flush))
        o_design = backward_work(feats, rois, *spec[:-1], tile_loads(
            other, feats, rois, grad_out, *spec[:-1]))[2]
        rec["ab"].append(dict(
            source=str(other.source), agrees=o_ok, bit_equal=same, ms_turns=turns,
            ms=statistics.median([turns[0], turns[3]]), this_ms=statistics.median(turns[1:3]),
            split_ms=parts, design_bytes=o_design))
    print("backward " + json.dumps(rec), flush=True)
    check(all(ok for _, ok in errs), f"backward kernel and plain autograd disagree on the "
                                     f"level gradients of {label} ({rec['dtype']})")
    check(roi_ok, f"backward kernel and plain autograd disagree on the RoI gradient of "
                  f"{label} ({rec['dtype']}): max abs error {roi_err}")
    check(repeats, f"two backward calls on {label} ({rec['dtype']}) differ")
    return rec


def phase_backward(cfg, flush, dev, ab=()):
    """The backward kernel on the batch-8 pyramid of phase 3 at the training
    step's three align shapes (per image: 512 sampled RoIs and 128
    positives at batch 3, so 1536 and 384), in both dtypes, its parts
    timed apart, and ``ab`` (other builds of the backward) in turns."""
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
                                         strides, out_size, finest, mr, flush, split=True,
                                         ab=ab))
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


def phase_train(flush, dev, card, ab=()):
    """kitti_multiclass training at full width: 3 AdamW steps on a seeded
    synthetic batch, with the checks of the module docstring (phase 10);
    the step's backward aligns timed in parts and against ``ab``."""
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
    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    with align_env({}), recording_aligns(recorded, grad=True):
        reset_counts()
        for i in range(TRAIN_STEPS):
            start = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train_step(model, opt, state, batch, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            step = {k: v - start[k] for k, v in read_counts().items()}
            check_launches(step, STEP_LAUNCHES, 1,
                           f"train step {i}")
            check_train_metrics(m, f"train step {i}")
            check(float(m["loss_calib"]) == 0.0, "loss_calib is on before step 100")
            losses.append({k: float(m[k]) for k in TRAIN_LOSSES})
        counts = read_counts()
    check_launches(counts, STEP_LAUNCHES, TRAIN_STEPS, "train")
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

    recs, _ = check_train_aligns("train", recorded, cfg, flush, split=True, ab=ab)
    # the same backwards in float32, the compute dtype of phase 16's step
    check_train_aligns("train", recorded, cfg, flush, split=True, ab=ab, dtype=torch.float32)
    del recorded, model, opt
    torch.cuda.empty_cache()
    return recs, counts, dict(ms_per_step=ms, peak_mem_gib=peak)


def check_train_aligns(what, recorded, cfg, flush, split=False, ab=(), dtype=None):
    """A training step's three recorded aligns: each kernel output against
    the plain version on the same features and RoIs, then the backward
    kernel against the plain autograd on the step's own output gradients
    (``compare_backward``, with ``split`` and ``ab`` as there). Returns
    (the backward records, the forwards' largest error). With ``dtype``,
    the backwards alone on the features and output gradients cast to it."""
    check(len(recorded) == 3, f"{what}: {len(recorded)} aligns recorded, expected 3")
    recs, errs = [], []
    labels = ("sampled 7x7", "positives 7x7", "positives 14x14")
    for label, (feats, rois, head_cfg, out_size, _, out, grad_out) in zip(labels, recorded):
        check(grad_out is not None, f"{what}: the step's {label} align got no output gradient")
        n_lvl = len(head_cfg.featmap_strides)
        strides = ra.align_strides(cfg.neck.lazy_lower, head_cfg.featmap_strides)
        feats = [f.detach().contiguous() for f in feats[:n_lvl]]
        rois = rois.float().contiguous()
        if dtype is not None:
            recs.append(compare_backward(
                f"{what} {label}", [f.to(dtype) for f in feats], rois,
                grad_out.to(dtype).contiguous(), strides, out_size, head_cfg.finest_scale,
                head_cfg.align_max_ratio, flush, split=split, ab=ab))
            continue
        with torch.no_grad():
            plain = ra.multilevel_roi_align(
                feats, rois, strides, out_size, head_cfg.finest_scale,
                max_ratio=head_cfg.align_max_ratio, long_span_cap=ra.LONG_SPAN_CAP)
        err, ok = max_err(out, plain)
        errs.append(err)
        print(f"{what} align {label}: the step's kernel output ({out.dtype}, "
              f"{rois.shape[0]} RoIs) against plain version, max abs error {err}", flush=True)
        check(ok, f"{what}: the step's {label} align disagrees with the plain version")
        recs.append(compare_backward(
            f"{what} {label}", feats, rois, grad_out.contiguous(), strides, out_size,
            head_cfg.finest_scale, head_cfg.align_max_ratio, flush, split=split, ab=ab))
    return recs, max(errs, default=0.0)


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
            check_launches(step, STEP_LAUNCHES, 1,
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


def head_draws(cfg, n, gen):
    """The MC-dropout masks and RANSAC keys of n head slots, drawn on the
    CPU from ``gen``, so a GPU and a CPU run can be given the same draws."""
    gh = cfg.global_head

    def mask(shape, keep):
        return torch.where(torch.rand(shape, generator=gen) < keep, 1.0 / keep, 0.0)

    masks = (mask((n, gh.mc_samples, cfg.neck.out_channels), 1 - gh.dropout2d_rate),
             mask((n, gh.mc_samples, gh.fc_out_channels), 1 - gh.dropout_rate),
             mask((n, gh.mc_samples, gh.fc_out_channels), 1 - gh.dropout_rate))
    keys = torch.rand((n, cfg.pose_head.ransac_hypotheses, cfg.noc_head.dense_size ** 2),
                      generator=gen)
    return HeadDraws(masks, keys)


def tiny_no_carafe_config():
    """The tiny configuration at the fast2 rung's cut: ``dense_size ==
    roi_size`` (no CARAFE, a 196-point PnP), a quarter of the head slots."""
    cfg = tiny_config()
    r = dataclasses.replace
    return r(cfg, noc_head=r(cfg.noc_head, roi_size=14, dense_size=14),
             test=r(cfg.test, head_slots=3))


def phase_tiny(cfg=None, what="tiny"):
    """The same tiny model, weights and draws on the GPU and on the CPU:
    labels and validity exact, 2D outputs to 1e-4 and 3D outputs to 1e-3
    of their scale (8 LM iterations compound float32 rounding)."""
    cfg = cfg or tiny_config()
    B, K = 2, cfg.test.head_slots
    gen = torch.Generator().manual_seed(5)
    raw = torch.randint(0, 256, (B, 64, 128, 3), generator=gen, dtype=torch.uint8)
    cam = torch.tensor([[70.0, 0, 64], [0, 70.0, 32], [0, 0, 1]]).expand(B, 3, 3)
    shapes = torch.tensor([[60.0, 120.0], [64.0, 128.0]])
    cpu_draws = head_draws(cfg, B * K, gen)

    out = {}
    for device in ("cpu", "cuda"):
        sess = init_inference(cfg, batch_size=B, device=device, seed=7, raw=True)
        d = torch.device(device)
        draws = HeadDraws(tuple(m.to(d) for m in cpu_draws.mc_masks),
                          cpu_draws.ransac_keys.to(d))
        before = roi_align_kernel.launches
        det = sess.run(raw.to(d), cam.to(d), shapes.to(d), draws=draws)
        out[device] = to_cpu(det)
        if device == "cuda":
            check(roi_align_kernel.launches == before + 3,
                  f"the {what} GPU forward did not run the kernel 3 times")
    cpu, gpu = out["cpu"], out["cuda"]
    errs = compare_detections(gpu._asdict(), cpu._asdict(), f"{what} config, GPU vs CPU")
    print(f"{what} " + json.dumps(dict(valid=int(cpu.valid.sum()),
                                      rel_err_of_scale=errs)), flush=True)


def compare_detections(got: dict, ref: dict, what: str) -> dict:
    """Phase 5's tolerances: labels and validity masks equal, 2D outputs to
    1e-4 and 3D outputs to 1e-3 of their scale (8 LM iterations compound
    float32 rounding). Returns each output's largest error over its
    scale."""
    check(torch.equal(ref["labels"], got["labels"]), f"{what}: labels differ")
    check(torch.equal(ref["valid"], got["valid"]), f"{what}: validity differs")
    errs = {}
    for name, rtol in (("bboxes_2d", 1e-4), ("scores_2d", 1e-4), ("bboxes_3d", 1e-3),
                       ("pose_cov", 1e-3)):
        a, b = got[name].double(), ref[name].double()
        scale = float(b.abs().max().clamp(min=1e-6))
        errs[name] = float((a - b).abs().max()) / scale
        check(bool(((a - b).abs() <= rtol * b.abs() + rtol * scale).all()),
              f"{what}: {name} differs (max error {errs[name]} of scale)")
    return errs


def to_cpu(det):
    """Detections moved to the CPU, without the debug maps."""
    return det._replace(**{k: v.cpu() for k, v in det._asdict().items()
                           if isinstance(v, torch.Tensor)}, extras={})


# ---- evaluation: tools.test on a mini-KITTI --------------------------------

EVAL_IMAGES = 16
EVAL_BATCH = 4
EVAL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_eval"
KITTI_FX, KITTI_CX, KITTI_CY = 721.5377, 609.5593, 172.854   # a KITTI P2
OBJECT_HWL = {"Car": (1.5, 1.7, 4.0), "Pedestrian": (1.75, 0.6, 0.8),
              "Cyclist": (1.7, 0.6, 1.8)}


def write_mini_kitti(root: Path, n: int, seed: int) -> None:
    """n random 375x1242 PNGs in KITTI's layout: ``calib/`` with P0-P3 (P2
    with the camera's baseline offset), ``label_2/`` with 15 columns per
    object (cars, pedestrians, cyclists, DontCare regions) and the list
    ``train_list.txt``."""
    import cv2

    rng = np.random.default_rng(seed)
    for sub in ("image_2", "label_2", "calib"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    fx, cx, cy = KITTI_FX, KITTI_CX, KITTI_CY
    ids = [f"{i:06d}" for i in range(n)]
    for name in ids:
        cv2.imwrite(str(root / "image_2" / f"{name}.png"),
                    rng.integers(0, 256, (375, 1242, 3), dtype=np.uint8))
        (root / "calib" / f"{name}.txt").write_text("".join(
            f"P{c}: {fx} 0 {cx} {-0.06 * fx if c == 2 else 0.0} 0 {fx} {cy} 0 0 0 1 0\n"
            for c in range(4)))
        lines = []
        for _ in range(int(rng.integers(1, 5))):
            cls = str(rng.choice(["Car", "Pedestrian", "Cyclist", "DontCare"],
                                 p=[0.6, 0.15, 0.15, 0.1]))
            h3, w3, l3 = OBJECT_HWL.get(cls, OBJECT_HWL["Car"])
            z, u = rng.uniform(8, 35), rng.uniform(100, 1140)
            x, y, ry = (u - cx) * z / fx, rng.uniform(1.2, 1.8), rng.uniform(-np.pi, np.pi)
            v, bw, bh = fx * y / z + cy, fx * l3 / z, fx * h3 / z
            x1, y1, x2, y2 = max(u - bw / 2, 0), max(v - bh, 0), min(u + bw / 2, 1241), min(v, 374)
            box = f"{x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f}"
            if cls == "DontCare":
                lines.append(f"DontCare -1 -1 -10 {box} -1 -1 -1 -1000 -1000 -1000 -10")
                continue
            alpha = ry - np.arctan2(x, z + 0.27)
            lines.append(f"{cls} 0.00 0 {alpha:.2f} {box} {h3:.2f} {w3:.2f} {l3:.2f} "
                         f"{x:.2f} {y:.2f} {z:.2f} {ry:.2f}")
        (root / "label_2" / f"{name}.txt").write_text("\n".join(lines) + "\n")
    (root / "train_list.txt").write_text("\n".join(ids) + "\n")


class RecordingDataset(KITTI3DDataset):
    """Keeps the per-image results and the time of ``evaluate``."""

    def evaluate(self, results, **kw):
        self.results = results
        t0 = time.perf_counter()
        out = super().evaluate(results, **kw)
        self.evaluate_ms = (time.perf_counter() - t0) * 1e3
        return out


def timed(owner, name, times, sync=False):
    """``owner.name`` timed on the host clock (synchronised with ``sync``),
    each call's ms kept in ``times``; restored afterwards."""
    fn = getattr(owner, name)

    def wrapper(*args, **kw):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    return patched(owner, name, wrapper)


def phase_eval(card, flush):
    """``python -m monorun_tpu_torch.tools.test kitti_multiclass --val-set``,
    in-process, on a mini-KITTI of 16 images at full width, batch 4: 16
    result files, every AP key of the evaluator and each finite, 3 launches
    of the direct kernel per batch and none of another; img/s over the
    whole eval, ms per batch of ``session.run``, and the host's parts;
    the first batch's aligns against the plain version. The timed window
    runs under ``recording_aligns`` (it keeps the first batch's pyramid)
    and synchronises the card around each ``session.run``. The native
    evaluator is built (or loaded) before it, and its time printed apart:
    a fresh checkout compiles it at first use."""
    built = not kitti_native.lib_path().exists()
    t0 = time.perf_counter()
    lib = kitti_native.get_lib()
    native_s = time.perf_counter() - t0
    check(lib is not None, "the native KITTI evaluator did not build or load")
    print(f"eval native evaluator {kitti_native.lib_path().name} "
          f"{'built' if built else 'loaded'} in {native_s:.3f} s", flush=True)
    root = EVAL_DIR / "kitti"
    write_mini_kitti(root, EVAL_IMAGES, seed=21)
    results, summary = EVAL_DIR / "results", EVAL_DIR / "ap.json"
    argv = ["kitti_multiclass", "--val-set", "--batch-size", str(EVAL_BATCH),
            "--result-dir", str(results), "--summary-file", str(summary),
            "--cfg-options", f"data.train_root='{root}'", "data.val_list='train_list.txt'"]
    run_ms, eval_ms, sessions, datasets, recorded = [], [], [], [], []
    with contextlib.ExitStack() as stack:
        stack.enter_context(align_env({}))
        stack.enter_context(recording_aligns(recorded))
        stack.enter_context(timed(InferenceSession, "run", run_ms, sync=True))
        stack.enter_context(timed(tools_test, "run_eval", eval_ms))
        stack.enter_context(patched(tools_test, "KITTI3DDataset",
                                    keeping(RecordingDataset, datasets)))
        stack.enter_context(patched(tools_test, "init_inference",
                                    keeping(init_inference, sessions)))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        ap = tools_test.main(argv)
        tool_s = time.perf_counter() - t0
        counts = read_counts()
        peak_mem_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    check_launches(counts, {"roi_align": 3}, batches, "eval (tools.test)")
    check(len(run_ms) == batches, f"tools.test ran {len(run_ms)} batches, expected {batches}")
    files = sorted(p.name for p in results.iterdir())
    check(len(files) == EVAL_IMAGES, f"tools.test wrote {len(files)} result files, "
                                     f"expected {EVAL_IMAGES}")
    _, want = kitti_eval([], [], get_config("kitti_multiclass").data.classes)
    check(list(ap) == list(want), f"the AP keys {sorted(ap)} are not the evaluator's "
                                  f"{sorted(want)}")
    check(all(math.isfinite(v) for v in ap.values()), "an AP value is not finite")
    check(json.loads(summary.read_text()) == ap, "the summary file is not the AP dict")
    ds = datasets[0]
    n_valid = [int(r["valid"].sum()) for r in ds.results]
    sess = sessions[0]
    cfg = sess.cfg
    recs, _ = check_recorded_aligns("eval", recorded, cfg, flush)
    del recorded

    # the host's parts, each timed alone after the eval (in the eval the
    # loader's thread overlaps decode and normalise with the device)
    paths = [ds.image_path(i) for i in range(EVAL_IMAGES)]
    decode = wall_ms(lambda: [load_image(p, cfg.data.to_rgb) for p in paths], 3, sync=False)
    prepare = wall_ms(lambda: [prepare_test_sample(ds, i, cfg.data)
                               for i in range(EVAL_IMAGES)], 3, sync=False)
    batch = collate([prepare_test_sample(ds, i, cfg.data) for i in range(EVAL_BATCH)])

    def upload_batch():
        for k in ("images", "cam", "img_shapes"):
            upload(batch[k], sess.device, None if k == "images" else torch.float32)

    upload_ms = wall_ms(upload_batch, 5)
    det = sess.run(batch["images"], batch["cam"], batch["img_shapes"])
    torch.cuda.synchronize()
    to_host_ms = wall_ms(lambda: detections_to_host(det), 5)
    whole_ms = eval_ms[0]
    # prepare_test_sample: decode, the annotation, resize, normalise, pad
    parts = dict(prepare_test_sample=prepare, upload=upload_ms * batches,
                 to_host=to_host_ms * batches, evaluator=ds.evaluate_ms,
                 session_run=sum(run_ms))
    print("eval " + json.dumps(dict(
        config="kitti_multiclass", card=card, images=EVAL_IMAGES, batch=EVAL_BATCH,
        img_per_s=EVAL_IMAGES * 1e3 / whole_ms, run_eval_ms=whole_ms, tools_test_s=tool_s,
        run_ms_each=run_ms, run_ms_median=statistics.median(run_ms),
        run_ms_median_after_first=statistics.median(run_ms[1:]),
        native_evaluator_s=native_s, native_evaluator_built=built,
        host_parts_ms=parts, share_of_run_eval={k: v / whole_ms for k, v in parts.items()},
        decode_ms=decode,
        upload_bytes_per_batch=int(sum(batch[k].nbytes for k in ("images", "cam", "img_shapes"))),
        valid_detections=n_valid, ap_keys=len(ap), ap_max=max(ap.values()),
        peak_mem_gib=peak_mem_gib,
    )), flush=True)
    del sess, sessions, det, batch
    torch.cuda.empty_cache()
    return counts, root, recs, ds.results


def keeping(make, made):
    """``make``, keeping in ``made`` what each call returns."""
    def wrapper(*args, **kw):
        made.append(make(*args, **kw))
        return made[-1]
    return wrapper


def tiny_eval_pair(cfg, root, what):
    """``run_eval`` of ``cfg`` on the KITTI directory ``root`` on the CPU and
    on the GPU, with the same weights and, per batch, the draws of a CPU
    generator seeded with the batch's seed: validity masks and labels
    equal, results within phase 5's tolerances, the same AP dict, 3
    direct-kernel launches per GPU batch. Returns (the CPU's dataset, its
    AP dict, the results' largest errors relative to scale)."""
    K = cfg.test.head_slots
    out = {}
    for device in ("cpu", "cuda"):
        sess = init_inference(cfg, batch_size=EVAL_BATCH, device=device, seed=7)
        run, dev = sess.run, sess.device

        def seeded(images, cam, shapes, seed=0, run=run, dev=dev):
            d = head_draws(cfg, len(images) * K, torch.Generator().manual_seed(seed))
            return run(images, cam, shapes, seed=seed, draws=HeadDraws(
                tuple(m.to(dev) for m in d.mc_masks), d.ransac_keys.to(dev)))

        sess.run = seeded
        ds = RecordingDataset(str(root), "train_list.txt")
        start = read_counts()
        ap = run_eval(sess, ds, batch_size=EVAL_BATCH, print_summary=False, progress=False)
        if device == "cuda":
            step = {k: v - start[k] for k, v in read_counts().items()}
            check_launches(step, {"roi_align": 3}, -(-EVAL_IMAGES // EVAL_BATCH),
                           f"tiny eval, {what}")
        out[device] = (ds, ap)
    (cpu, ap_cpu), (gpu, ap_gpu) = out["cpu"], out["cuda"]
    errs = {}
    for i, (c, g) in enumerate(zip(cpu.results, gpu.results)):
        check((c["valid"] == g["valid"]).all() and (c["labels"] == g["labels"]).all(),
              f"tiny eval, {what}: image {i}'s validity or labels differ GPU vs CPU")
        for name, rtol in (("bboxes_2d", 1e-4), ("bboxes_3d", 1e-3), ("pose_cov", 1e-3)):
            a, b = torch.from_numpy(g[name]).double(), torch.from_numpy(c[name]).double()
            scale = float(b.abs().max().clamp(min=1e-6))
            errs[name] = max(errs.get(name, 0.0), float((a - b).abs().max()) / scale)
            check(bool(((a - b).abs() <= rtol * b.abs() + rtol * scale).all()),
                  f"tiny eval, {what}: image {i}'s {name} differs GPU vs CPU "
                  f"({errs[name]} of scale)")
    check(list(ap_gpu) == list(ap_cpu)
          and max(abs(ap_gpu[k] - ap_cpu[k]) for k in ap_cpu) <= 1e-9,
          f"tiny eval, {what}: the AP dicts differ GPU vs CPU")
    return cpu, ap_cpu, errs


def phase_eval_tiny(root):
    """The tiny float32 configuration (test_scale 0.1, so the 375x1242
    images fit its 64x128 pad) through ``run_eval`` on the GPU and on the
    CPU (``tiny_eval_pair``): first on the mini-KITTI's labels, where its
    random weights score AP 0, then on labels made from the CPU's own
    results, where the AP dicts compared are not all 0."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, test_scale=0.1))
    cpu, ap, errs = tiny_eval_pair(cfg, root, "random labels")
    labelled = EVAL_DIR / "self_labelled"
    shutil.copytree(root, labelled)
    cpu.write_result_files(cpu.format_results(cpu.results), str(labelled / "label_2"))
    _, ap_self, errs_self = tiny_eval_pair(cfg, labelled, "self labels")
    check(max(ap_self.values()) > 0.0,
          "tiny eval on labels made from its own results: every AP is 0")
    print("tiny_eval " + json.dumps(dict(
        valid=sum(int(r["valid"].sum()) for r in cpu.results),
        rel_err_of_scale={k: max(errs[k], errs_self[k]) for k in errs},
        ap_max=max(ap.values()), ap_max_self_labels=max(ap_self.values()),
        ap_nonzero_self_labels=sum(v > 0 for v in ap_self.values()))), flush=True)


def phase_demo(root, flush):
    """``python -m monorun_tpu_torch.demo.infer_imgs --device cuda`` on 4 of
    the eval's PNGs: 4 visualisations, 3 direct-kernel launches per image;
    the first image's aligns (batch 1) against the plain version."""
    imgs, out = EVAL_DIR / "demo_imgs", EVAL_DIR / "demo_viz"
    imgs.mkdir(parents=True, exist_ok=True)
    for p in sorted((root / "image_2").iterdir())[:4]:
        shutil.copy(p, imgs / p.name)
    calib = EVAL_DIR / "calib.csv"
    calib.write_text(f"{KITTI_FX},0,{KITTI_CX}\n0,{KITTI_FX},{KITTI_CY}\n0,0,1\n")
    sessions, recorded = [], []
    with contextlib.ExitStack() as stack:
        stack.enter_context(align_env({}))
        stack.enter_context(recording_aligns(recorded))
        stack.enter_context(patched(infer_imgs, "init_inference",
                                    keeping(init_inference, sessions)))
        reset_counts()
        results = infer_imgs.main([str(imgs), "kitti_multiclass", "--calib", str(calib),
                                   "--device", "cuda", "--show-dir", str(out)])
        counts = read_counts()
    check_launches(counts, {"roi_align": 3}, 4, "demo infer_imgs")
    written = sorted(p.name for p in out.iterdir())
    check(written == sorted(p.name for p in imgs.iterdir()) and len(results) == 4,
          f"infer_imgs wrote {written} for 4 images")
    recs, _ = check_recorded_aligns("demo", recorded, sessions[0].cfg, flush)
    del recorded, sessions
    torch.cuda.empty_cache()
    print("demo " + json.dumps(dict(images=4, visualisations=len(written))), flush=True)
    return counts, recs


# ---- the training loop: tools.train on a mini-KITTI ------------------------------

LOOP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
LOOP_TRAIN, LOOP_VAL = 12, 4
LOOP_EPOCH_STEPS = 4          # 12 images at samples_per_device 3
VAL_BATCH = 2                 # _run_val's batch


def phase_train_loop(card, flush, bare_ms):
    """``python -m monorun_tpu_torch.tools.train kitti_multiclass`` in-process
    at full width (384x1280, batch 3, bf16, seeded random weights) on a
    mini-KITTI of 12 training and 4 validation images: a first call of 4
    steps (``--max-steps 4``, one epoch), then a second call that resumes
    from its ``step_4`` for the second epoch; a checkpoint, a validation
    and a log record every epoch or step. Checks: 3 direct-kernel and 3
    backward launches per step and 3 direct ones per validation batch, none
    of another kernel; the first step's aligns against the plain version,
    forward and backward, and the first validation batch's (recorded
    under ``recording_aligns``, held and timed as in phase 3); finite
    losses; the frozen stages unmoved; the
    resumed run's steps continuing from 4; ``step_8`` loaded into a fresh
    model and optimizer on the card bit-equal; ``init_inference`` serving
    ``step_8``. Prints ms per step inside the loop (the time between the
    ends of consecutive steps of an epoch: loader, upload and logging
    included), training img/s, the loop's wait on the loader per step,
    checkpoint save and load ms and MB, ``_run_val``'s ms and peak
    memory."""
    cfg = get_config("kitti_multiclass")
    shutil.rmtree(LOOP_DIR, ignore_errors=True)     # no step_N of an earlier run to resume
    root, work = LOOP_DIR / "kitti", LOOP_DIR / "work"
    write_mini_kitti(root, LOOP_TRAIN + LOOP_VAL, seed=31)
    ids = (root / "train_list.txt").read_text().split()
    (root / "loop_train.txt").write_text("\n".join(ids[:LOOP_TRAIN]) + "\n")
    (root / "loop_val.txt").write_text("\n".join(ids[LOOP_TRAIN:]) + "\n")
    argv = ["kitti_multiclass", "--work-dir", str(work), "--cfg-options",
            f"data.train_root='{root}'", "data.train_list='loop_train.txt'",
            "data.val_list='loop_val.txt'", "train.total_epochs=2",
            "train.checkpoint_interval=1", "train.eval_interval=1", "train.log_interval=1"]
    made, recorded, val_recorded = [], [], []
    steps, waits, saves, loads, vals = [], [], [], [], []
    watched = ("backbone.conv1.weight", "backbone.layer1.0.conv1.weight",
               "backbone.layer2.0.conv1.weight", "rpn_head.rpn_reg.weight")
    init = {}
    run_val = apis_train._run_val

    def create(*args, **kw):
        made.append(create_train_state(*args, **kw))
        params = dict(made[-1][0].named_parameters())
        init.update({n: params[n].detach().clone() for n in watched if n not in init})
        return made[-1]

    def step(*args, **kw):
        start, t0 = read_counts(), time.perf_counter()
        out = train_step(*args, **kw)
        torch.cuda.synchronize()
        steps.append(dict(start=t0, end=time.perf_counter(),
                          launches={k: v - start[k] for k, v in read_counts().items()}))
        return out

    def validate(*args):
        start, t0 = read_counts(), time.perf_counter()
        # the first validation keeps its first batch's aligns
        with recording_aligns(val_recorded) if not vals else contextlib.nullcontext():
            ap = run_val(*args)
        torch.cuda.synchronize()
        vals.append(dict(ms=(time.perf_counter() - t0) * 1e3, ap=ap,
                         launches={k: v - start[k] for k, v in read_counts().items()}))
        return ap

    def save(*args):
        t0 = time.perf_counter()
        path = save_checkpoint(*args)
        saves.append(dict(ms=(time.perf_counter() - t0) * 1e3, path=path,
                          mb=(Path(path) / ckpt.FILE).stat().st_size / 1e6))
        return path

    def load(path, *args):
        t0 = time.perf_counter()
        state = load_checkpoint(path, *args)
        torch.cuda.synchronize()
        loads.append(dict(ms=(time.perf_counter() - t0) * 1e3, path=path, step=state.step))
        return state

    class TimedLoader(PrefetchLoader):
        """Keeps the ms the loop waits for each batch."""

        def __iter__(self):
            it, first = super().__iter__(), True
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                waits.append(dict(ms=(time.perf_counter() - t0) * 1e3, first=first))
                first = False
                yield batch

    with contextlib.ExitStack() as stack:
        stack.enter_context(align_env({}))
        stack.enter_context(recording_aligns(recorded, grad=True))
        for name, fn in (("create_train_state", create), ("train_step", step),
                         ("_run_val", validate), ("save_checkpoint", save),
                         ("load_checkpoint", load), ("PrefetchLoader", TimedLoader)):
            stack.enter_context(patched(apis_train, name, fn))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        tools_train.main(argv + ["--max-steps", str(LOOP_EPOCH_STEPS)])
        first_s = time.perf_counter() - t0
        model, state = tools_train.main(argv)
        counts = read_counts()
        dev = next(model.parameters()).device
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        total_s = time.perf_counter() - t0

    n_steps, n_val_batches = 2 * LOOP_EPOCH_STEPS, -(-LOOP_VAL // VAL_BATCH)
    per_step = STEP_LAUNCHES
    check(len(steps) == n_steps, f"train loop: {len(steps)} steps, expected {n_steps}")
    for i, s in enumerate(steps):
        check_launches(s["launches"], per_step, 1, f"train loop step {i + 1}")
    check(len(vals) == 2, f"train loop: {len(vals)} validations, expected 2")
    for v in vals:
        check_launches(v["launches"], {"roi_align": 3}, n_val_batches, "train loop _run_val")
        check(bool(v["ap"]) and all(math.isfinite(x) for x in v["ap"].values()),
              "train loop: a validation AP is missing or not finite")
    check_launches(counts, {"roi_align": 3 * (n_steps + 2 * n_val_batches),
                            "roi_align_backward": per_step["roi_align_backward"] * n_steps},
                   1, "train loop (both calls)")

    log = [json.loads(ln) for ln in (work / "train_log.jsonl").read_text().splitlines()]
    check([(r["step"], r["epoch"]) for r in log]
          == [(i + 1, i // LOOP_EPOCH_STEPS) for i in range(n_steps)],
          f"train loop: the log's steps and epochs {[(r['step'], r['epoch']) for r in log]}")
    for r in log:
        check(set(TRAIN_LOSSES) <= set(r), f"train loop: the log misses a loss: {sorted(r)}")
        check(all(math.isfinite(v) for v in r.values()), f"train loop: a value is not "
                                                          f"finite at step {r['step']}")
    check([(Path(ld["path"]).name, ld["step"]) for ld in loads] == [("step_4", 4)],
          f"train loop: the second call resumed {loads}, expected step_4 at step 4")
    check([Path(sv["path"]).name for sv in saves] == ["step_4"] * 2 + ["step_8"] * 2,
          f"train loop: checkpoints {[sv['path'] for sv in saves]}")
    check(state.step == n_steps, f"train loop: final step {state.step}")

    # the frozen stages unmoved (each call starts from the same seeded
    # weights), the rest moved
    params = dict(model.named_parameters())
    for n in watched:
        frozen = n.startswith(("backbone.conv1", "backbone.layer1."))
        check(torch.equal(params[n], init[n]) == frozen,
              f"train loop: {n} {'moved' if frozen else 'did not move'}")

    # the round trip: step_8 into a fresh model and optimizer on the card
    with dev:
        fresh = MonoRUn(model.cfg)
    fresh_opt = make_optimizer(model.cfg, fresh, 2 * LOOP_EPOCH_STEPS)
    t0 = time.perf_counter()
    got = load_checkpoint(str(work / "step_8"), fresh, fresh_opt)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    opt = made[-1][2]
    want = model.state_dict()
    check(all(torch.equal(v, want[k]) for k, v in fresh.state_dict().items())
          and all(a is b is None or torch.equal(a, b)
                  for a, b in zip(fresh_opt.mu + fresh_opt.nu, opt.mu + opt.nu))
          and fresh_opt.count == opt.count and got.step == state.step
          and torch.equal(got.loss_ema, state.loss_ema),
          "train loop: step_8 loaded on the card is not bit-equal to the trained state")
    del fresh, fresh_opt, made

    # init_inference serves step_8: the trained weights (at the compute
    # dtype), finite detections of two validation images
    sess = init_inference("kitti_multiclass", str(work / "step_8"), batch_size=VAL_BATCH,
                          device="cuda")
    served = sess.model.state_dict()
    check(all(torch.equal(served[k], v.to(served[k].dtype)) for k, v in want.items()),
          "train loop: init_inference(step_8) does not hold the trained weights")
    val_ds = KITTI3DDataset(str(root), "loop_val.txt")
    batch = collate([prepare_test_sample(val_ds, i, cfg.data) for i in range(VAL_BATCH)])
    start = read_counts()
    det = sess.run(batch["images"], batch["cam"], batch["img_shapes"])
    torch.cuda.synchronize()
    check_launches({k: v - start[k] for k, v in read_counts().items()}, {"roi_align": 3}, 1,
                   "init_inference(step_8)")
    check_detections(det, cfg, VAL_BATCH)
    del sess, det, want, model

    recs, fwd_err = check_train_aligns("train loop", recorded, cfg, flush)
    val_recs, _ = check_recorded_aligns("train loop val", val_recorded, cfg, flush)
    del recorded, val_recorded
    # the pinned upload of one training batch, alone
    train_ds = KITTI3DDataset(str(root), "loop_train.txt")
    rng = np.random.default_rng(0)
    host = collate([prepare_train_sample(train_ds, i, cfg.data, rng)
                    for i in range(cfg.train.samples_per_device)])
    upload_ms = wall_ms(lambda: [upload(v, dev) for v in host.values()], 5)
    # ms between the ends of consecutive steps of one epoch
    gaps = [(b["end"] - a["end"]) * 1e3 for e in range(2)
            for a, b in zip(steps[e * LOOP_EPOCH_STEPS:(e + 1) * LOOP_EPOCH_STEPS - 1],
                            steps[e * LOOP_EPOCH_STEPS + 1:(e + 1) * LOOP_EPOCH_STEPS])]
    ms = statistics.median(gaps)
    Bt = cfg.train.samples_per_device
    print("train_loop " + json.dumps(dict(
        config="kitti_multiclass", card=card, batch=Bt, canvas=[cfg.data.pad_height,
                                                                 cfg.data.pad_width],
        compute_dtype=cfg.compute_dtype, steps=n_steps, ms_per_step=ms, ms_between_steps=gaps,
        train_img_per_s=Bt * 1e3 / ms, bare_train_step_ms=bare_ms,
        first_step_ms=[(s["end"] - s["start"]) * 1e3 for s in steps[::LOOP_EPOCH_STEPS]],
        step_ms=[(s["end"] - s["start"]) * 1e3 for s in steps],
        loader_wait_ms_per_step=sum(w["ms"] for w in waits) / len(waits),
        loader_wait_ms_after_first=statistics.median(w["ms"] for w in waits if not w["first"]),
        loader_wait_ms_first=[w["ms"] for w in waits if w["first"]],
        upload_ms_per_batch=upload_ms,
        checkpoint_save_ms=[sv["ms"] for sv in saves], checkpoint_mb=saves[-1]["mb"],
        checkpoint_resume_load_ms=loads[0]["ms"], checkpoint_load_ms_fresh_model=load_ms,
        run_val_ms=[v["ms"] for v in vals], val_images=LOOP_VAL,
        first_call_s=first_s, both_calls_s=total_s, peak_mem_gib=peak,
        final_losses={k: log[-1][k] for k in TRAIN_LOSSES})), flush=True)
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, recs, fwd_err, val_recs, dict(ms_per_step=ms, train_img_per_s=Bt * 1e3 / ms)


# ---- data parallelism on the card: two ranks on one H100, and NCCL at world 1 ----------

DP_WORLD = 2
DP_BATCH = 6                  # the global batch: rows 3r..3r+2 on rank r
DP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dp"
DP_LOOP_EPOCHS = 3            # 12 images at a global batch of 6: 2 steps an epoch
DP_TIMEOUT_S = 900
DP_PATHS = ("train_dp", "train_dp_loop", "train_nccl", "eval_nccl")


def dp_config():
    """kitti_multiclass at full width, computing in float32 (the
    equivalence check's precision)."""
    return dataclasses.replace(get_config("kitti_multiclass"), compute_dtype="float32")


def dp_model(cfg, device):
    """The model, train state and optimizer of phase 16's step, with the
    weights of the serving init (``init_random_weights``' plain normal,
    seeded 0), not the training init's truncated normal. At the training
    init the bbox head's last FCs round differently on the RoIs of a batch
    of 6 and of 3 (about 1e-6), and the float32 PnP carries that to some
    nearly degenerate rows' poses and covariances in full; a rank's rows
    are those of one process on its half, bit for bit
    (``tests/torch_dp_rows.py``, ROADMAP Queue 3 item 10). At the serving
    init the score head's loss on such rows is next to nothing, so every
    gradient is held across ranks at phase 11's tolerance. The score
    head's gradient across ranks on the training init's rows is held on
    the CPU (``tests/test_torch_parallel.py``, on rows captured here)."""
    model, state, opt = create_train_state(cfg, total_steps=1000, device=device, seed=0)
    init_random_weights(model, torch.Generator().manual_seed(0))
    return model, state, opt


def dp_draws(cfg, batch, seed):
    """Every random draw of one training step on the global ``batch``
    (``utils/draws.py:train_draws``, as ``train_detector`` makes them), from
    a generator on the batch's device seeded with ``seed``: every process
    that calls it with the same batch gets the same draws."""
    dev = batch["images"].device
    B, H, W = batch["images"].shape[:3]
    return train_draws(cfg, B, (H, W), batch["gt_boxes"].shape[1],
                       torch.Generator(device=dev).manual_seed(seed), dev)


def keep_step_grads(opt, into):
    """``opt.step`` keeping (on the host) the gradients it is given, which
    ``train_step`` has all-reduced."""
    step = opt.step

    def wrapper(grads):
        into.update({n: g.detach().float().cpu() for n, g in zip(opt.names, grads)})
        step(grads)

    opt.step = wrapper


def dp_rank_env(rank, world, port):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))


def same_on_every_rank(tensors) -> bool:
    """Whether every rank holds tensors bit-equal to rank 0's."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    torch.distributed.broadcast(ref, 0)
    ok = torch.tensor([int(torch.equal(ref, flat))], device=flat.device)
    torch.distributed.all_reduce(ok, op=torch.distributed.ReduceOp.MIN)
    return bool(ok)


def timed_all_reduce(times):
    """``train.all_reduce_sum`` synchronised and timed: each call's ms and
    element count kept in ``times``."""
    fn = ttrain.all_reduce_sum

    def wrapper(tensors):
        tensors = list(tensors)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(tensors)
        torch.cuda.synchronize()
        times.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          elements=sum(t.numel() for t in tensors)))
        return out

    return patched(ttrain, "all_reduce_sum", wrapper)


def dp_rank(rank, port, loop_root):
    """One of two ranks on the one card, over Gloo: (i) the full-width
    float32 step on rows 3r..3r+2 of the global batch, its launches and
    aligns checked here; (iii) the training loop on the mini-KITTI at
    ``loop_root`` (bf16, a global batch of 6). Writes ``DP_DIR/rank{r}.json``
    and, rank 0, the step's gradients to ``DP_DIR/grads.pt``."""
    dp_rank_env(rank, DP_WORLD, port)
    with parallel.process_group(backend="gloo", device="cuda:0") as dev:
        rc.build_all()
        cfg = dp_config()
        model, state, opt = dp_model(cfg, dev)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in synthetic_train_batch(cfg, DP_BATCH, (cfg.data.pad_height,
                                                                   cfg.data.pad_width),
                                                   seed=0).items()}
        draws = dp_draws(cfg, batch, seed=4)
        grads, recorded = {}, []
        keep_step_grads(opt, grads)
        with align_env({}), recording_aligns(recorded, grad=True):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train_step(model, opt, state, parallel.shard_batch(batch, rank, DP_WORLD),
                                  parallel.shard_batch(draws, rank, DP_WORLD))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
        recs, fwd_err = check_train_aligns(f"dp rank {rank}", recorded, cfg, flush)
        equal = same_on_every_rank(list(model.parameters()) + list(model.buffers())
                                   + [state.loss_ema])
        if rank == 0:
            torch.save(grads, DP_DIR / "grads.pt")
        out = dict(rank=parallel.rank(), world=parallel.world_size(), launches=counts,
                   metrics={k: float(v) for k, v in m.items()}, first_step_ms=step_ms,
                   params_equal_on_every_rank=equal, backward_recs=recs, align_err=fwd_err,
                   loss_ema=float(state.loss_ema))
        del model, opt, state, batch, draws, grads, recorded, flush
        torch.cuda.empty_cache()
        out["loop"] = dp_loop(loop_root, dev)
        (DP_DIR / f"rank{rank}.json").write_text(json.dumps(out))


def dp_loop(root, dev):
    """``train_detector`` at kitti_multiclass (bf16, samples_per_device 3, so
    a global batch of 6) on ``root``'s 12 images for 3 epochs of 2 steps,
    no checkpoint but the last and one validation, after the last epoch, on
    its 4 validation images: each step's end, launches and all-reduce ms,
    and the validation's seconds, launches, seeds and AP on this rank."""
    cfg = get_config("kitti_multiclass")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, train_root=str(root), train_list="loop_train.txt"), train=dataclasses.replace(
        cfg.train, total_epochs=DP_LOOP_EPOCHS, checkpoint_interval=0,
        eval_interval=DP_LOOP_EPOCHS, tensorboard=False))
    steps, reduces, waits, vals, seeds = [], [], [], [], []
    run_val, run = apis_train._run_val, InferenceSession.run

    def validate(*args):
        start = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ap = run_val(*args)
        torch.cuda.synchronize()
        vals.append(dict(s=time.perf_counter() - t0, ap=ap,
                         launches={k: v - start[k] for k, v in read_counts().items()}))
        return ap

    def seeded_run(self, images, cam, shapes, seed=0, **kw):
        seeds.append(seed)
        return run(self, images, cam, shapes, seed=seed, **kw)

    def step(*args, **kw):
        start, t0 = read_counts(), time.perf_counter()
        out = train_step(*args, **kw)
        torch.cuda.synchronize()
        steps.append(dict(start=t0, end=time.perf_counter(),
                          launches={k: v - start[k] for k, v in read_counts().items()}))
        return out

    class TimedLoader(PrefetchLoader):
        """Keeps the ms the loop waits for each batch."""

        def __iter__(self):
            it = super().__iter__()
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                waits.append((time.perf_counter() - t0) * 1e3)
                yield batch

    work = DP_DIR / "loop_work"
    val_ds = KITTI3DDataset(str(root), "loop_val.txt")
    with align_env({}), patched(apis_train, "train_step", step), timed_all_reduce(reduces), \
            patched(apis_train, "PrefetchLoader", TimedLoader), \
            patched(apis_train, "_run_val", validate), \
            patched(InferenceSession, "run", seeded_run):
        apis_train.train_detector(cfg, str(work), val_ds=val_ds, device=dev)
    parallel.barrier()
    if parallel.rank() == 0:
        shutil.rmtree(work, ignore_errors=True)
    per_epoch = len(steps) // DP_LOOP_EPOCHS
    gaps = [(b["end"] - a["end"]) * 1e3 for e in range(DP_LOOP_EPOCHS)
            for a, b in zip(steps[e * per_epoch:(e + 1) * per_epoch - 1],
                            steps[e * per_epoch + 1:(e + 1) * per_epoch])]
    grad_reduces = [r for r in reduces if r["elements"] > 1000]
    return dict(steps=len(steps), gaps_ms=gaps, launches=[s["launches"] for s in steps],
                step_ms=[(s["end"] - s["start"]) * 1e3 for s in steps], loader_wait_ms=waits,
                grad_all_reduce_ms=[r["ms"] for r in grad_reduces],
                grad_all_reduce_elements=grad_reduces[0]["elements"],
                metric_all_reduce_ms=[r["ms"] for r in reduces if r["elements"] <= 1000],
                vals=vals, val_seeds=seeds)


def dp_nccl(port, loop_root, eval_root):
    """One rank under NCCL at world size 1: ``tools.train kitti_multiclass
    --distributed`` (bf16, batch 3, 2 steps, a checkpoint and a validation)
    on phase 15's mini-KITTI, the NCCL collectives the layer uses on the
    card, and ``tools.test --distributed`` (batch 4) on phase 12's, whose
    results go to ``DP_DIR/nccl_eval.pt``. Writes ``DP_DIR/nccl.json``, with
    the warm-ups' launches (``warm_apart``)."""
    warm_apart()
    rc.build_all()
    work = DP_DIR / "nccl_work"
    out = {}
    dp_rank_env(0, 1, port)
    train_argv = ["kitti_multiclass", "--distributed", "--work-dir", str(work),
                  "--max-steps", "2", "--cfg-options", f"data.train_root='{loop_root}'",
                  "data.train_list='loop_train.txt'", "data.val_list='loop_val.txt'",
                  "train.checkpoint_interval=1", "train.eval_interval=1",
                  "train.log_interval=1", "train.tensorboard=False"]
    with align_env({}):
        reset_counts()
        t0 = time.perf_counter()
        tools_train.main(train_argv)
        out["train_s"] = time.perf_counter() - t0
        out["train_launches"] = read_counts()
    log = [json.loads(ln) for ln in (work / "train_log.jsonl").read_text().splitlines()]
    out["train_log_steps"] = [r["step"] for r in log]
    out["train_log_finite"] = all(math.isfinite(v) for r in log for v in r.values())
    out["train_checkpoints"] = sorted(p.name for p in work.iterdir() if p.name.startswith("step_"))
    shutil.rmtree(work, ignore_errors=True)

    dp_rank_env(0, 1, free_port())
    with parallel.process_group() as dev:
        x = torch.arange(4.0, device=dev)
        got = parallel.all_reduce_sum([x])[0]
        torch.distributed.all_reduce(x)
        gathered = [None]
        torch.distributed.all_gather_object(gathered, {"rank": parallel.rank()})
        parallel.barrier()
        torch.cuda.synchronize()
        out["nccl"] = dict(backend=torch.distributed.get_backend(), device=str(dev),
                           all_reduce=x.tolist(), all_reduce_sum=got.tolist(),
                           all_gather_object=gathered)

    dp_rank_env(0, 1, free_port())
    datasets = []
    argv = ["kitti_multiclass", "--val-set", "--distributed", "--batch-size", str(EVAL_BATCH),
            "--cfg-options", f"data.train_root='{eval_root}'", "data.val_list='train_list.txt'"]
    with align_env({}), patched(tools_test, "KITTI3DDataset",
                                keeping(RecordingDataset, datasets)):
        reset_counts()
        t0 = time.perf_counter()
        out["eval_ap"] = tools_test.main(argv)
        out["eval_s"] = time.perf_counter() - t0
        out["eval_launches"] = read_counts()
    torch.save(datasets[0].results, DP_DIR / "nccl_eval.pt")
    out["warm_launches"] = WARM_LAUNCHES
    (DP_DIR / "nccl.json").write_text(json.dumps(out))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(target, args_of_rank, what):
    """Starts one spawned process per argument tuple and waits for all; one
    that fails (or outlives ``DP_TIMEOUT_S``) stops the others and fails the
    run."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args) for args in args_of_rank]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(60)
    codes = [p.exitcode for p in procs]
    check(codes == [0] * len(procs), f"{what}: the spawned processes exited with {codes}")


def phase_dp(card, eval_results, loop_stats):
    """Phase 16 (the module docstring): two ranks on the one card over Gloo
    against one process, then one NCCL rank through both CLIs."""
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    t_phase = time.perf_counter()
    # (i) the one-process step on the global batch of 6, on the card
    cfg = dp_config()
    model, state, opt = dp_model(cfg, "cuda")
    dev = next(model.parameters()).device
    H, W = cfg.data.pad_height, cfg.data.pad_width
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_train_batch(cfg, DP_BATCH, (H, W), seed=0).items()}
    draws = dp_draws(cfg, batch, seed=4)
    ref_grads = {}
    keep_step_grads(opt, ref_grads)
    with align_env({}):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(model, opt, state, batch, draws)
        torch.cuda.synchronize()
        ref_ms = (time.perf_counter() - t0) * 1e3
    ref = {k: float(v) for k, v in m.items()}
    del model, opt, state, batch, draws
    torch.cuda.empty_cache()

    # the loop's and the eval's mini-KITTIs, as phases 15 and 12 wrote them
    loop_root, eval_root = DP_DIR / "loop_kitti", DP_DIR / "eval_kitti"
    write_mini_kitti(loop_root, LOOP_TRAIN + LOOP_VAL, seed=31)
    ids = (loop_root / "train_list.txt").read_text().split()
    (loop_root / "loop_train.txt").write_text("\n".join(ids[:LOOP_TRAIN]) + "\n")
    (loop_root / "loop_val.txt").write_text("\n".join(ids[LOOP_TRAIN:]) + "\n")
    write_mini_kitti(eval_root, EVAL_IMAGES, seed=21)

    t0 = time.perf_counter()
    port = free_port()
    spawn_ranks(dp_rank, [(r, port, loop_root) for r in range(DP_WORLD)], "two ranks")
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((DP_DIR / f"rank{r}.json").read_text()) for r in range(DP_WORLD)]
    grads = torch.load(DP_DIR / "grads.pt")
    per_step = STEP_LAUNCHES
    for r in ranks:
        check(r["world"] == DP_WORLD, f"rank {r['rank']} saw world size {r['world']}")
        check_launches(r["launches"], per_step, 1, f"data-parallel step, rank {r['rank']}")
        check_train_metrics(r["metrics"], f"data-parallel step, rank {r['rank']}")
        check(r["params_equal_on_every_rank"], "the ranks' parameters differ after the step")
        check(r["metrics"] == ranks[0]["metrics"], "the ranks logged different metrics")
    loss_err = {}
    for k in TRAIN_LOSSES:
        a, b = ranks[0]["metrics"][k], ref[k]
        rtol = 1e-3 if k in AFTER_PNP else 1e-4
        loss_err[k] = abs(a - b) / max(abs(b), 1e-6)
        check(abs(a - b) <= rtol * max(abs(b), 1e-5),
              f"data-parallel step: {k} {a} against one process's {b}")
    check(sorted(grads) == sorted(ref_grads), "the ranks' gradients are of other parameters")
    grad_rel = {}
    for n, want in ref_grads.items():
        scale = float(want.abs().max())
        d = (grads[n].double() - want.double()).abs()
        grad_rel[n] = float(d.max()) / max(scale, 1e-30)
        check(bool((d <= 1e-3 * scale).all()), f"data-parallel step: the gradient of {n} is "
                                               f"{grad_rel[n]} of its scale off")
    worst = max(grad_rel, key=grad_rel.get)
    print("dp_step " + json.dumps(dict(
        config="kitti_multiclass float32", card=card, world=DP_WORLD, backend="gloo",
        global_batch=DP_BATCH, rows_per_rank=DP_BATCH // DP_WORLD,
        loss_rel_err=loss_err, grad_max_err_of_scale=grad_rel[worst], worst_leaf=worst,
        one_process_step_ms=ref_ms, rank_first_step_ms=[r["first_step_ms"] for r in ranks],
        launches_per_rank=[r["launches"] for r in ranks],
        align_err_per_rank=[r["align_err"] for r in ranks],
        params_bit_equal=all(r["params_equal_on_every_rank"] for r in ranks),
        ranks_s=ranks_s)), flush=True)

    # (iii) the loop at world 2 beside phase 15's world-1 loop
    loops = [r["loop"] for r in ranks]
    for r, lp in zip(ranks, loops):
        check(lp["steps"] == 2 * DP_LOOP_EPOCHS, f"dp loop rank {r['rank']}: {lp['steps']} "
                                                 f"steps")
        for i, c in enumerate(lp["launches"]):
            check_launches(c, per_step, 1, f"dp loop rank {r['rank']} step {i + 1}")
    n_val = -(-LOOP_VAL // VAL_BATCH)
    for r, lp in zip(ranks, loops):
        check(len(lp["vals"]) == 1, f"dp loop rank {r['rank']}: {len(lp['vals'])} validations")
        check_launches(lp["vals"][0]["launches"], {"roi_align": 3}, n_val // DP_WORLD,
                       f"dp loop rank {r['rank']} validation")
        check(lp["vals"][0]["ap"] == loops[0]["vals"][0]["ap"] and lp["vals"][0]["ap"],
              f"dp loop: rank {r['rank']}'s validation AP differs from rank 0's")
    # each rank detects its batches of a one-process validation, seeded alike
    check(sorted(sd for lp in loops for sd in lp["val_seeds"])
          == list(range(0, LOOP_VAL, VAL_BATCH)) and all(lp["val_seeds"] for lp in loops),
          f"dp loop: the validation's batch seeds {[lp['val_seeds'] for lp in loops]}")
    ms = [statistics.median(lp["gaps_ms"]) for lp in loops]
    reduce_ms = [statistics.median(lp["grad_all_reduce_ms"]) for lp in loops]
    print("dp_loop " + json.dumps(dict(
        config="kitti_multiclass", card=card, world=DP_WORLD, backend="gloo",
        shared_card=True, global_batch=DP_BATCH, ms_per_step_per_rank=ms,
        global_train_img_per_s=DP_BATCH * 1e3 / max(ms), gaps_ms=[lp["gaps_ms"] for lp in loops],
        grad_all_reduce_ms_per_rank=reduce_ms,
        grad_all_reduce_ms_each=[lp["grad_all_reduce_ms"] for lp in loops],
        step_ms_each=[lp["step_ms"] for lp in loops],
        loader_wait_ms_each=[lp["loader_wait_ms"] for lp in loops],
        grad_all_reduce_share_of_step=[a / b for a, b in zip(reduce_ms, ms)],
        grad_all_reduce_elements=loops[0]["grad_all_reduce_elements"],
        metric_all_reduce_ms=statistics.median(loops[0]["metric_all_reduce_ms"]),
        world1_ms_per_step=loop_stats["ms_per_step"],
        world1_train_img_per_s=loop_stats["train_img_per_s"],
        val_s_per_rank=[lp["vals"][0]["s"] for lp in loops],
        val_seeds_per_rank=[lp["val_seeds"] for lp in loops],
        val_images=LOOP_VAL, val_ap_keys=len(loops[0]["vals"][0]["ap"]))), flush=True)

    # (ii) one NCCL rank: tools.train and tools.test --distributed
    t0 = time.perf_counter()
    spawn_ranks(dp_nccl, [(free_port(), loop_root, eval_root)], "the NCCL rank")
    nccl_s = time.perf_counter() - t0
    nc = json.loads((DP_DIR / "nccl.json").read_text())
    for name, n in nc["warm_launches"].items():
        WARM_LAUNCHES[name] += n
    n_val = -(-LOOP_VAL // VAL_BATCH)
    check_launches(nc["train_launches"], {"roi_align": 3 * (2 + n_val),
                                          "roi_align_backward":
                                              STEP_LAUNCHES["roi_align_backward"] * 2}, 1,
                   "tools.train --distributed (NCCL, 2 steps and a validation)")
    check(nc["train_log_steps"] == [1, 2] and nc["train_log_finite"],
          f"tools.train --distributed: the log's steps {nc['train_log_steps']}")
    check(nc["train_checkpoints"] == ["step_2"],
          f"tools.train --distributed: checkpoints {nc['train_checkpoints']}")
    check(nc["nccl"]["backend"] == "nccl" and nc["nccl"]["all_reduce"] == [0.0, 1.0, 2.0, 3.0]
          and nc["nccl"]["all_reduce_sum"] == [0.0, 1.0, 2.0, 3.0]
          and nc["nccl"]["all_gather_object"] == [{"rank": 0}],
          f"the NCCL collectives at world size 1: {nc['nccl']}")
    check_launches(nc["eval_launches"], {"roi_align": 3}, -(-EVAL_IMAGES // EVAL_BATCH),
                   "tools.test --distributed (NCCL)")
    got = torch.load(DP_DIR / "nccl_eval.pt", weights_only=False)
    check(len(got) == len(eval_results) == EVAL_IMAGES, "tools.test --distributed: "
                                                        f"{len(got)} results")
    errs = {}
    for i, (g, want) in enumerate(zip(got, eval_results)):
        check((g["valid"] == want["valid"]).all() and (g["labels"] == want["labels"]).all(),
              f"tools.test --distributed: image {i}'s validity or labels differ from phase 12")
        for name, rtol in (("bboxes_2d", 1e-4), ("bboxes_3d", 1e-3), ("pose_cov", 1e-3)):
            a, b = torch.from_numpy(g[name]).double(), torch.from_numpy(want[name]).double()
            scale = float(b.abs().max().clamp(min=1e-6))
            errs[name] = max(errs.get(name, 0.0), float((a - b).abs().max()) / scale)
            check(bool(((a - b).abs() <= rtol * b.abs() + rtol * scale).all()),
                  f"tools.test --distributed: image {i}'s {name} differs from phase 12 "
                  f"({errs[name]} of scale)")
    print("dp_nccl " + json.dumps(dict(
        card=card, world=1, backend=nc["nccl"]["backend"], train_s=nc["train_s"],
        eval_s=nc["eval_s"], rel_err_of_scale_vs_phase_12=errs,
        valid=sum(int(r["valid"].sum()) for r in got), nccl_s=nccl_s,
        phase_s=time.perf_counter() - t_phase)), flush=True)
    shutil.rmtree(DP_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(
        train_dp={k: sum(r["launches"][k] for r in ranks) for k in per_step},
        train_dp_loop={k: sum(c[k] for lp in loops for c in lp["launches"]) for k in per_step},
        train_nccl=nc["train_launches"], eval_nccl=nc["eval_launches"],
        recs=[rec for r in ranks for rec in r["backward_recs"]],
        align_err=max(r["align_err"] for r in ranks))


# ---- the fast serving presets ------------------------------------------------

FAST_RUNGS = ("kitti_multiclass_fast", "kitti_multiclass_fast_r50", "kitti_multiclass_fast2",
              "kitti_multiclass_fast2_r50", "kitti_multiclass_fast3_r50")


def phase_fast(card, flush, base_ms):
    """Phase 17 (the module docstring): every fast rung served at batch 8,
    its launches per forward, its aligns against the plain version, beside
    phase 4's kitti_multiclass; then the tiny GPU-against-CPU check at the
    no-CARAFE cut. Returns (the align records, each rung's counts)."""
    recs, counts_of = [], {}
    for name in FAST_RUNGS:
        cfg = get_config(name)
        t0 = time.perf_counter()
        sess = init_inference(name, batch_size=BATCH, device="cuda", seed=0, raw=True)
        build_s = time.perf_counter() - t0
        gen = torch.Generator(device=sess.device).manual_seed(1)
        requests = [kitti_inputs(cfg, BATCH, gen, sess.device) for _ in range(REQUESTS + 2)]
        torch.cuda.reset_peak_memory_stats()
        with align_env({}):
            reset_counts()
            times, dets, recorded = serve_requests(sess, requests, record=True)
            counts = read_counts()
        check_launches(counts, {"roi_align": 3}, len(requests), f"serve {name}")
        for det in dets:
            check_detections(det, cfg, BATCH)
        ms = statistics.median(times[2:])
        rung_recs = check_recorded_aligns(f"fast {name}", recorded, cfg, flush)[0]
        print("fast " + json.dumps(dict(
            config=name, card=card, batch=BATCH, requests=REQUESTS, ms_per_batch=ms,
            frames_per_s=BATCH * 1e3 / ms, launches_per_forward={
                k: v / len(requests) for k, v in counts.items() if v},
            kitti_multiclass_ms_per_batch=base_ms,
            kitti_multiclass_frames_per_s=BATCH * 1e3 / base_ms,
            align_rois=[int(r[1].shape[0]) for r in recorded],
            align_max_abs_err=max(r["max_abs_err"] for r in rung_recs),
            backbone_depth=cfg.backbone.depth, test_scale=cfg.data.test_scale,
            pad=[cfg.data.pad_height, cfg.data.pad_width],
            dense_size=cfg.noc_head.dense_size, ms_each=times,
            valid_detections=[int(d.valid.sum()) for d in dets],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, build_s=build_s)),
            flush=True)
        recs += rung_recs
        counts_of[name] = counts
        del sess, requests, dets, recorded
        torch.cuda.empty_cache()
    with align_env({}):
        phase_tiny(tiny_no_carafe_config(), "tiny no-CARAFE")
    return recs, counts_of


# ---- the training closure: train, serve, KITTI AP --------------------------------


def phase_closure(card, flush):
    """Phase 18 (the module docstring): ``tests/torch_e2e_closure.py`` on the
    card in float32 with every one of JAX's bars, then the base closure in
    bfloat16 as a reading. Returns (the backward records, the forwards'
    largest error, each run's counts)."""
    forwards = [0]
    run = InferenceSession.run

    def counted_run(self, *args, **kw):
        forwards[0] += 1
        return run(self, *args, **kw)

    results, counts_of, recs, fwd_err = {}, {}, [], 0.0
    for dtype in ("float32", "bfloat16"):
        recorded, forwards[0] = [], 0
        t0 = time.perf_counter()
        with align_env({}), patched(InferenceSession, "run", counted_run):
            reset_counts()
            out = closure.run_closure(
                "cuda", dtype, guards=dtype == "float32",
                record=lambda: recording_aligns(recorded, grad=True))
            counts = read_counts()
        out["phase_s"] = time.perf_counter() - t0
        steps = out["base"]["steps"] + out.get("fast2", {}).get("steps", 0)
        # 3 forward and 9 backward launches a step, 3 a served batch
        want = dict({name: 0 for name in counts},
                    roi_align=STEP_LAUNCHES["roi_align"] * steps + 3 * forwards[0],
                    roi_align_backward=STEP_LAUNCHES["roi_align_backward"] * steps)
        print(f"launches closure {dtype}: {json.dumps(counts)} over {steps} steps and "
              f"{forwards[0]} served batches", flush=True)
        check(counts == want, f"closure {dtype}: launches {counts}, expected {want}")
        results[dtype], counts_of[dtype] = out, counts
        # the first training step's aligns, forward and backward
        r, err = check_train_aligns(f"closure {dtype}", recorded, closure.nano_config(dtype),
                                    flush)
        recs += r
        fwd_err = max(fwd_err, err)
        del recorded
        print(f"closure {dtype} " + json.dumps(
            {k: v for k, v in out.items() if k != "summary"}, default=float), flush=True)
        for what, ok in closure.bars(out).items():
            print(f"closure {dtype} bar {what}: {'met' if ok else 'MISSED'}", flush=True)
            check(ok, f"closure {dtype}: {what} missed")
        torch.cuda.empty_cache()
    f32, bf16 = results["float32"], results["bfloat16"]
    print("closure " + json.dumps(dict(
        card=card, float32_ap=f32["base"]["ap"], bfloat16_ap=bf16["base"]["ap"],
        float32_steps=f32["base"]["steps"], bfloat16_steps=bf16["base"]["steps"],
        fast2_ap=f32["fast2"]["ap"], fast2_steps=f32["fast2"]["steps"],
        train_s=dict(float32=f32["base"]["train_s"], fast2=f32["fast2"]["train_s"],
                     bfloat16=bf16["base"]["train_s"]),
        phase_s=f32["phase_s"] + bf16["phase_s"])), flush=True)
    print(f32["summary"], flush=True)
    return recs, fwd_err, counts_of


# ---- the parity runbook on the card: tools.parity at full width ----------------------

PARITY_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_parity"
PARITY_IMAGES, PARITY_BATCH = 8, 4
ACTIVATION_TOL = 1e-3         # of each stage's std, against the CPU replica
PARITY_REG_SCALE = 1e-2       # the random .pth's box regressors, scaled
PARITY_OFF = "[parity] deviations OFF: lazy_lower=False head_slots=0 dtype=float32"


class Tee(io.TextIOBase):
    """Writes to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.copy = out, io.StringIO()

    def write(self, text):
        self.copy.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def run_parity(argv, recorded):
    """``python -m monorun_tpu_torch.tools.parity`` in-process under
    ``recording_aligns``: (its result, its session, the launches, seconds,
    ``run_eval``'s ms, what it printed)."""
    sessions, eval_ms = [], []
    tee = Tee(sys.stdout)
    with contextlib.ExitStack() as stack:
        stack.enter_context(align_env({}))
        stack.enter_context(recording_aligns(recorded))
        stack.enter_context(timed(parity_tool, "run_eval", eval_ms, sync=True))
        stack.enter_context(patched(parity_tool, "init_inference",
                                    keeping(init_inference, sessions)))
        stack.enter_context(contextlib.redirect_stdout(tee))
        reset_counts()
        t0 = time.perf_counter()
        out = parity_tool.main(argv)
        seconds = time.perf_counter() - t0
        counts = read_counts()
    return out, sessions[0], counts, seconds, eval_ms[0], tee.copy.getvalue()


def check_ap(ap, summary, what):
    _, want = kitti_eval([], [], get_config("kitti_multiclass").data.classes)
    check(list(ap) == list(want), f"{what}: the AP keys {sorted(ap)} are not the evaluator's")
    check(all(math.isfinite(v) for v in ap.values()), f"{what}: an AP value is not finite")
    check(json.loads(summary.read_text()) == ap, f"{what}: the summary file is not the AP dict")


def phase_parity(card, flush):
    """Phase 19 (the module docstring): ``tools.parity --activations`` on a
    mini-KITTI with a ``.pth`` of seeded random kitti_multiclass weights,
    then again on labels made from its own result files."""
    shutil.rmtree(PARITY_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    training = PARITY_DIR / "kitti" / "training"
    write_mini_kitti(training, PARITY_IMAGES, seed=41)
    shutil.copy(training / "train_list.txt", training / "mono3dsplit_val_list.txt")
    pth = PARITY_DIR / "random_kitti_multiclass.pth"
    model = init_random_weights(MonoRUn(get_config("kitti_multiclass")),
                                torch.Generator().manual_seed(3))
    # random box regressors flatten the boxes below KITTI's 25-pixel least
    # height, where every label made from them is ignored: scaled down, the
    # boxes stay near their anchors
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith(("rpn_head.rpn_reg.", "roi_head.bbox_head.fc_reg.")):
                p.mul_(PARITY_REG_SCALE)
    torch.save({"state_dict": model.state_dict()}, pth)     # the reference key names
    del model
    results, summary = PARITY_DIR / "results", PARITY_DIR / "ap.json"
    recorded = []
    out, sess, counts, seconds, eval_ms, printed = run_parity(
        [str(training.parent), str(pth), "--activations", "--batch-size", str(PARITY_BATCH),
         "--result-dir", str(results), "--summary-file", str(summary)], recorded)
    cfg = sess.cfg
    check(PARITY_OFF in printed, "tools.parity did not print its deviations-OFF line")
    check(cfg.compute_dtype == "float32" and cfg.neck.lazy_lower is False
          and cfg.test.head_slots == 0, "tools.parity served another mode than float32, "
          "the dense stride-2 level and every head slot")
    check(all(p.dtype == torch.float32 for p in sess.model.parameters()),
          "tools.parity's weights are not float32")
    check(not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32),
          "TF32 is on in the parity run")
    batches = -(-PARITY_IMAGES // PARITY_BATCH)
    check_launches(counts, {"roi_align": 3}, batches, "parity (tools.parity --activations)")
    rows = out["activations"]
    check(len(rows) == 20 and rows[4][0] == "fpn P1 (stride 2)",
          f"the activation diff has the stages {[r[0] for r in rows]}")
    worst = max(rows, key=lambda r: r[2])
    check(all(math.isfinite(r[2]) and r[2] <= ACTIVATION_TOL for r in rows),
          f"parity: the stage {worst[0]} is {worst[2]} of its std from the CPU replica")
    # the first batch's aligns: 4 x 1000 proposals on the dense stride-2 level
    # 0, then 4 x max_per_img detections at 7x7 and 14x14
    level0 = tuple(recorded[0][0][0].shape[1:3])
    M = cfg.test.max_per_img
    check(level0 == (cfg.data.pad_height // 2, cfg.data.pad_width // 2),
          f"parity: the aligns' level 0 is {level0}, not the dense stride-2 map")
    check([int(r[1].shape[0]) for r in recorded]
          == [PARITY_BATCH * cfg.test.rpn_nms_post, PARITY_BATCH * M, PARITY_BATCH * M],
          f"parity: the aligns had {[int(r[1].shape[0]) for r in recorded]} RoIs")
    recs, _ = check_recorded_aligns("parity", recorded, cfg, flush)
    del recorded
    ap = out["ap"]
    check_ap(ap, summary, "parity")
    files = sorted(p.name for p in results.iterdir())
    check(len(files) == PARITY_IMAGES, f"tools.parity wrote {len(files)} result files")

    labelled = PARITY_DIR / "self" / "training"
    shutil.copytree(training, labelled)
    for name in files:
        shutil.copy(results / name, labelled / "label_2" / name)
    summary2 = PARITY_DIR / "ap_self.json"
    out2, _, counts2, seconds2, eval_ms2, _ = run_parity(
        [str(labelled.parent), str(pth), "--batch-size", str(PARITY_BATCH),
         "--result-dir", str(PARITY_DIR / "results_self"), "--summary-file", str(summary2)],
        [])
    check_launches(counts2, {"roi_align": 3}, batches, "parity on its own labels")
    check_ap(out2["ap"], summary2, "parity on its own labels")
    print("parity " + json.dumps(dict(
        config="kitti_multiclass parity (float32, dense stride-2 level, head_slots 0)",
        card=card, images=PARITY_IMAGES, batch=PARITY_BATCH, tool_s=[seconds, seconds2],
        run_eval_ms=[eval_ms, eval_ms2], img_per_s=PARITY_IMAGES * 1e3 / eval_ms,
        stage_deviation_of_std={r[0]: r[2] for r in rows},
        stage_max_abs={r[0]: r[1] for r in rows}, worst_stage=worst[0],
        level0=list(level0), rois=[int(r["rois"]) for r in recs],
        result_lines=[len((results / f).read_text().splitlines()) for f in files],
        ap_max=max(ap.values()), ap_max_self_labels=max(out2["ap"].values()),
        ap_nonzero_self_labels=sum(v > 0 for v in out2["ap"].values()),
        phase_s=time.perf_counter() - t_phase)), flush=True)
    check(max(out2["ap"].values()) > 0.0, "parity on labels made from its own results: "
          "every AP is 0; its first result file begins "
          + repr((results / files[0]).read_text()[:400]))
    shutil.rmtree(PARITY_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(parity=counts, parity_self_labels=counts2), recs


# ---- the profiling tools at full width -----------------------------------------------

# ResNet-101's 7.8 G multiply-adds at 224x224, scaled to the 384x1280 pad
BACKBONE_GFLOP = 2 * 7.8 * 384 * 1280 / 224 ** 2
ALIGN_STAGES = ("align_proposals", "global_head_mc", "noc_head")


def run_tool(main, argv, what):
    """A tool's ``main`` in-process, its launches counted from 0."""
    with align_env({}):
        reset_counts()
        t0 = time.perf_counter()
        out = main(argv)
        seconds = time.perf_counter() - t0
        counts = read_counts()
    print(f"{what} took {seconds:.1f} s", flush=True)
    return out, counts, seconds


def phase_profile_tools(card, table):
    """Phase 20 (the module docstring): ``tools.profile_stages`` at batch 8,
    ``tools.flop_budget`` at batch 1 and ``tools.profile_trace`` at batch 8
    (its whole table to ``table`` when given)."""
    ladder, ladder_counts, ladder_s = run_tool(profile_stages.main, [str(BATCH)],
                                               "profile_stages")
    check_launches(ladder_counts, {"roi_align": 3},
                   ladder["warmup"] + 2 * ladder["forwards"], "profile_stages")
    for s in ladder["stages"]:
        want = {"roi_align": 1} if s["stage"] in ALIGN_STAGES else {}
        check(s["launches"] == want, f"profile_stages: the stage {s['stage']} launched "
                                     f"{s['launches']}, expected {want}")
    split = ladder["paired_split"]
    check(abs(split - 1.0) <= 0.15, f"profile_stages: a forward's stages sum to {split} of "
                                    "its unsplit partner (median of the pairs)")

    rows, flop_counts, flop_s = run_tool(flop_budget.main, ["1"], "flop_budget")
    check_launches(flop_counts, {"roi_align": 3}, 1, "flop_budget")
    backbone = rows[0][1] / 1e9
    check(abs(backbone - BACKBONE_GFLOP) <= 0.1 * BACKBONE_GFLOP,
          f"flop_budget: the backbone counts {backbone} GFLOP, expected about "
          f"{BACKBONE_GFLOP}")

    trace, trace_counts, trace_s = run_tool(
        profile_trace.main, [str(BATCH), "40"] + (["--profile", str(table)] if table else []),
        "profile_trace")
    check_launches(trace_counts, {"roi_align": 3}, 1 + 5 + profile_trace.FORWARDS,
                   "profile_trace")
    check(trace["covered_share"] >= 0.9, f"profile_trace: the stages hold "
                                         f"{trace['covered_share']} of the device time")
    print("profile_tools " + json.dumps(dict(
        config="kitti_multiclass", card=card, batch=BATCH,
        ladder={s["stage"]: s["ms"] for s in ladder["stages"]},
        ladder_unsplit_ms=ladder["unsplit_ms"], ladder_stage_sum_ms=ladder["stage_sum_ms"],
        ladder_paired_split=split, gflop_per_image={name: cum / 1e9 for name, cum, _ in rows},
        backbone_gflop_expected=BACKBONE_GFLOP,
        trace_ms_per_forward=trace["ms_per_forward"],
        trace_launches_per_forward=trace["launches_per_forward"],
        trace_stages={s["stage"]: [s["ms"], s["launches"]] for s in trace["stages"]},
        trace_covered_share=trace["covered_share"], trace_unprofiled_ms=trace["unprofiled_ms"],
        trace_idle_share=trace["idle_share"], seconds=[ladder_s, flop_s, trace_s])),
        flush=True)
    torch.cuda.empty_cache()
    return dict(profile_stages=ladder_counts, flop_budget=flop_counts,
                profile_trace=trace_counts)


# ---- the cold start: tools.cold_profile in fresh processes ---------------------

COLD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cold"
COLD_TIMEOUT_S = 240          # one run of the tool
# (run, its builds' root under COLD_DIR, its extra arguments)
COLD_RUNS = (("cold", "cache", []), ("cached", "cache", []), ("warm", "cache", ["--warm"]),
             ("fresh_warm", "cache_fresh_warm", ["--warm"]))
WARMED = ("warm", "fresh_warm")


def launched_libraries(launches):
    """The sources (``csrc/<stem>.cu``) of the kernels with launches in
    ``launches``, sorted."""
    libs = {"roi_align": "roi_align", "roi_align_backward": "roi_align_bwd"}
    return sorted({libs.get(name) or rc.KERNELS[name].lib
                   for name, n in launches.items() if n})


def cold_run(what, argv):
    """``python -m monorun_tpu_torch.tools.cold_profile`` in a fresh
    process with the align settings unset; its lines are printed, and the
    figures of its ``cold_profile`` line returned."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MONORUN_ALIGN", "MONORUN_BAND", "MONORUN_TORCH_CACHE"))}
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", "monorun_tpu_torch.tools.cold_profile",
                               *argv], cwd=Path(__file__).resolve().parent, env=env,
                              capture_output=True, text=True, timeout=COLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"cold_profile {what} outlived {COLD_TIMEOUT_S} s") from None
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("cold_profile "):
            print(f"cold_start {what} {line}", flush=True)
    check(proc.returncode == 0, f"cold_profile {what} exited with {proc.returncode}:\n"
                                f"{proc.stderr[-3000:]}")
    out = json.loads([ln for ln in lines if ln.startswith("cold_profile ")][-1][13:])
    out["process_s"] = seconds
    return out


def phase_cold_start(card, build_all_s):
    """Phase 21 (the module docstring): the cold, cached and warm runs of
    ``tools.cold_profile`` on one fresh builds' root, and a warm run on a
    second. Returns the direct kernel's launches in their requests."""
    shutil.rmtree(COLD_DIR, ignore_errors=True)
    COLD_DIR.mkdir(parents=True)
    t_phase = time.perf_counter()
    serving = list(serving_stems(get_config("kitti_multiclass"), BATCH))
    runs = {}
    for what, root, extra in COLD_RUNS:
        runs[what] = cold_run(what, [str(BATCH), "--cache-dir", str(COLD_DIR / root),
                                     "--save", str(COLD_DIR / f"{what}.pt"), *extra])
    cold, cached, fresh_warm = runs["cold"], runs["cached"], runs["fresh_warm"]
    launched = launched_libraries(cold["launches"])
    for what in ("cold", "fresh_warm"):
        check(sorted(runs[what]["nvcc_jobs"]) == launched,
              f"cold_profile {what}: nvcc built {runs[what]['nvcc_jobs']}, its requests "
              f"launched the kernels of {launched}")
    for what in ("cached", "warm"):
        check(runs[what]["nvcc_jobs"] == [], f"cold_profile {what}: nvcc built "
                                             f"{runs[what]['nvcc_jobs']} in a populated root")
    for what, out in runs.items():
        check_launches(out["launches"], {"roi_align": 3}, 2, f"cold_profile {what}")
    first = {"cold": torch.load(COLD_DIR / "cold.pt")}
    errs, bit_equal = {}, {}
    for what in WARMED:
        out = runs[what]
        check(out["first_request_nvcc_jobs"] == 0, f"cold_profile {what}: the first "
                                                   f"request built")
        check(out["warm_launches"] == {k: WARM_FORWARD.get(k, 0) for k in rc.KERNELS},
              f"cold_profile {what}: the warm-up launched {out['warm_launches']}")
        for name, n in out["warm_launches"].items():
            WARM_LAUNCHES[name] += n
        first[what] = torch.load(COLD_DIR / f"{what}.pt")
        errs[what] = compare_detections(first[what], first["cold"],
                                        f"cold_profile {what}: the warm session's first "
                                        f"request against the unwarmed one's")
        bit_equal[what] = all(torch.equal(first[what][k], first["cold"][k])
                              for k in first["cold"])

    def marks(out):
        return {m["mark"]: m["s"] for m in out["marks"]}

    shutil.rmtree(COLD_DIR, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print("cold_start " + json.dumps(dict(
        config="kitti_multiclass", card=card, batch=BATCH, serving_stems=serving,
        marks={what: marks(out) for what, out in runs.items()},
        totals={what: out["marks"][-1]["total_s"] for what, out in runs.items()},
        process_s={what: out["process_s"] for what, out in runs.items()},
        nvcc_jobs={what: out["nvcc_jobs"] for what, out in runs.items()},
        serving_build_s=marks(cold)["kernel build"], cached_load_s=marks(cached)["kernel build"],
        all_libraries_build_s=build_all_s,
        warm_start={what: runs[what]["warm_seconds"] for what in WARMED},
        warm_first_request_s={what: marks(runs[what])["first request"] for what in WARMED},
        fresh_warm_overlap_s=fresh_warm["warm_seconds"]["build"]
        - fresh_warm["warm_seconds"]["build_wait"],
        cold_first_exec_s=marks(cold)["first exec+fetch"],
        cached_first_exec_s=marks(cached)["first exec+fetch"],
        warm_vs_unwarmed_rel_err_of_scale=errs, warm_vs_unwarmed_bit_equal=bit_equal,
        phase_s=phase_s)), flush=True)
    return sum(out["launches"]["roi_align"] for out in runs.values())


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
        library_ms=None, calls=call_records(recs),
    )


def call_records(recs):
    """The kernels line's record of each compared call."""
    return [{k: r[k] for k in ("call", "variant", "dtype", "rois", "out", "ms", "call_ms",
                               "plain_ms", "empty_ms", "bound_ms", "bound_by", "bound_share",
                               "max_abs_err")
             if k in r} for r in recs]


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
                    help="write phase 20's whole profiler table (tools.profile_trace) to FILE")
    ap.add_argument("--ab", metavar="[NAME=]SOURCE", action="append", default=[],
                    help="also time SOURCE, another build of kernel NAME's C interface "
                         "(a name of the kernels line; default roi_align, the direct "
                         "kernel), in turns with this one: phases 3-4 for the direct "
                         "kernel, phase 6 for a staged one, phases 9-10 for "
                         "roi_align_backward (a source of its current interface) "
                         "(repeatable)")
    args = ap.parse_args()
    by_name = {name: k for k, name in KERNEL_NAMES.items()}
    ab_specs = []
    for spec in args.ab:
        name, _, src = spec.rpartition("=")
        name = name or "roi_align"
        if name not in by_name:
            ap.error(f"--ab {spec}: {name!r} is not a kernel of {sorted(by_name)}")
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
    warm_apart()
    try:
        rc.build_all()
        build_all_s = rc.build_all.seconds
        print(f"build {len(rc.build_all.libs)} libraries {build_all_s:.2f} s",
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
        print("build roi_align_backward atomics in the SASS " + json.dumps(reductions),
              flush=True)
        check(not reductions, f"the backward has atomics, so its sums' order can change "
                              f"from run to run: {reductions}")
        ab = [rc.RoIAlignKernel(source=src) for k, src in ab_specs if k is roi_align_kernel]
        ab_backward = [rc.RoIAlignBackwardKernel(source=src)
                       for k, src in ab_specs if k is rc.roi_align_backward_kernel]
        ab_staged = {}
        for k, src in ab_specs:
            if k not in (roi_align_kernel, rc.roi_align_backward_kernel):
                ab_staged.setdefault(k, []).append(k.with_source(src))
        for other in ab + ab_backward + [o for v in ab_staged.values() for o in v]:
            other.build()
            for line in other.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"build ab {other.source.name} {line.strip()}", flush=True)

        cfg = get_config("kitti_multiclass")
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
        with align_env({}):
            synthetic = phase_kernel(cfg, flush, dev, ab)
        forward, default_counts, sess, requests, calls, serve_ms = phase_serve(
            cfg, flush, dev, card, ab)
        with align_env({}):
            phase_tiny()
        staged = phase_staged(calls, flush, ab_staged)
        del calls
        paths = phase_serve_variants(sess, requests, cfg, card)
        micro = phase_micro()
        del sess, requests
        torch.cuda.empty_cache()
        with align_env({}):
            backward = phase_backward(cfg, flush, dev, ab_backward)
        train_recs, train_counts, train_stats = phase_train(flush, dev, card, ab_backward)
        with align_env({}):
            phase_tiny_train()
        torch.cuda.empty_cache()
        shutil.rmtree(EVAL_DIR, ignore_errors=True)
        eval_counts, eval_root, eval_recs, eval_results = phase_eval(card, flush)
        with align_env({}):
            phase_eval_tiny(eval_root)
        demo_counts, demo_recs = phase_demo(eval_root, flush)
        shutil.rmtree(EVAL_DIR, ignore_errors=True)
        loop_counts, loop_recs, loop_fwd_err, loop_val_recs, loop_stats = phase_train_loop(
            card, flush, train_stats["ms_per_step"])
        dp = phase_dp(card, eval_results, loop_stats)
        fast_recs, fast_counts = phase_fast(card, flush, serve_ms)
        closure_recs, closure_fwd_err, closure_counts = phase_closure(card, flush)
        parity_counts, parity_recs = phase_parity(card, flush)
        tool_counts = phase_profile_tools(card, args.profile)
        cold_counts = phase_cold_start(card, build_all_s)
    except SmokeFailure as e:
        print(f"FAIL {e}", file=sys.stderr)
        return 1

    direct = kernel_record("roi_align", default_counts["roi_align"], forward)
    direct["max_abs_err"] = max([r["max_abs_err"]
                                 for r in synthetic + forward + eval_recs + demo_recs
                                 + loop_val_recs + fast_recs + parity_recs]
                                + [loop_fwd_err, dp["align_err"], closure_fwd_err])
    direct["calls"] += call_records(eval_recs + demo_recs + loop_val_recs + fast_recs
                                    + parity_recs)
    launches = {"roi_align_tile": micro["roi_align_tile"],
                "roi_align_band_tiered": paths["band tiered"]["roi_align_band_tiered"],
                "roi_align_band_packed": micro["roi_align_band_packed"],
                "roi_align_band_matmul": paths["bandmm"]["roi_align_band_matmul"]}
    kernels = [direct, kernel_record("roi_align_backward", train_counts["roi_align_backward"],
                                     train_recs)] + [
        kernel_record(name, n, [r for r in staged if r["kernel"] == name
                                and r["variant"] != "matmul t1 bf16"])
        for name, n in launches.items()]
    kernels[1]["max_abs_err"] = max(r["max_abs_err"]
                                    for r in backward + train_recs + loop_recs + dp["recs"]
                                    + closure_recs)
    kernels[1]["calls"] += call_records(loop_recs + closure_recs)
    for rec in kernels:
        rec["attributes"] = attributes[by_name[rec["name"]]]
    # each path's own count, read just after it ran from counts set to 0
    direct["launches_by_path"] = {"serve": default_counts["roi_align"],
                                  "eval": eval_counts["roi_align"],
                                  "infer_imgs": demo_counts["roi_align"],
                                  "train": train_counts["roi_align"],
                                  "train_loop": loop_counts["roi_align"],
                                  **{path: dp[path]["roi_align"] for path in DP_PATHS},
                                  **{f"serve {name}": c["roi_align"]
                                     for name, c in fast_counts.items()},
                                  **{f"closure {dtype}": c["roi_align"]
                                     for dtype, c in closure_counts.items()},
                                  **{path: c["roi_align"]
                                     for path, c in {**parity_counts, **tool_counts}.items()},
                                  "cold_start": cold_counts,
                                  "warm_start": WARM_LAUNCHES["roi_align"]}
    kernels[1]["launches_by_path"] = {"train": train_counts["roi_align_backward"],
                                      "train_loop": loop_counts["roi_align_backward"],
                                      **{path: dp[path]["roi_align_backward"]
                                         for path in DP_PATHS if path != "eval_nccl"},
                                      **{f"closure {dtype}": c["roi_align_backward"]
                                         for dtype, c in closure_counts.items()}}
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
