"""The work an align call must do on its inputs, for the align kernels'
rooflines: a frozen copy of the program's ``chip_smoke.py:
touched_cells`` and ``align_work``, on the reference's own
``sample_taps``."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the
# tensor cores (the align kernels accumulate in float32 FMAs)
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12


def touched_cells(feats, rois, strides, out_size, finest, max_ratio) -> Tuple[int, int]:
    """(level cells the call's taps touch with non-zero weight, computed
    samples)."""
    from monorun_ref.ops import roi_align as ra

    sizes = [(f.shape[1], f.shape[2]) for f in feats]
    rows, samples = [], 0
    for start in range(0, rois.shape[0], 1024):
        r, w, avg = ra.sample_taps(sizes, rois[start:start + 1024].float(), strides,
                                   out_size, finest, max_ratio, ra.LONG_SPAN_CAP)
        rows.append(torch.unique(r[(w > 0) & (avg > 0)]))
        samples += int(((w.sum(0) > 0) & (avg > 0)).sum())
    return int(torch.unique(torch.cat(rows)).numel()), samples


def align_work(feats, rois, strides, out_size, finest, max_ratio) -> Tuple[int, int]:
    """(bytes, FLOPs) one align call must move and do on these inputs."""
    C, item = feats[0].shape[-1], feats[0].element_size()
    touched, samples = touched_cells(feats, rois, strides, out_size, finest, max_ratio)
    n = rois.shape[0]
    nbytes = touched * C * item + n * 5 * 4 + n * out_size[0] * out_size[1] * C * item
    return nbytes, 2 * 4 * C * samples


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_S, flops / F32_FLOPS)


def strides_of(lazy_lower: bool, strides: Sequence[int]):
    from monorun_ref.ops.roi_align import align_strides

    return align_strides(lazy_lower, strides)
