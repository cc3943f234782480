"""The hand-written CUDA RoIAlign kernel against its plain PyTorch version.

The tests marked ``cuda`` need a GPU and skip without one. The file imports
neither JAX nor the JAX package, so on a machine without JAX it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (both versions accumulate in float32): float32 to 1e-5
relative, the summation order of the samples; bfloat16 to 2^-7 relative,
one rounding of the output; both with 5e-5 absolute, a few float32 ulps of
sums of up to 36 samples of features up to 5 in magnitude.
"""

import numpy as np
import pytest
import torch

from monorun_tpu_torch.ops import roi_align as ra
from monorun_tpu_torch.ops.roi_align_cuda import RoIAlignKernel, roi_align_kernel

STRIDES = (4, 4, 8, 16)    # the lazy-lower rule: level 0 stored at stride 4
SPECIAL = np.array(
    [
        [0, 0.0, 0.0, 0.0, 0.0],        # zero-size padded slot
        [0, 2.0, 60.0, 120.0, 64.0],    # bottom sliver, moved by the span cap
        [1, 100.0, 0.0, 128.0, 3.0],    # top-right sliver
        [1, 10.0, 10.0, 90.0, 30.0],    # wide box
        [0, 5.0, 5.0, 6.5, 6.0],        # tiny box
        [0, 0.0, 28.0, 30.0, 36.0],     # straddles a 32-row band edge
        [1, -3.0, -2.0, 40.0, 70.0],    # reaches past the map (samples < -1)
        [1, 120.0, 60.0, 128.0, 64.0],  # far corner: the y0 + 1 clamp
    ],
    np.float32,
)


def _pyramid(device, dtype, B=2, H=64, W=128, C=32, seed=0):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.normal(size=(B, H // s, W // s, C)).astype(np.float32))
        .to(device, dtype)
        for s in STRIDES
    ]


def _rois(device, n=40, B=2, H=64, W=128, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, W - 4, n)
    y1 = rng.uniform(0, H - 4, n)
    x2 = np.clip(x1 + rng.uniform(1, 60.0, n), None, W)
    y2 = np.clip(y1 + rng.uniform(1, 40.0, n), None, H)
    rand = np.stack([rng.integers(0, B, n), x1, y1, x2, y2], 1).astype(np.float32)
    return torch.from_numpy(np.concatenate([rand, SPECIAL])).to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "out_size,finest,max_ratio",
    [((7, 7), 10.0, 3), ((7, 7), 10.0, 6), ((14, 14), 14.0, 2), ((14, 14), 14.0, 4)],
)
def test_kernel_matches_plain(cuda_device, dtype, out_size, finest, max_ratio):
    feats = _pyramid(cuda_device, dtype)
    rois = _rois(cuda_device)
    before = roi_align_kernel.launches
    got = ra.multilevel_roi_align_auto(feats, rois, STRIDES, out_size, finest,
                                       max_ratio=max_ratio)
    torch.cuda.synchronize()
    assert roi_align_kernel.launches == before + 1
    ref = ra.multilevel_roi_align(feats, rois, STRIDES, out_size, finest,
                                  max_ratio=max_ratio, long_span_cap=ra.LONG_SPAN_CAP)
    assert got.dtype == dtype and got.shape == ref.shape
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=5e-5)


@pytest.mark.cuda
def test_kernel_reads_strided_levels(cuda_device):
    """Levels that are views with padded rows go in without a copy."""
    wide = [f.new_zeros(f.shape[0], f.shape[1], f.shape[2] + 8, f.shape[3])
            for f in _pyramid(cuda_device, torch.float32)]
    feats = [w[:, :, :-8] for w in wide]
    for f, src in zip(feats, _pyramid(cuda_device, torch.float32)):
        f.copy_(src)
    rois = _rois(cuda_device)
    got = roi_align_kernel(feats, rois, STRIDES, (7, 7), 10.0, 3, ra.LONG_SPAN_CAP)
    ref = ra.multilevel_roi_align([f.contiguous() for f in feats], rois, STRIDES,
                                  (7, 7), 10.0, max_ratio=3,
                                  long_span_cap=ra.LONG_SPAN_CAP)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=5e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Checks that run before any build or launch: CPU tensors, other
    dtypes and a stride per level."""
    kernel = RoIAlignKernel()
    feats = _pyramid("cpu", torch.float32)
    rois = _rois("cpu")
    args = (STRIDES, (7, 7), 10.0, 3, ra.LONG_SPAN_CAP)
    with pytest.raises(ValueError, match="CUDA"):
        kernel(feats, rois, *args)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel([f.half() for f in feats], rois, *args)
    with pytest.raises(ValueError, match="levels"):
        kernel(feats[:2], rois, *args)
    assert kernel.launches == 0 and kernel._lib is None
