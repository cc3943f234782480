"""The hand-written CUDA RoIAlign kernels against their plain PyTorch versions.

The tests marked ``cuda`` need a GPU and skip without one. The file imports
neither JAX nor the JAX package, so on a machine without JAX it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (both versions accumulate in float32): float32 to 1e-5
relative, the summation order of the samples; bfloat16 to 2^-7 relative,
one rounding of the output; both with 5e-5 absolute, a few float32 ulps of
sums of up to 36 samples of features up to 5 in magnitude. The staged
kernels (tile, band tiered, band packed, band matmul) are held to their
plain version on the same prepared inputs with the same tolerances; with
the row product rounded to bfloat16 (matmul, ``t1_dtype``) one rounding
of t1 more, 2^-8 max|x|.

The direct kernel's backward (``csrc/roi_align_bwd.cu``) is held to the
plain version's autograd in float32 on the same (upcast) inputs and output
gradient: the level gradients to 1e-5 relative in float32 and one
bfloat16 rounding (2^-7) in bfloat16, the RoI gradients (float32 in both)
to 1e-4 relative; with an absolute floor of 1e-5 (levels) and 1e-4
(RoIs) of the gradient's largest entry: the kernels sum the taps of a
cell, and the channels of a RoI's hundreds of taps, in another (fixed)
order than autograd. The backward has no atomics, so two calls agree bit
for bit; its index pass is held to ``roi_align.backward_index``.

The heaviest core cases on the CPU are in ``test_torch_cuda_core.py``: files of
at most 3 tests, which xdist hands out late (ROADMAP's test-time budget).
"""

import numpy as np
import pytest
import torch

from monorun_tpu_torch.ops import roi_align as ra
from monorun_tpu_torch.ops import roi_align_band as rb
from monorun_tpu_torch.ops import roi_align_cuda as rc
from monorun_tpu_torch.ops import roi_align_tile as rt
from monorun_tpu_torch.ops.roi_align_cuda import RoIAlignKernel, roi_align_kernel

from torch_share import cpu_share  # noqa: F401

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


# the merge rule's edge cases (test_torch_roi_align_merge.py) on a wide
# lazy pyramid: 150-cell slivers at level 1 (samples more than a cell
# apart), samples outside [-1, size], far taps clamped on the last row and
# column, zero-size slots
EDGE_HW = (64, 640)
EDGE = np.array(
    [
        [0, 0.0, 0.0, 0.0, 0.0],
        [1, 0.0, 0.0, 0.0, 0.0],
        [0, 10.0, 30.0, 610.0, 31.0],
        [1, 20.0, 50.0, 630.0, 52.0],
        [0, -40.0, -30.0, 60.0, 20.0],
        [1, 560.0, 40.0, 720.0, 90.0],
        [0, 600.0, 48.0, 640.0, 64.0],
        [1, 636.0, 61.0, 640.0, 64.0],
        [0, 5.0, 5.0, 6.5, 6.0],
        [1, 100.0, 0.0, 400.0, 64.0],
    ],
    np.float32,
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size,finest,max_ratio", [((7, 7), 10.0, 6), ((14, 14), 14.0, 4)])
def test_kernel_edge_cases_match_plain(cuda_device, dtype, out_size, finest, max_ratio):
    H, W = EDGE_HW
    feats = _pyramid(cuda_device, dtype, H=H, W=W, seed=1)
    rng = np.random.default_rng(1)
    x1, y1 = rng.uniform(0, W - 4, 40), rng.uniform(0, H - 4, 40)
    rand = np.stack([rng.integers(0, 2, 40), x1, y1, np.clip(x1 + rng.uniform(1, 300, 40), None, W),
                     np.clip(y1 + rng.uniform(1, 60, 40), None, H)], 1).astype(np.float32)
    rois = torch.from_numpy(np.concatenate([rand, EDGE])).to(cuda_device)
    before = roi_align_kernel.launches
    got = roi_align_kernel(feats, rois, STRIDES, out_size, finest, max_ratio, ra.LONG_SPAN_CAP)
    roi_align_kernel.empty_launch()
    torch.cuda.synchronize()
    assert roi_align_kernel.launches == before + 1
    ref = ra.multilevel_roi_align(feats, rois, STRIDES, out_size, finest,
                                  max_ratio=max_ratio, long_span_cap=ra.LONG_SPAN_CAP)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "out_size,max_ratio,C,n",
    [
        ((2, 3), 2, 16, 40),      # 4 warps, idle half warps in the list build
        ((5, 9), 16, 48, 40),     # the half-warp sample cap, odd sizes
        ((28, 28), 3, 32, 40),    # 56 lists: 16 warps build them in two passes
        ((7, 7), 6, 512, 1500),   # two vectors per lane, one block per RoI
    ],
)
def test_kernel_launch_shapes_match_plain(cuda_device, dtype, out_size, max_ratio, C, n):
    """Warps per block, the bin split and the channel loop away from the
    serving shapes."""
    feats = _pyramid(cuda_device, dtype, C=C, seed=2)
    rois = _rois(cuda_device, n=n, seed=2)
    got = roi_align_kernel(feats, rois, STRIDES, out_size, 10.0, max_ratio, ra.LONG_SPAN_CAP)
    ref = ra.multilevel_roi_align(feats, rois, STRIDES, out_size, 10.0,
                                  max_ratio=max_ratio, long_span_cap=ra.LONG_SPAN_CAP)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=5e-5)


def test_wrapper_refuses_sample_caps_beyond_a_half_warp():
    """The direct kernel computes one sample per lane of a half warp."""
    kernel = RoIAlignKernel()
    feats = _pyramid("cpu", torch.float32)
    for max_ratio in (0, rc.MAX_RATIO + 1):
        with pytest.raises(ValueError, match="max_ratio"):
            kernel(feats, _rois("cpu"), STRIDES, (7, 7), 10.0, max_ratio, ra.LONG_SPAN_CAP)
    assert kernel.launches == 0 and kernel._lib is None


@pytest.mark.cuda
def test_kernel_keeps_every_value_in_registers(cuda_device):
    """No spill and no stack in either dtype, within the 64 registers that
    let 32 warps share an SM, as the loaded build reports."""
    attributes = roi_align_kernel.attributes()
    assert set(attributes) == {"bfloat16", "float32"}
    for a in attributes.values():
        assert a["local_bytes"] == 0 and 0 < a["registers"] <= 64


SASS = """
        Function : _ZN12_GLOBAL__N_124roi_align_forward_kernelI13__nv_bfloat16EEvNS_7PyramidENS_6ParamsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR10][R2.64] ;   /* 0x000000 */
        /*0020*/                   FFMA R8, R9, R4, R8 ;                   /* 0x000000 */
        /*0030*/                   IADD3 R2, R2, 0x1, RZ ;                 /* 0x000000 */
        /*0040*/              @!P0 BRA 0x10 ;                              /* 0x000000 */
        /*0050*/                   STG.E.EF.128 desc[UR10][R16.64], R12 ;  /* 0x000000 */
        /*0060*/              @!P1 BRA 0x0 ;                               /* 0x000000 */
        /*0070*/                   EXIT ;                                  /* 0x000000 */
        Function : _ZN12_GLOBAL__N_112empty_kernelEv
        /*0000*/                   EXIT ;                                  /* 0x000000 */
"""


def test_sass_loops_counts_the_loops_that_load():
    from monorun_tpu_torch.tools import sass_loops

    kernels = sass_loops.parse(SASS.splitlines())
    assert [len(v) for v in kernels.values()] == [8, 1]
    name = next(iter(kernels))
    assert sass_loops.load_loops(kernels[name]) == [
        dict(instructions=4, loads=1, ffma=1, start="10"),
        dict(instructions=7, loads=1, ffma=1, start="0"),
    ]


VARIANTS = {
    "tile": (rc.tile_kernel, {}),
    "tiered": (rc.band_tiered_kernel, dict(tiered=True, kroi=4)),
    "packed": (rc.band_packed_kernel, dict(packed=True, kroi=4)),
    "matmul": (rc.band_matmul_kernel, dict(matmul=True, kroi=16)),
    "matmul_t1_bf16": (rc.band_matmul_kernel,
                       dict(matmul=True, kroi=16, t1_dtype=torch.bfloat16)),
    # other block sizes (MONORUN_BAND_KROI): the launcher picks a smaller
    # channel slice where the block's sums outgrow shared memory
    "tiered_kroi16": (rc.band_tiered_kernel, dict(tiered=True, kroi=16)),
    "packed_kroi8": (rc.band_packed_kernel, dict(packed=True, kroi=8)),
    "matmul_kroi4": (rc.band_matmul_kernel, dict(matmul=True, kroi=4)),
}


def _staged(variant, feats, rois, out_size, finest, max_ratio):
    """(kernel, prepared call, plain version's output) of one variant."""
    kernel, kw = VARIANTS[variant]
    if variant == "tile":
        call = rt.prepare_tile_call(feats, rois, STRIDES, out_size, finest, max_ratio)
        return kernel, call, rt.tile_call_plain(call)
    call = rb.prepare_band_call(feats, rois, STRIDES, out_size, finest, max_ratio, **kw)
    return kernel, call, rb.band_call_plain(call)


def _check_staged(kernel, call, ref, feats):
    before = kernel.launches
    got = kernel(call)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == ref.dtype and got.shape == ref.shape
    rtol = 2 ** -7 if ref.dtype == torch.bfloat16 else 1e-5
    atol = 1e-5 * max(1.0, float(ref.float().abs().max()))
    if getattr(call, "t1_dtype", None) is not None:
        atol += 2 ** -8 * max(float(f.float().abs().max()) for f in feats)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "out_size,finest,max_ratio", [((7, 7), 10.0, 3), ((14, 14), 14.0, 2)],
)
def test_staged_kernel_matches_plain(cuda_device, variant, dtype, out_size, finest,
                                     max_ratio):
    feats = _pyramid(cuda_device, dtype)
    rois = _rois(cuda_device)
    kernel, call, ref = _staged(variant, feats, rois, out_size, finest, max_ratio)
    _check_staged(kernel, call, ref, feats)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_kernel_serving_size(cuda_device, variant, dtype):
    """A kitti_multiclass-sized pyramid (batch 8, C=256, 384x1280 at strides
    4, 4, 8, 16) and 2000 RoIs."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    feats = [torch.randn(8, 384 // s, 1280 // s, 256, generator=gen, device=cuda_device)
             .to(dtype) for s in STRIDES]
    n = 2000
    u = torch.rand(n, 4, generator=gen, device=cuda_device)
    side = 4.0 * 100.0 ** u[:, 0]
    x1, y1 = u[:, 1] * 1242, u[:, 2] * 375
    ar = 4.0 ** (2 * u[:, 3] - 1)
    b = torch.arange(n, device=cuda_device).remainder(8).float()
    rois = torch.stack([b, x1, y1, (x1 + side * ar.sqrt()).clamp(max=1242),
                        (y1 + side / ar.sqrt()).clamp(max=375)], 1)
    kernel, call, ref = _staged(variant, feats, rois, (7, 7), 20.0, 6)
    _check_staged(kernel, call, ref, feats)


@pytest.mark.cuda
def test_dispatch_launches_the_selected_kernel(cuda_device, monkeypatch):
    """Under MONORUN_ALIGN_IMPL=band MONORUN_BAND_TIERED=1 the align runs
    the tiered kernel, under bandmm the matmul kernel, by default the
    direct kernel; all three agree with the gather version."""
    feats = _pyramid(cuda_device, torch.float32)
    rois = _rois(cuda_device)
    ref = ra.multilevel_roi_align(feats, rois, STRIDES, (7, 7), 10.0, max_ratio=3,
                                  long_span_cap=ra.LONG_SPAN_CAP)
    for env, kernel in (({}, roi_align_kernel),
                        ({"MONORUN_ALIGN_IMPL": "band", "MONORUN_BAND_TIERED": "1"},
                         rc.band_tiered_kernel),
                        ({"MONORUN_ALIGN_IMPL": "bandmm"}, rc.band_matmul_kernel)):
        for name in ("MONORUN_ALIGN_IMPL", "MONORUN_BAND_TIERED"):
            monkeypatch.delenv(name, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        counts = [k.launches for k in (roi_align_kernel, *rc.STAGED_KERNELS)]
        pyr = ra.prepare_pyramid(feats)
        assert (pyr is None) == (not env)
        got = ra.multilevel_roi_align_auto(feats, rois, STRIDES, (7, 7), 10.0, max_ratio=3,
                                           tile_h=24, pyramid=pyr)
        torch.cuda.synchronize()
        after = [k.launches for k in (roi_align_kernel, *rc.STAGED_KERNELS)]
        assert [a - b for a, b in zip(after, counts)] == [
            int(k is kernel) for k in (roi_align_kernel, *rc.STAGED_KERNELS)]
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=5e-5)


def test_staged_wrapper_refuses_cpu_tensors():
    """Checks that run before any build or launch."""
    feats = _pyramid("cpu", torch.float32)
    rois = _rois("cpu")
    call = rt.prepare_tile_call(feats, rois, STRIDES, (7, 7), 10.0, 3)
    kernel = rc.StagedKernel("tile", "roi_align_tile", "roi_align_tile_forward", [])
    with pytest.raises(ValueError, match="CUDA"):
        kernel(call)
    band = rb.prepare_band_call(feats, rois, STRIDES, (7, 7), 10.0, 3, kroi=4, tiered=True)
    with pytest.raises(ValueError, match="CUDA"):
        rc.band_packed_kernel(band)
    assert kernel.launches == 0 and kernel._fn is None


# ---- the staged core (csrc/roi_align_ring.cuh): band tiered, packed, matmul --

CORE_VARIANTS = {
    "tiered": (rc.band_tiered_kernel, dict(tiered=True)),
    "packed": (rc.band_packed_kernel, dict(packed=True)),
    "matmul": (rc.band_matmul_kernel, dict(matmul=True)),
    "matmul_t1_bf16": (rc.band_matmul_kernel, dict(matmul=True, t1_dtype=torch.bfloat16)),
}
LAZY_SLIVERS = np.array([[0, 10.0, 50.0, 480.0, 60.0], [1, 20.0, 30.0, 420.0, 42.0]],
                        np.float32)
# two narrow and two wide RoIs in one band of level 0: a packed group of
# tiers 1, 1, 3, 3, whose narrow slots take only their own 32 columns; and
# a tall RoI elsewhere
MIXED_TIERS = np.array([[0, 20.0, 40.0, 40.0, 46.0], [0, 50.0, 42.0, 62.0, 47.0],
                        [0, 100.0, 40.0, 390.0, 44.0], [0, 120.0, 41.0, 400.0, 45.0],
                        [1, 10.0, 10.0, 16.0, 70.0]], np.float32)
# name -> pyramid (H, W, C), RoIs (n, largest side, extra), out size, finest, kroi
CORE_CASES = {
    # 120 small RoIs at level 0: blocks of 16 whose windows span the band
    "full_band": dict(H=128, W=256, C=32, n=120, side=24.0, out=7, finest=40.0, kroi=16),
    # levels 48x160, 48x160, 24x80 and 12x40: the last narrower than a panel
    "narrow_level": dict(H=192, W=640, C=32, n=60, side=600.0, out=7, finest=10.0, kroi=8),
    "c64": dict(H=64, W=128, C=64, n=40, side=60.0, out=7, finest=10.0, kroi=8),
    "c128": dict(H=64, W=128, C=128, n=40, side=60.0, out=14, finest=14.0, kroi=8),
    "kroi4": dict(H=64, W=128, C=32, n=40, side=60.0, out=14, finest=14.0, kroi=4),
    "kroi16": dict(H=64, W=128, C=32, n=40, side=60.0, out=7, finest=10.0, kroi=16),
    "kroi32": dict(H=64, W=128, C=32, n=40, side=60.0, out=14, finest=14.0, kroi=32),
    # lazy-level slivers that overrun the 96-column window (kernel == plain)
    "slivers": dict(H=128, W=512, C=32, n=8, side=60.0, out=7, finest=20.0, kroi=4,
                    extra=LAZY_SLIVERS),
    "mixed_tiers": dict(H=128, W=512, C=32, n=0, side=60.0, out=7, finest=20.0, kroi=4,
                        extra=MIXED_TIERS),
}
HEAVY_CORE_CASES = ("c128", "full_band", "kroi32")   # in test_torch_cuda_core.py


def _core_call(case, variant, device, dtype):
    """(features, RoIs as numpy, prepared band call) of one edge case."""
    p = CORE_CASES[case]
    feats = _pyramid(device, dtype, H=p["H"], W=p["W"], C=p["C"], seed=3)
    rng = np.random.default_rng(3)
    n, H, W = p["n"], p["H"], p["W"]
    x1, y1 = rng.uniform(0, W - 4, n), rng.uniform(0, H - 4, n)
    rois = np.stack([rng.integers(0, 2, n), x1, y1,
                     np.clip(x1 + rng.uniform(1, p["side"], n), None, W),
                     np.clip(y1 + rng.uniform(1, p["side"] / 2, n), None, H)], 1)
    rois = np.concatenate([rois.astype(np.float32), p.get("extra", SPECIAL[:0])])
    kw = dict(CORE_VARIANTS[variant][1], kroi=p["kroi"])
    call = rb.prepare_band_call(feats, torch.from_numpy(rois).to(device), STRIDES,
                                (p["out"],) * 2, p["finest"], 6, **kw)
    return feats, rois, call


def _core_case_holds(case, call):
    """The edge each case is there for, and blocks every case has: all-dummy
    blocks (matmul: trailing inactive ones) and RoIs in both orientations."""
    real = call.dst.view(-1, call.kroi) >= 0
    assert (~real).all(1).any()
    if call.mode == "matmul":
        assert not bool(call.blk_act.bool().all())
    trans = call.trans[call.dst >= 0]
    assert trans.any() and not trans.all()
    if case == "mixed_tiers" and call.mode == "packed":
        tiers = call.ncb.view(-1, 4)[(call.dst.view(-1, 4) >= 0).all(1)]
        assert ((tiers.amin(1) == 1) & (tiers.amax(1) == 3)).any()
    if case == "full_band" and call.mode in ("tiered", "packed"):
        rw0 = call.row0.view(-1, call.kroi)
        assert max(int(r[m].max() - r[m].min()) for r, m in zip(rw0, real) if m.any()) \
            + call.th > 48          # K = 64: the whole band
    if case == "narrow_level":
        narrow = [i for i, b in enumerate(call.bufs) if b.shape[1] < 2 * call.tw]
        used = call.blk_buf.view(-1, 1).expand_as(real)[real]
        assert narrow and any(int(b) in narrow for b in used)


def check_core_case(case):
    """Each edge case reaches its edge; on the CPU the core's zero-extended
    product (``union_product``) matches the tiered, packed and matmul plain
    versions (matmul also with its row product in bfloat16), and the tiered
    and matmul plain versions agree with the gather version on every RoI
    whose window holds all its taps."""
    p = CORE_CASES[case]
    out = (p["out"],) * 2
    for variant in ("packed", "matmul_t1_bf16"):
        _, _, call = _core_call(case, variant, "cpu", torch.float32)
        _core_case_holds(case, call)
        torch.testing.assert_close(rb.union_product(call), rb.band_call_plain(call),
                                   rtol=1e-5, atol=5e-5)
    for variant in ("tiered", "matmul"):
        feats, rois, call = _core_call(case, variant, "cpu", torch.float32)
        _core_case_holds(case, call)
        plain = rb.band_call_plain(call)
        torch.testing.assert_close(rb.union_product(call), plain, rtol=1e-5, atol=5e-5)
        rois = torch.from_numpy(rois)
        gather = ra.multilevel_roi_align(feats, rois, STRIDES, out, p["finest"], max_ratio=6,
                                         long_span_cap=ra.LONG_SPAN_CAP)
        fits = rt.roi_tile_geometry(rois, rt.prepare_flat_pyramid(feats).sizes, STRIDES, out,
                                    p["finest"], 6, rt.MAX_TH, rt.MAX_TW, torch.float32).fits
        assert fits.sum() >= p["n"]
        torch.testing.assert_close(plain[fits], gather[fits], rtol=1e-5, atol=5e-5)
    assert case != "slivers" or call.n == p["n"] + 2


@pytest.mark.parametrize("case", [c for c in CORE_CASES if c not in HEAVY_CORE_CASES])
def test_core_cases_hold_on_cpu(case):
    check_core_case(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CORE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", list(CORE_VARIANTS))
def test_core_kernels_match_plain_on_edges(cuda_device, variant, dtype, case):
    feats, _, call = _core_call(case, variant, cuda_device, dtype)
    _core_case_holds(case, call)
    kernel = CORE_VARIANTS[variant][0]
    _check_staged(kernel, call, rb.band_call_plain(call), feats)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["tiered", "matmul", "packed", "tile"])
def test_core_kernels_take_no_rois(cuda_device, variant, dtype):
    feats = _pyramid(cuda_device, dtype)
    rois = torch.zeros(0, 5, device=cuda_device)
    if variant == "tile":
        kernel, call = rc.tile_kernel, rt.prepare_tile_call(feats, rois, STRIDES, (7, 7), 10.0, 3)
    else:
        kernel, kw = CORE_VARIANTS[variant]
        call = rb.prepare_band_call(feats, rois, STRIDES, (7, 7), 10.0, 3, kroi=4, **kw)
    before = kernel.launches
    got = kernel(call)
    torch.cuda.synchronize()
    assert got.shape == (0, 7, 7, 32) and kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tiered", "matmul", "packed", "tile"])
def test_core_kernels_keep_sums_in_registers(cuda_device, variant):
    """No local memory in either dtype, at most 128 registers (2 blocks
    of 8 warps per SM), and channel slices of at least
    16 with at least 2 resident blocks per SM at the serving shapes (7x7
    and 14x14, bfloat16 and float32). A block takes 8 output columns, and
    16 in float32 when the output is wider, so float32 14x14 computes its
    row product once. A tile block holds one RoI: one m-tile, 64 channels."""
    kernel = rc.tile_kernel if variant == "tile" else CORE_VARIANTS[variant][0]
    attributes = kernel.attributes()
    assert set(attributes) == {"bfloat16", "float32"}
    for a in attributes.values():
        assert a["local_bytes"] == 0 and 0 < a["registers"] <= 128
    kroi = {"tiered": 4, "packed": 4, "matmul": 16, "tile": 1}[variant]
    for dtype in (torch.bfloat16, torch.float32):
        for out in (7, 14):
            shape = kernel.launch_shape(dtype, kroi, out, 96)
            assert shape["channels"] >= 16 and shape["blocks_per_sm"] >= 2, shape
            assert shape["threads"] == 256
            assert shape["j_groups"] == (2 if out == 14 and dtype == torch.bfloat16 else 1)
            if variant == "tile":
                assert shape["m_tiles"] == 1 and shape["channels"] == 64, shape


# ---- the tile kernel on the staged core, one RoI per block --------------------

# tall and wide RoIs on the last rows of image 1 (the last rows of the
# row-major level-0 buffer) and on the last columns of a 128-column level
EDGE_TILES = np.array([[1, 40.0, 121.0, 70.0, 128.0], [1, 200.0, 118.0, 215.0, 128.0],
                       [0, 480.0, 10.0, 512.0, 20.0], [1, 470.0, 60.0, 512.0, 66.0],
                       [1, 505.0, 30.0, 512.0, 90.0], [0, 130.0, 2.0, 138.0, 60.0]],
                      np.float32)
# name -> pyramid (H, W, C), RoIs (n, largest side, extra), out size, finest
TILE_CASES = {
    # levels 48x160 .. 12x40 and boxes up to 600 pixels: nrb 1-2, ncb 1-3
    "tiers": dict(H=192, W=640, C=32, n=60, side=600.0, out=7, finest=10.0),
    "edges": dict(H=128, W=512, C=32, n=8, side=60.0, out=14, finest=20.0, extra=EDGE_TILES),
    "c64": dict(H=64, W=128, C=64, n=40, side=60.0, out=7, finest=10.0),
    "c128": dict(H=64, W=128, C=128, n=40, side=60.0, out=14, finest=14.0),
    # lazy-level slivers that overrun the 96-column window (kernel == plain)
    "slivers": dict(H=128, W=512, C=32, n=8, side=60.0, out=7, finest=20.0,
                    extra=LAZY_SLIVERS),
}


def _tile_call(case, device, dtype):
    p = TILE_CASES[case]
    feats = _pyramid(device, dtype, H=p["H"], W=p["W"], C=p["C"], seed=4)
    rng = np.random.default_rng(4)
    n, H, W = p["n"], p["H"], p["W"]
    x1, y1 = rng.uniform(0, W - 4, n), rng.uniform(0, H - 4, n)
    rois = np.stack([rng.integers(0, 2, n), x1, y1,
                     np.clip(x1 + rng.uniform(1, p["side"], n), None, W),
                     np.clip(y1 + rng.uniform(1, p["side"] / 2, n), None, H)], 1)
    rois = np.concatenate([rois.astype(np.float32), p.get("extra", SPECIAL[:0])])
    call = rt.prepare_tile_call(feats, torch.from_numpy(rois).to(device), STRIDES,
                                (p["out"],) * 2, p["finest"], 6)
    return feats, call


def _tile_case_holds(case, call):
    """The edge each case is there for, and RoIs in both orientations."""
    g = call.geo
    assert g.tmask.any() and not g.tmask.all()
    if case == "tiers":
        assert set(g.nrb.tolist()) == {1, 2} and set(g.ncb.tolist()) == {1, 2, 3}
    if case == "edges":
        bufs = call.pyramid.bufs
        rows = torch.tensor([bufs[int(b)].shape[0] for b in g.buf_id])
        cols = torch.tensor([bufs[int(b)].shape[1] for b in g.buf_id])
        assert (g.r0.cpu() + 16 * g.nrb.cpu() == rows).any()
        assert (g.c0.cpu() + 32 * g.ncb.cpu() == cols).any()
    if case == "slivers":
        assert int((~g.fits).sum()) == 2


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_cases_hold_on_cpu(case):
    """Each tile edge case reaches its edge; on the CPU the core's product
    with one RoI per block (``union_product``: the RoI's 16 x nrb rows by
    32 x ncb columns) matches the tile plain version."""
    _, call = _tile_call(case, "cpu", torch.float32)
    _tile_case_holds(case, call)
    torch.testing.assert_close(rb.union_product(call), rt.tile_call_plain(call),
                               rtol=1e-5, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TILE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_kernel_matches_plain_on_edges(cuda_device, dtype, case):
    feats, call = _tile_call(case, cuda_device, dtype)
    _tile_case_holds(case, call)
    _check_staged(rc.tile_kernel, call, rt.tile_call_plain(call), feats)


# ---- the direct kernel's backward -------------------------------------------

STRIDES5 = (4, 4, 8, 16, 32)
# a backward call with both gradients: the per-RoI kernel, the bucket sort
# and the tile kernel
BACKWARD_LAUNCHES = 3


def _pyramid5(device, dtype, B=2, H=64, W=128, C=32, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, H // s, W // s, C)).astype(np.float32))
            .to(device, dtype) for s in STRIDES5]


def _level_rois(device, n=60, B=2, H=64, W=128, seed=0):
    """RoIs whose sides span 2 to 120 pixels (every level at finest scale
    4), slivers, RoIs past the map and the special cases."""
    rng = np.random.default_rng(seed)
    side = 2.0 * 60.0 ** rng.uniform(0, 1, n)
    aspect = 4.0 ** rng.uniform(-1, 1, n)
    w, h = side * np.sqrt(aspect), side / np.sqrt(aspect)
    x1, y1 = rng.uniform(-8, W - 2, n), rng.uniform(-8, H - 2, n)
    rand = np.stack([rng.integers(0, B, n), x1, y1, x1 + w, y1 + h], 1).astype(np.float32)
    return torch.from_numpy(np.concatenate([rand, SPECIAL])).to(device)


def _plain_grads(feats, rois, strides, out_size, finest, max_ratio, grad_out):
    """The plain version's autograd in float32 on the upcast inputs:
    (d levels, d rois)."""
    f32 = [f.detach().float().requires_grad_() for f in feats]
    r32 = rois.detach().float().requires_grad_()
    out = ra.multilevel_roi_align(f32, r32, strides, out_size, finest, max_ratio=max_ratio,
                                  long_span_cap=ra.LONG_SPAN_CAP)
    grads = torch.autograd.grad(out, f32 + [r32], grad_out.float())
    return list(grads[:-1]), grads[-1]


def _grad_close(got, ref, rtol, atol_rel):
    """|got - ref| <= rtol |ref| + atol_rel max |ref|."""
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol_rel * scale)


def _check_backward(feats, rois, strides, out_size, finest, max_ratio, seed=0):
    """The backward kernel once, against the plain version's autograd."""
    dtype = feats[0].dtype
    gen = torch.Generator(device=feats[0].device).manual_seed(seed)
    grad_out = torch.randn((rois.shape[0],) + tuple(out_size) + (feats[0].shape[-1],),
                           generator=gen, device=feats[0].device).to(dtype)
    before = rc.roi_align_backward_kernel.launches
    d_levels, d_rois = rc.roi_align_backward_kernel(
        feats, rois, grad_out, strides, out_size, finest, max_ratio, ra.LONG_SPAN_CAP)
    torch.cuda.synchronize()
    assert rc.roi_align_backward_kernel.launches == before + BACKWARD_LAUNCHES * int(
        rois.shape[0] > 0)
    ref_levels, ref_rois = _plain_grads(feats, rois, strides, out_size, finest, max_ratio,
                                        grad_out)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    for got, ref in zip(d_levels, ref_levels):
        assert got.dtype == dtype and got.shape == ref.shape
        _grad_close(got, ref.to(dtype), rtol, 1e-5)
    assert d_rois.dtype == torch.float32 and d_rois.shape == rois.shape
    assert bool((d_rois[:, 0] == 0).all())
    _grad_close(d_rois, ref_rois, 1e-4, 1e-4)
    return d_levels, d_rois


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "out_size,finest,max_ratio",
    [((7, 7), 4.0, 3), ((7, 7), 10.0, 6), ((14, 14), 4.0, 2), ((14, 14), 14.0, 4)],
)
def test_backward_matches_plain_autograd(cuda_device, dtype, out_size, finest, max_ratio):
    """Every level of a five-level lazy pyramid, slivers, RoIs past the
    map, samples on the last row and column, zero-size slots."""
    feats = _pyramid5(cuda_device, dtype)
    rois = _level_rois(cuda_device)
    d_levels, _ = _check_backward(feats, rois, STRIDES5, out_size, finest, max_ratio)
    if finest == 4.0:
        assert all(bool(d.abs().sum() > 0) for d in d_levels)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("n", [1, 3, 300])
def test_backward_launch_shapes(cuda_device, dtype, C, n):
    """Channel vectors per lane, and the bins of few RoIs dealt over
    blockIdx.y (the RoI gradient summed over the blocks)."""
    feats = _pyramid5(cuda_device, dtype, C=C, seed=3)
    rois = _level_rois(cuda_device, n=n, seed=3)[:n]
    if n < 10:
        assert rc.roi_align_backward_kernel.launch_shape(n, (7, 7))["split"] > 1
    _check_backward(feats, rois, STRIDES5, (7, 7), 4.0, 3, seed=n)
    _check_backward(feats, rois, STRIDES5, (14, 14), 4.0, 2, seed=n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_contended_taps(cuda_device, dtype):
    """Hundreds of RoIs on the same taps: every bin of each meets on a few
    level cells, and one tile walks 600 RoIs of its bucket (three chunks
    of the tile kernel's block) among other keys'; the hot tile's sums
    repeat bit for bit."""
    feats = _pyramid5(cuda_device, dtype, seed=4)
    base = torch.tensor([[0, 10.0, 10.0, 40.0, 30.0], [1, 60.0, 20.0, 61.0, 21.0],
                         [0, 12.0, 11.0, 13.0, 12.5], [0, 9.0, 12.0, 14.0, 13.0],
                         [0, 11.0, 9.0, 15.0, 14.0]],
                        device=cuda_device)
    rois = base.repeat(200, 1)
    d_levels, d_rois = _check_backward(feats, rois, STRIDES5, (7, 7), 10.0, 3, seed=4)
    ix = rc.roi_align_backward_kernel.index(feats, rois, STRIDES5, (7, 7), 10.0, 3,
                                            ra.LONG_SPAN_CAP)
    assert int(torch.diff(ix.offsets).max()) >= 600
    grad_out = torch.randn((rois.shape[0], 7, 7, feats[0].shape[-1]), device=cuda_device,
                           generator=torch.Generator(device=cuda_device).manual_seed(4)
                           ).to(dtype)
    again = rc.roi_align_backward_kernel(feats, rois, grad_out, STRIDES5, (7, 7), 10.0, 3,
                                         ra.LONG_SPAN_CAP)
    assert all(torch.equal(a, b) for a, b in zip(d_levels, again[0]))
    assert torch.equal(d_rois, again[1])


@pytest.mark.cuda
def test_backward_takes_no_rois(cuda_device):
    feats = _pyramid5(cuda_device, torch.float32)
    rois = torch.zeros((0, 5), device=cuda_device)
    grad_out = torch.zeros((0, 7, 7, feats[0].shape[-1]), device=cuda_device)
    before = rc.roi_align_backward_kernel.launches
    d_levels, d_rois = rc.roi_align_backward_kernel(
        feats, rois, grad_out, STRIDES5, (7, 7), 4.0, 3, ra.LONG_SPAN_CAP)
    assert rc.roi_align_backward_kernel.launches == before
    assert d_rois.shape == (0, 5) and all(not bool(d.any()) for d in d_levels)


@pytest.mark.cuda
def test_backward_keeps_every_value_in_registers(cuda_device):
    """Each of the backward's kernels, in each dtype: no spills."""
    attributes = rc.roi_align_backward_kernel.attributes()
    assert set(attributes) == {"rois bfloat16", "rois float32", "buckets",
                               "levels bfloat16", "levels float32"}
    for a in attributes.values():
        assert a["local_bytes"] == 0 and a["registers"] > 0


def _grad_out(feats, n, out_size, seed):
    dev = feats[0].device
    return torch.randn((n,) + tuple(out_size) + (feats[0].shape[-1],), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed)
                       ).to(feats[0].dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size,max_ratio", [((7, 7), 6), ((14, 14), 4)])
def test_backward_is_bit_repeatable(cuda_device, dtype, out_size, max_ratio):
    """Two calls give bitwise-equal level and RoI gradients: no atomics."""
    feats = _pyramid5(cuda_device, dtype, C=64, seed=6)
    rois = _level_rois(cuda_device, n=300, seed=6)
    grad_out = _grad_out(feats, rois.shape[0], out_size, 6)
    args = (feats, rois, grad_out, STRIDES5, out_size, 4.0, max_ratio, ra.LONG_SPAN_CAP)
    first, second = rc.roi_align_backward_kernel(*args), rc.roi_align_backward_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(first[0], second[0]))
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_writes_every_cell(cuda_device, dtype):
    """The level gradients come from torch.empty: blocks of their sizes
    filled with NaN and freed first come back without a NaN, the cells no
    tap reaches 0."""
    feats = _pyramid5(cuda_device, dtype, C=64, seed=7)
    rois = _level_rois(cuda_device, n=12, seed=7)
    blocks = [torch.full(f.shape, float("nan"), dtype=dtype, device=cuda_device)
              for f in feats]
    del blocks
    d_levels, _ = _check_backward(feats, rois, STRIDES5, (7, 7), 4.0, 3, seed=7)
    for d in d_levels:
        assert bool(torch.isfinite(d).all())
    assert any(bool((d == 0).any()) for d in d_levels)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_with_zero_gradient_rois(cuda_device, dtype):
    """RoIs whose output gradient is zero (a step's padded slots) stay out
    of the tile kernel's buckets: the gradients are still the plain
    version's, theirs exactly 0 in the RoI gradient, and every output
    gradient zero gives zero levels."""
    feats = _pyramid5(cuda_device, dtype, C=64, seed=12)
    rois = _level_rois(cuda_device, n=120, seed=12)
    for zero_every in (2, 1):
        grad_out = _grad_out(feats, rois.shape[0], (7, 7), 12)
        dead = torch.arange(rois.shape[0], device=cuda_device) % zero_every == 0
        grad_out[dead] = 0
        d_levels, d_rois = rc.roi_align_backward_kernel(
            feats, rois, grad_out, STRIDES5, (7, 7), 4.0, 3, ra.LONG_SPAN_CAP)
        ref_levels, ref_rois = _plain_grads(feats, rois, STRIDES5, (7, 7), 4.0, 3, grad_out)
        rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
        for got, ref in zip(d_levels, ref_levels):
            _grad_close(got, ref.to(dtype), rtol, 1e-5)
        _grad_close(d_rois, ref_rois, 1e-4, 1e-4)
        assert bool((d_rois[dead] == 0).all())
        if zero_every == 1:
            assert all(not bool(d.any()) for d in d_levels)


# RoIs whose taps end on a tile's last row or column, start on the next
# tile's first, straddle tile corners, or reach a level's ragged last row
# and column (a 72x136 canvas: levels of 18x34, 18x34, 9x17, 4x8, 2x4
# cells, none a whole number of tiles): edges of 32 pixels at stride 4 are
# tile edges in both dtypes (8 rows, 4 columns)
TILE_EDGES = np.array([
    [0, 28.0, 28.0, 36.0, 36.0], [0, 30.0, 2.0, 33.0, 5.0], [1, 2.0, 30.0, 5.0, 34.0],
    [1, 60.0, 60.0, 68.0, 70.0], [0, 62.0, 26.0, 66.0, 38.0], [1, 94.0, 30.0, 98.0, 33.0],
    [0, 120.0, 62.0, 136.0, 72.0], [1, 128.0, 0.0, 136.0, 72.0], [0, 0.0, 64.0, 136.0, 72.0],
    [1, 100.0, 40.0, 140.0, 80.0], [0, 126.0, 66.0, 135.5, 71.5], [1, 31.5, 31.5, 32.5, 32.5],
], np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size,finest,max_ratio", [((7, 7), 4.0, 3), ((14, 14), 8.0, 2)])
def test_backward_on_tile_and_level_edges(cuda_device, dtype, out_size, finest, max_ratio):
    feats = _pyramid5(cuda_device, dtype, H=72, W=136, C=32, seed=8)
    rois = torch.from_numpy(TILE_EDGES).to(cuda_device)
    _check_backward(feats, rois, STRIDES5, out_size, finest, max_ratio, seed=8)
    _check_backward(feats, rois.repeat(30, 1), STRIDES5, out_size, finest, max_ratio, seed=9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_allocates_no_float32_pyramid(cuda_device, dtype):
    """One call's peak memory over what it returns is its index arrays and
    partial sums, far below a float32 copy of the pyramid."""
    feats = _pyramid5(cuda_device, dtype, H=256, W=512, C=256, seed=10)
    rois = _level_rois(cuda_device, n=200, H=256, W=512, seed=10)
    grad_out = _grad_out(feats, rois.shape[0], (7, 7), 10)
    n, mr = rois.shape[0], 3
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d_levels, d_rois = rc.roi_align_backward_kernel(
        feats, rois, grad_out, STRIDES5, (7, 7), 4.0, mr, ra.LONG_SPAN_CAP)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    returned = sum(d.numel() * d.element_size() for d in d_levels) + d_rois.numel() * 4
    split = rc.roi_align_backward_kernel.launch_shape(n, (7, 7))["split"]
    index = n * (14 * 2 * mr * 8 + 4 * 4 + 4 + 4) + (split + 3) * n * 5 * 4
    pyramid32 = sum(f.numel() for f in feats) * 4
    assert peak <= returned + index + 2 ** 20, (peak, returned, index)
    assert peak - returned < pyramid32 / 8


@pytest.mark.cuda
@pytest.mark.parametrize("out_size,finest,max_ratio", [((7, 7), 20.0, 6), ((14, 14), 28.0, 4),
                                                       ((7, 7), 4.0, 3)])
def test_backward_index_matches_plain(cuda_device, out_size, finest, max_ratio):
    """The kernel's index pass against ``roi_align.backward_index`` on the
    card: keys, buckets and rectangles equal; its tap lists those of
    ``merged_bin_taps`` (taps equal, weights to 1e-6)."""
    feats = _pyramid5(cuda_device, torch.bfloat16, H=384, W=1280, C=16, seed=11)
    rois = _level_rois(cuda_device, n=300, H=384, W=1280, seed=11)
    sizes = [(f.shape[1], f.shape[2]) for f in feats]
    ix = rc.roi_align_backward_kernel.index(feats, rois, STRIDES5, out_size, finest, max_ratio,
                                            ra.LONG_SPAN_CAP)
    ref = ra.backward_index(sizes, rois, STRIDES5, out_size, finest, max_ratio,
                            ra.LONG_SPAN_CAP, feats[0].shape[0])
    assert torch.equal(ix.keys.long(), ref.keys)
    assert torch.equal(ix.order.long(), ref.order)
    assert torch.equal(ix.offsets.long(), ref.offsets)
    assert torch.equal(ix.rects.long(), ref.rects)
    t = ra.merged_bin_taps(sizes, rois, STRIDES5, out_size, finest, max_ratio,
                           ra.LONG_SPAN_CAP)
    taps = torch.cat([t.rows, t.cols], 1).tolist()
    weights = torch.cat([t.row_w, t.col_w], 1).tolist()
    got_taps = ix.lists[..., 0].tolist()
    got_w = ix.lists[..., 1].view(torch.float32).tolist()
    for i in range(rois.shape[0]):
        for q in range(len(taps[i])):
            want = {a: w for a, w in zip(taps[i][q], weights[i][q]) if w != 0}
            got = {a: w for a, w in zip(got_taps[i][q], got_w[i][q]) if a >= 0}
            assert want.keys() == got.keys(), (i, q)
            assert all(abs(got[a] - want[a]) <= 1e-6 for a in want), (i, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_direct_route_is_differentiable(cuda_device, dtype):
    """The dispatcher's default route on tensors that require grad: one
    forward and one backward launch of the direct kernels, the gradients
    of the plain version's autograd; levels alone or RoIs alone too."""
    feats = [f.requires_grad_() for f in _pyramid5(cuda_device, dtype, seed=5)]
    rois = _level_rois(cuda_device, seed=5).requires_grad_()
    counts = (roi_align_kernel.launches, rc.roi_align_backward_kernel.launches)
    out = ra.multilevel_roi_align_auto(feats, rois, STRIDES5, (7, 7), 4.0, max_ratio=3)
    assert out.grad_fn is not None
    grad_out = torch.randn_like(out)
    grads = torch.autograd.grad(out, feats + [rois], grad_out)
    assert (roi_align_kernel.launches, rc.roi_align_backward_kernel.launches) == (
        counts[0] + 1, counts[1] + BACKWARD_LAUNCHES)
    ref_levels, ref_rois = _plain_grads(feats, rois, STRIDES5, (7, 7), 4.0, 3, grad_out)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    for got, ref in zip(grads[:-1], ref_levels):
        _grad_close(got, ref.to(dtype), rtol, 1e-5)
    _grad_close(grads[-1], ref_rois, 1e-4, 1e-4)
    for inputs in (feats, [rois]):
        out = ra.multilevel_roi_align_auto(
            [f if inputs is feats else f.detach() for f in feats],
            rois if inputs is not feats else rois.detach(), STRIDES5, (7, 7), 4.0,
            max_ratio=3)
        part = torch.autograd.grad(out, inputs, grad_out)
        tol = (rtol, 1e-5) if inputs is feats else (1e-4, 1e-4)
        for got, ref in zip(part, ref_levels if inputs is feats else [ref_rois]):
            _grad_close(got, ref.to(got.dtype), *tol)


@pytest.mark.cuda
def test_staged_routes_refuse_grad_on_cuda(cuda_device, monkeypatch):
    feats = [f.requires_grad_() for f in _pyramid(cuda_device, torch.bfloat16)]
    rois = _rois(cuda_device)
    monkeypatch.setenv("MONORUN_ALIGN_IMPL", "bandmm")
    with pytest.raises(RuntimeError, match="no backward"):
        ra.multilevel_roi_align_auto(feats, rois, STRIDES, (7, 7), 10.0, max_ratio=3)
    with torch.no_grad():
        ra.multilevel_roi_align_auto(feats, rois, STRIDES, (7, 7), 10.0, max_ratio=3)


def test_backward_wrapper_refuses_cpu_tensors():
    """Checks that run before any build or launch."""
    kernel = rc.RoIAlignBackwardKernel()
    feats = _pyramid5("cpu", torch.float32)
    rois = _level_rois("cpu")
    grad_out = torch.zeros((rois.shape[0], 7, 7, 32))
    with pytest.raises(ValueError, match="CUDA"):
        kernel(feats, rois, grad_out, STRIDES5, (7, 7), 4.0, 3, ra.LONG_SPAN_CAP)
    with pytest.raises(ValueError, match="CUDA"):
        rc.roi_align_direct(feats, rois, STRIDES5, (7, 7), 4.0, 3, ra.LONG_SPAN_CAP)
    assert kernel.launches == 0 and kernel._lib is None


# ---- the warm session (utils/warm_start.py) -----------------------------------


@pytest.mark.cuda
def test_warm_session_first_request_builds_nothing(cuda_device, monkeypatch, tmp_path):
    """A session warmed on the card in a fresh builds' root, at the tiny
    configuration of ``test_torch_cold_start.py``: the warm-up builds the
    direct kernel's library alone and launches it 3 times (its one
    forward), apart from the requests; the first request starts no
    ``nvcc``, launches it 3 times, and equals bit for bit an unwarmed
    session's request on the same weights, inputs and seed."""
    from monorun_tpu_torch.apis.inference import init_inference
    from monorun_tpu_torch.utils import compile_cache as cc
    from test_torch_cold_start import ALIGN_ENV, B, _request, tiny_config

    for name in ALIGN_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(cc, "_root", None)
    cc.enable_compilation_cache(tmp_path)
    monkeypatch.setattr(rc, "build_all", rc.KernelBuild())
    monkeypatch.setattr(roi_align_kernel, "_lib", None)
    cfg = tiny_config()
    request = _request(cfg, raw=False)

    before = roi_align_kernel.launches
    warm = init_inference(cfg, batch_size=B, device=cuda_device, seed=0)
    assert rc.build_all.built == ["roi_align"]
    assert list(rc.build_all.libs) == ["roi_align"]
    assert roi_align_kernel.launches - before == 3
    assert set(warm.warm_seconds) == {"build", "build_wait", "load", "forward"}

    before = roi_align_kernel.launches
    got = warm.run(*request, seed=4)
    torch.cuda.synchronize()
    assert rc.build_all.built == ["roi_align"]
    assert roi_align_kernel.launches - before == 3

    cold = init_inference(cfg, batch_size=B, device=cuda_device, seed=0, warm=False)
    assert cold.warm_seconds is None
    ref = cold.run(*request, seed=4)
    for name, a in ref._asdict().items():
        if name != "extras":
            assert torch.equal(a, getattr(got, name)), name
