"""The staged RoIAlign variants of the port against the JAX package's.

The host halves of the four staged kernels (tile, band tiered, band
packed, band matmul) are held to the JAX code they port:
``prepare_flat_pyramid`` buffers exactly; ``roi_tile_geometry`` integer
fields exactly and Y, X to 1e-6; the band slots (every array the Pallas
call receives, captured by a stand-in for ``pallas_call``) exactly, and
their Y, X to 1e-6. Each kernel's plain version, run on the port's own
prepared slots, is held to the JAX Pallas kernel in interpret mode and to
the JAX gather oracle at rtol = atol = 2e-5 in float32 (summation order).
The CUDA kernels are held to these plain versions on the card in
``test_torch_cuda.py``.

Sizes: B=2, 64x128 image, C=32, 24 random RoIs plus the degenerate boxes
of ``test_torch_roi_align.py``.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorun_tpu.ops.roi_align_band as jband
import monorun_tpu.ops.roi_align_pallas as jtile
from monorun_tpu.ops import roi_align as jra
from monorun_tpu_torch.ops import roi_align as tra
from monorun_tpu_torch.ops import roi_align_band as tband
from monorun_tpu_torch.ops import roi_align_tile as ttile

from test_torch_roi_align import CAP, STRIDES, TOL, _interpret, _pyramid, _rois

CASES = [((7, 7), 10.0, 3), ((14, 14), 14.0, 2)]
MODES = {
    "plain": {},
    "tiered": dict(tiered=True),
    "packed": dict(packed=True),
    "matmul": dict(matmul=True),
}


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _capture(module):
    """A stand-in for ``pallas_call`` that records the kernel's inputs and
    returns zeros of its output shape."""
    captured = []

    def fake(kernel, *, out_shape, **kwargs):
        def run(*args):
            captured.append([np.asarray(a) for a in args])
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return run

    return mock.patch.object(module.pl, "pallas_call", fake), captured


@pytest.mark.parametrize("width", [128, 192])
def test_flat_pyramid_matches_jax(width):
    """Padded buffers, and at width 192 the zero-copy fast path of the
    32x96 level."""
    feats = _pyramid(W=width)
    tfeats = _t(feats)
    got = ttile.prepare_flat_pyramid(tfeats)
    bufs, sizes, B = jtile.prepare_flat_pyramid(_j(feats))
    assert got.sizes == sizes and got.batch == B
    assert len(got.bufs) == len(bufs) == 2 * len(feats)
    for a, b in zip(got.bufs, bufs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.shape[0] >= ttile.GUARD_ROWS
    # the 32x96 level is its own row-major buffer, without a copy
    zero_copy = got.bufs[0].data_ptr() == tfeats[0].data_ptr()
    assert zero_copy == (width == 192)


@pytest.mark.parametrize("row_window", [False, True])
@pytest.mark.parametrize("out_size,finest,max_ratio", CASES)
def test_tile_geometry_matches_jax(out_size, finest, max_ratio, row_window):
    rois = _rois()
    sizes = ttile.prepare_flat_pyramid(_t(_pyramid())).sizes
    got = ttile.roi_tile_geometry(torch.from_numpy(rois), sizes, STRIDES, out_size, finest,
                                  max_ratio, 32, 96, torch.float32, row_window=row_window)
    ref = jtile.roi_tile_geometry(jnp.asarray(rois), sizes, STRIDES, out_size, finest,
                                  max_ratio, 32, 96, jnp.float32, row_window=row_window)
    tmask, Y, X, r0, c0, nrb, ncb, buf_id = [np.asarray(a) for a in ref]
    np.testing.assert_array_equal(got.tmask.numpy(), tmask)
    for name, want in (("r0", r0), ("c0", c0), ("nrb", nrb), ("ncb", ncb),
                       ("buf_id", buf_id)):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want, err_msg=name)
    np.testing.assert_allclose(got.Y.numpy(), Y, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.X.numpy(), X, rtol=1e-6, atol=1e-6)
    assert tmask.any() and (~tmask).any()


def _band_inputs_ported(call):
    """The port's slots in the order the JAX Pallas call takes them."""
    if call.mode == "matmul":
        ints = (call.col0, call.blk_buf, call.blk_start, call.blk_po, call.blk_new,
                call.blk_slot, call.blk_act)
        Y = call.Y.reshape(-1, call.Y.shape[-1])
    else:
        ncb = call.blk_ncb if call.mode == "tiered" else call.ncb
        ints = (call.row0, call.col0, ncb, call.blk_buf, call.blk_start, call.blk_new,
                call.blk_slot)
        Y = call.Y
    return [t.numpy() for t in ints], Y.numpy(), call.X.numpy()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("out_size,finest,max_ratio", CASES)
def test_band_slots_match_jax(out_size, finest, max_ratio, mode):
    feats, rois = _pyramid(), _rois()
    call = tband.prepare_band_call(_t(feats), torch.from_numpy(rois), STRIDES, out_size,
                                   finest, max_ratio, kroi=4, **MODES[mode])
    assert call.mode == mode
    patch, captured = _capture(jband)
    with patch:
        jband.multilevel_roi_align_band(_j(feats), jnp.asarray(rois), STRIDES, out_size,
                                        finest, max_ratio=max_ratio, kroi=4, **MODES[mode])
    (args,) = captured
    nbufs = len(call.bufs)
    want_ints, want_bufs = args[:7], args[7:7 + nbufs]
    want_Y, want_X = args[7 + nbufs:]
    ints, Y, X = _band_inputs_ported(call)
    for i, (a, b) in enumerate(zip(ints, want_ints)):
        np.testing.assert_array_equal(a, b, err_msg=f"scalar-prefetch array {i}")
    for a, b in zip(call.bufs, want_bufs):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(Y, want_Y, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(X, want_X, rtol=1e-6, atol=1e-6)
    # every RoI has exactly one slot, and dummies have zero weights
    dst = call.dst.numpy()
    assert sorted(dst[dst >= 0].tolist()) == list(range(rois.shape[0]))
    assert not call.Y.numpy()[dst < 0].any() and not call.X.numpy()[dst < 0].any()


def test_packed_needs_whole_groups():
    """kroi % 4 != 0 falls back to the plain band sweep, as in JAX."""
    feats, rois = _pyramid(), _rois(n=8)
    call = tband.prepare_band_call(_t(feats), torch.from_numpy(rois), STRIDES, (7, 7),
                                   10.0, 3, kroi=2, packed=True)
    assert call.mode == "plain"
    call = tband.prepare_band_call(_t(feats), torch.from_numpy(rois), STRIDES, (7, 7),
                                   10.0, 3, kroi=4, packed=True, tiered=True)
    assert call.mode == "tiered"


@pytest.mark.parametrize("variant", ["tile", "plain", "tiered", "packed", "matmul"])
def test_plain_versions_match_pallas_kernels(variant):
    """Each staged kernel's plain version on the port's slots against the
    JAX Pallas kernel in interpret mode and the JAX gather oracle; the
    staged core's product (``union_product``) against the Pallas kernel."""
    feats, rois = _pyramid(), _rois()
    out_size, finest, max_ratio = (7, 7), 10.0, 3
    if variant == "tile":
        call = ttile.prepare_tile_call(_t(feats), torch.from_numpy(rois), STRIDES,
                                       out_size, finest, max_ratio)
        got = ttile.run_tile_call(call).numpy()
        with _interpret(jtile):
            ref = jtile.multilevel_roi_align_pallas(
                _j(feats), jnp.asarray(rois), STRIDES, out_size, finest,
                max_ratio=max_ratio, kroi=1)   # interpret mode: kroi=1 traces fastest
    else:
        call = tband.prepare_band_call(_t(feats), torch.from_numpy(rois), STRIDES,
                                       out_size, finest, max_ratio, kroi=4,
                                       **MODES[variant])
        got = tband.run_band_call(call).numpy()
        with _interpret(jband):
            ref = jband.multilevel_roi_align_band(
                _j(feats), jnp.asarray(rois), STRIDES, out_size, finest,
                max_ratio=max_ratio, kroi=4, **MODES[variant])
    oracle = jra.multilevel_roi_align(_j(feats), jnp.asarray(rois), STRIDES, out_size,
                                      finest, sampling_ratio=0, max_ratio=max_ratio,
                                      long_span_cap=CAP)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    if variant != "plain":
        # the staged core's product (csrc/roi_align_ring.cuh) on the same slots
        np.testing.assert_allclose(tband.union_product(call).numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("out_size,finest,max_ratio", CASES)
def test_band_variants_match_gather(out_size, finest, max_ratio):
    """Every band mode and the tile version through the public functions
    (plain versions on the CPU) against the port's gather version, and the
    bfloat16 row product of the matmul variant within one rounding of t1."""
    feats, rois = _t(_pyramid()), torch.from_numpy(_rois(seed=4))
    ref = tra.multilevel_roi_align(feats, rois, STRIDES, out_size, finest,
                                   max_ratio=max_ratio, long_span_cap=CAP)
    for mode, kw in MODES.items():
        got = tband.multilevel_roi_align_band(feats, rois, STRIDES, out_size, finest,
                                              max_ratio=max_ratio, kroi=4, **kw)
        torch.testing.assert_close(got, ref, **TOL, msg=mode)
    got = ttile.multilevel_roi_align_tile(feats, rois, STRIDES, out_size, finest, max_ratio)
    torch.testing.assert_close(got, ref, **TOL)
    # t1 in bfloat16: |t1| <= max|x| and the X weights of a row sum to at
    # most 1, so one rounding of t1 moves the output by <= 2^-8 max|x|
    got = tband.multilevel_roi_align_band(feats, rois, STRIDES, out_size, finest,
                                          max_ratio=max_ratio, kroi=4, matmul=True,
                                          t1_dtype=torch.bfloat16)
    bound = 2 ** -8 * max(float(f.abs().max()) for f in feats)
    assert float((got - ref).abs().max()) <= bound


@pytest.mark.parametrize("round_weights", [False, True])
def test_tiled_matches_jax_tiled(round_weights):
    """The plain separable version against the JAX one (float32, where
    rounding the weights to the features' dtype changes nothing), and
    against the gather version without the span cap."""
    feats, rois = _pyramid(), _rois(seed=2)
    got = tra.multilevel_roi_align_tiled(_t(feats), torch.from_numpy(rois), STRIDES,
                                         (7, 7), 10.0, max_ratio=3, tile_hw=(24, 44),
                                         round_weights=round_weights)
    ref = jra.multilevel_roi_align_tiled(_j(feats), jnp.asarray(rois), STRIDES, (7, 7),
                                         10.0, max_ratio=3, tile_hw=(24, 44))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # ordinary boxes (no slivers) are covered by a 24x44 tile at their level
    ok = np.arange(24)
    gather = tra.multilevel_roi_align(_t(feats), torch.from_numpy(rois[ok]), STRIDES,
                                      (7, 7), 10.0, max_ratio=3)
    torch.testing.assert_close(got[ok], gather, **TOL)


def _choice(monkeypatch, env, n=8000, dtype=torch.bfloat16, cuda=True):
    for name in ("MONORUN_ALIGN_IMPL", "MONORUN_BAND_TIERED", "MONORUN_BAND_MATMUL",
                 "MONORUN_BAND_KROI", "MONORUN_BAND_T1_BF16"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return tuple(tra.align_choice(n, dtype, cuda))


@pytest.mark.parametrize("env,n,dtype,want", [
    ({}, 8000, torch.bfloat16, ("kernel", 0, None)),
    ({}, 384, torch.bfloat16, ("kernel", 0, None)),
    ({}, 8000, torch.float32, ("kernel", 0, None)),
    ({"MONORUN_ALIGN_IMPL": "gather"}, 8000, torch.bfloat16, ("gather", 0, None)),
    ({"MONORUN_ALIGN_IMPL": "sorted", "MONORUN_BAND_TIERED": "1"}, 8000, torch.bfloat16,
     ("kernel", 0, None)),
    ({"MONORUN_ALIGN_IMPL": "band"}, 384, torch.bfloat16, ("kernel", 0, None)),
    ({"MONORUN_ALIGN_IMPL": "band", "MONORUN_BAND_TIERED": "1"}, 384, torch.float32,
     ("tiered", 4, None)),
    ({"MONORUN_BAND_TIERED": "1"}, 8000, torch.bfloat16, ("tiered", 4, None)),
    ({"MONORUN_BAND_TIERED": "1"}, 384, torch.bfloat16, ("kernel", 0, None)),
    ({"MONORUN_BAND_TIERED": "1", "MONORUN_BAND_KROI": "8"}, 8000, torch.bfloat16,
     ("tiered", 8, None)),
    ({"MONORUN_ALIGN_IMPL": "bandmm"}, 384, torch.bfloat16, ("bandmm", 16, None)),
    ({"MONORUN_ALIGN_IMPL": "bandmm", "MONORUN_BAND_T1_BF16": "1",
      "MONORUN_BAND_TIERED": "1"}, 8000, torch.bfloat16, ("bandmm", 16, torch.bfloat16)),
    ({"MONORUN_BAND_MATMUL": "1"}, 8000, torch.bfloat16, ("bandmm", 16, None)),
    ({"MONORUN_ALIGN_IMPL": "band", "MONORUN_BAND_MATMUL": "1"}, 8000, torch.bfloat16,
     ("kernel", 0, None)),
])
def test_dispatch_table(monkeypatch, env, n, dtype, want):
    assert _choice(monkeypatch, env, n, dtype) == want
    # off CUDA every setting runs the plain gather version
    assert _choice(monkeypatch, env, n, dtype, cuda=False)[0] == "gather"


def test_dispatch_on_cpu_and_pyramid(monkeypatch):
    feats = _t(_pyramid())
    rois = torch.from_numpy(_rois())
    plain = tra.multilevel_roi_align(feats, rois, STRIDES, (7, 7), 10.0, max_ratio=3,
                                     long_span_cap=CAP)
    for impl in tra.ALIGN_IMPLS:
        _choice(monkeypatch, {"MONORUN_ALIGN_IMPL": impl, "MONORUN_BAND_TIERED": "1"})
        assert tra.prepare_pyramid(feats) is None
        got = tra.multilevel_roi_align_auto(feats, rois, STRIDES, (7, 7), 10.0,
                                            max_ratio=3, tile_h=24)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
    monkeypatch.setenv("MONORUN_ALIGN_IMPL", "nonsense")
    with pytest.raises(ValueError, match="MONORUN_ALIGN_IMPL"):
        tra.multilevel_roi_align_auto(feats, rois, STRIDES, (7, 7), 10.0)


def test_lazy_level_slivers_overrun_the_tile():
    """With the lazy lower level the align strides are (4, 4, 8, 16): the
    span cap assumes stride 4 * 2^level, so a sliver at level 1 (stride 4)
    can span more than the 96-column tile. The port's staged version drops
    the taps beyond the window exactly as the JAX band kernel does (an
    inherited fault of the reference, flagged by ``fits``), and agrees with
    the gather version on every RoI that fits."""
    strides = (4, 4, 8, 16)
    feats = [np.random.default_rng(l).normal(size=(2, 128 // s, 512 // s, 32))
             .astype(np.float32) for l, s in enumerate(strides)]
    rois = np.concatenate([_rois(n=8, W=512, H=128, seed=6), np.array(
        [[0, 10.0, 50.0, 480.0, 60.0], [1, 20.0, 30.0, 420.0, 42.0]], np.float32)])
    args = (strides, (7, 7), 20.0)
    geo = ttile.roi_tile_geometry(torch.from_numpy(rois), [f.shape[1:3] for f in feats],
                                  strides, (7, 7), 20.0, 6, 32, 96, torch.float32)
    fits = geo.fits.numpy()
    assert fits[:-2].all() and not fits[-2:].any()
    got = tband.multilevel_roi_align_band(_t(feats), torch.from_numpy(rois), *args,
                                          max_ratio=6, kroi=4).numpy()
    with _interpret(jband):
        ref = jband.multilevel_roi_align_band(_j(feats), jnp.asarray(rois), *args,
                                              max_ratio=6, kroi=4)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    gather = tra.multilevel_roi_align(_t(feats), torch.from_numpy(rois), *args, max_ratio=6,
                                      long_span_cap=CAP).numpy()
    np.testing.assert_allclose(got[fits], gather[fits], **TOL)
    assert np.abs(got[~fits] - gather[~fits]).max() > 0.1


@pytest.mark.parametrize("out_size,finest,max_ratio", CASES)
def test_tiered_union_product_matches_plain_and_pallas(out_size, finest, max_ratio):
    """The staged core's zero-extended union-row product (``union_product``)
    on a tiered call, stated in plain PyTorch, against the plain version on
    the same slots and the JAX tiered Pallas kernel in interpret mode; its
    blocks reach past one slot's rows, so the zero extension is exercised."""
    feats, rois = _pyramid(), _rois()
    call = tband.prepare_band_call(_t(feats), torch.from_numpy(rois), STRIDES, out_size,
                                   finest, max_ratio, kroi=4, tiered=True)
    real = call.dst.view(-1, 4) >= 0
    rw0 = call.row0.view(-1, 4)
    assert max(int(r[m].max() - r[m].min()) for r, m in zip(rw0, real) if m.any()) > 0
    got = tband.union_product(call).numpy()
    np.testing.assert_allclose(got, tband.band_call_plain(call).numpy(), **TOL)
    with _interpret(jband):
        ref = jband.multilevel_roi_align_band(_j(feats), jnp.asarray(rois), STRIDES, out_size,
                                              finest, max_ratio=max_ratio, kroi=4, tiered=True)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# two narrow and two wide RoIs in one band of level 0 (a packed group of
# tiers 1, 1, 3, 3) and a tall RoI, on one 128x512 image
MIXED_TIERS = np.array([[0, 20.0, 40.0, 40.0, 46.0], [0, 50.0, 42.0, 62.0, 47.0],
                        [0, 100.0, 40.0, 390.0, 44.0], [0, 120.0, 41.0, 400.0, 45.0],
                        [0, 450.0, 10.0, 456.0, 70.0]], np.float32)


def test_packed_union_product_takes_each_slots_own_tier():
    """The staged core's product with per-slot windows (``union_product``)
    on a packed group of tiers 1, 1, 3, 3: each slot takes its own tier,
    where the JAX packed kernel computes the group at its widest (the
    plain version's whole window, held to that kernel in
    ``test_plain_versions_match_pallas_kernels``). Against the plain
    version on the same slots and the gather version."""
    strides = (4, 4, 8, 16)      # the lazy lower level
    feats = _t(_pyramid(B=1, H=128, W=512, strides=strides))
    rois = torch.from_numpy(MIXED_TIERS)
    args = (strides, (7, 7), 20.0)
    call = tband.prepare_band_call(feats, rois, *args, 6, kroi=4, packed=True)
    groups = call.ncb.view(-1, 4)[(call.dst.view(-1, 4) >= 0).all(1)]
    assert ((groups.amin(1) == 1) & (groups.amax(1) == 3)).any()
    got = tband.union_product(call)
    torch.testing.assert_close(got, tband.band_call_plain(call), **TOL)
    gather = tra.multilevel_roi_align(feats, rois, *args, max_ratio=6, long_span_cap=CAP)
    torch.testing.assert_close(got, gather, **TOL)
