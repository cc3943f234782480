"""The align's gradient: the port's plain ``multilevel_roi_align`` under
``torch.autograd.grad`` against ``jax.grad`` of
``monorun_tpu/ops/roi_align.py:multilevel_roi_align``, in float32, with
respect to the levels and to the RoIs; and the routes that have no
backward refuse inputs that require grad.

A five-level lazy pyramid (strides 4, 4, 8, 16, 32), RoIs on every level,
slivers, RoIs running off the map, samples on the last row and column and
samples exactly on a map edge (where the clamp's gradient is 1/2, as
``jnp.clip`` gives it), at 7x7 and 14x14.

Tolerance: 1e-5 of each gradient's largest entry, the summation order of
the scatter into the levels and of the RoI gradient's sums.

The plain gradients against ``jax.grad`` are in
``test_torch_roi_align_grad_{7x7,14x14}_{fine,coarse}.py``, a case each: files
of at most 3 tests, which xdist hands out late (ROADMAP's test-time budget).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu.ops import roi_align as jra
from monorun_tpu_torch.ops import roi_align as ra
from monorun_tpu_torch.ops import roi_align_band as rb
from monorun_tpu_torch.ops import roi_align_cuda as rc
from monorun_tpu_torch.ops import roi_align_tile as rt

from torch_share import cpu_share  # noqa: F401

STRIDES = (4, 4, 8, 16, 32)
B, H, W, C = 2, 64, 128, 8
EDGES = np.array(
    [
        [0, 0.0, 0.0, 28.0, 28.0],      # the first sample of each axis at 0 (finest 20)
        [1, 100.0, 36.0, 128.0, 64.0],  # the last row and column: samples at H-1 and past it
        [0, 0.0, 0.0, 0.0, 0.0],        # zero-size padded slot
        [1, 2.0, 60.0, 126.0, 63.0],    # bottom sliver, moved by the span cap
        [0, -30.0, -20.0, 40.0, 30.0],  # past the map: samples below -1
        [1, 120.0, 58.0, 140.0, 70.0],  # past the far corner
        [0, 5.0, 5.0, 6.5, 6.0],        # tiny box
        [1, 1.0, 1.0, 127.0, 63.0],     # the whole image, the coarsest levels
    ],
    np.float32,
)


# test_plain_gradients_match_jax_grad's cases, with the ids pytest gives the
# tuples, one case a file (test_torch_roi_align_grad_*.py)
GRAD_CASES = [pytest.param(out, finest, ratio, id=f"out_size{i}-{finest}-{ratio}")
              for i, (out, finest, ratio) in enumerate(
                  [((7, 7), 4.0, 3), ((7, 7), 20.0, 3), ((14, 14), 4.0, 2),
                   ((14, 14), 28.0, 2)])]


def _inputs(seed, n=40):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(B, H // s, W // s, C)).astype(np.float32) for s in STRIDES]
    side = 2.0 * 60.0 ** rng.uniform(0, 1, n)
    aspect = 4.0 ** rng.uniform(-1, 1, n)
    x1, y1 = rng.uniform(-6, W - 2, n), rng.uniform(-6, H - 2, n)
    rand = np.stack([rng.integers(0, B, n), x1, y1, x1 + side * np.sqrt(aspect),
                     y1 + side / np.sqrt(aspect)], 1).astype(np.float32)
    return feats, np.concatenate([rand, EDGES])


def _jax_grads(feats, rois, out_size, finest, max_ratio, cap, grad_out):
    def f(fs, r):
        out = jra.multilevel_roi_align(fs, r, STRIDES, out_size, finest,
                                       max_ratio=max_ratio, long_span_cap=cap)
        return jnp.sum(out * grad_out)

    gf, gr = jax.jit(jax.grad(f, argnums=(0, 1)))([jnp.asarray(x) for x in feats],
                                                   jnp.asarray(rois))
    return [np.asarray(g) for g in gf], np.asarray(gr)


def _torch_grads(feats, rois, out_size, finest, max_ratio, cap, grad_out):
    tf = [torch.tensor(x, requires_grad=True) for x in feats]
    tr = torch.tensor(rois, requires_grad=True)
    out = ra.multilevel_roi_align(tf, tr, STRIDES, out_size, finest, max_ratio=max_ratio,
                                  long_span_cap=cap)
    grads = torch.autograd.grad(out, tf + [tr], torch.from_numpy(grad_out))
    return [g.numpy() for g in grads[:-1]], grads[-1].numpy()


def _close(got, ref, rtol=1e-5):
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def check_plain_gradients(seed, out_size, finest, max_ratio):
    """``test_plain_gradients_match_jax_grad``."""
    feats, rois = _inputs(seed)
    rng = np.random.default_rng(100 + seed)
    grad_out = rng.normal(size=(rois.shape[0],) + out_size + (C,)).astype(np.float32)
    cap = ra.LONG_SPAN_CAP
    jf, jr = _jax_grads(feats, rois, out_size, finest, max_ratio, cap, grad_out)
    tf, tr = _torch_grads(feats, rois, out_size, finest, max_ratio, cap, grad_out)
    for got, ref in zip(tf, jf):
        _close(got, ref)
    _close(tr, jr)
    assert not tr[:, 0].any() and np.abs(jr).max() > 0
    if finest == 4.0:
        assert all(np.abs(g).max() > 0 for g in jf)   # every level takes gradient


def test_edge_samples_take_half_the_clamp_gradient():
    """A sample exactly on the map's first row and column: jnp.clip passes
    half the gradient there, and so does the port."""
    feats, _ = _inputs(3)
    rois = EDGES[:1]      # level 0 at finest scale 20: bins of one cell from -0.5
    assert int(ra.assign_fpn_levels(torch.from_numpy(rois), 5, 20.0)[0]) == 0
    grad_out = np.ones((1, 7, 7, C), np.float32)
    jf, jr = _jax_grads(feats, rois, (7, 7), 20.0, 3, None, grad_out)
    tf, tr = _torch_grads(feats, rois, (7, 7), 20.0, 3, None, grad_out)
    for got, ref in zip(tf, jf):
        _close(got, ref)
    _close(tr, jr)
    # the whole gradient a hair inside the edge: the first row's and
    # column's share of the x1/y1 gradient doubles
    nudged = rois + np.array([[0, 1e-4, 1e-4, 0, 0]], np.float32)
    _, tr2 = _torch_grads(feats, nudged, (7, 7), 20.0, 3, None, grad_out)
    assert np.abs(tr2[0, 1:3] - tr[0, 1:3]).max() > 1e-2 * np.abs(tr[0, 1:3]).max()


def test_staged_routes_refuse_grad():
    """The band and tile routes have no backward: under grad, with levels or
    RoIs that require it, they raise instead of returning an output without
    a gradient; without grad they run."""
    feats, rois = _inputs(4)
    tf = [torch.tensor(x, requires_grad=True) for x in feats[:4]]
    tr = torch.from_numpy(rois)
    strides = STRIDES[:4]
    with pytest.raises(RuntimeError, match="no backward"):
        rb.multilevel_roi_align_band(tf, tr, strides, (7, 7), 20.0, tiered=True, kroi=4)
    with pytest.raises(RuntimeError, match="no backward"):
        rt.multilevel_roi_align_tile(tf, tr, strides, (7, 7), 20.0)
    with pytest.raises(RuntimeError, match="no backward"):
        rt.multilevel_roi_align_tile([t.detach() for t in tf], tr.requires_grad_(), strides,
                                     (7, 7), 20.0)
    with torch.no_grad():
        out = rt.multilevel_roi_align_tile(tf, tr, strides, (7, 7), 20.0)
    assert out.grad_fn is None and out.shape == (rois.shape[0], 7, 7, C)


@pytest.mark.parametrize("impl", ["auto", "sorted", "band", "bandmm"])
def test_cpu_dispatch_is_the_differentiable_gather(impl, monkeypatch):
    """Off CUDA every align setting runs the plain gather version, so a
    staged route cannot be reached with grad on the CPU."""
    monkeypatch.setenv("MONORUN_ALIGN_IMPL", impl)
    monkeypatch.setenv("MONORUN_BAND_TIERED", "1")
    assert ra.align_choice(2048, torch.bfloat16, on_cuda=False).impl == "gather"
    feats, rois = _inputs(5)
    tf = [torch.tensor(x, requires_grad=True) for x in feats]
    tr = torch.tensor(rois, requires_grad=True)
    out = ra.multilevel_roi_align_auto(tf, tr, STRIDES, (7, 7), 4.0, max_ratio=3)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.sum(), tf + [tr])
    assert all(g is not None for g in grads)


def test_kernel_route_refuses_cpu_tensors():
    feats, rois = _inputs(6)
    tf = [torch.tensor(x, requires_grad=True) for x in feats]
    with pytest.raises(ValueError, match="CUDA"):
        rc.roi_align_direct(tf, torch.from_numpy(rois), STRIDES, (7, 7), 4.0, 3,
                            ra.LONG_SPAN_CAP)
    with pytest.raises(ValueError, match="CUDA"):
        rc.RoIAlignBackwardKernel()(tf, torch.from_numpy(rois),
                                    torch.zeros(rois.shape[0], 7, 7, C), STRIDES, (7, 7),
                                    4.0, 3, ra.LONG_SPAN_CAP)
