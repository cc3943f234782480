"""The public functions of ``ops/rotated_iou.py`` and ``ops/linalg_small.py``
that the port's forward and training step do not call, held to the JAX
package's on seeded inputs in float32.

Tolerances: the IoUs to 1e-5 absolute (the intersection polygon's
shoelace sums in float32 on boxes of side up to 4; both packages run
the same construction in the same order), the small-matrix functions to
1e-4 relative (an unrolled Cholesky of a 5x5 SPD matrix with a condition
number up to about 1e3, float32).

The IoUs' cases are in files of at most 3 tests, which xdist hands out
late (ROADMAP's test-time budget): the aligned rotated IoU in
``test_torch_small_ops_rotated.py`` (its last criterion in
``test_torch_small_ops_iou3d.py``), the 3D overlaps and the
dimension-only IoU in ``test_torch_small_ops_iou3d.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu.ops import linalg_small as jla
from monorun_tpu.ops import rotated_iou as jri
from monorun_tpu_torch.ops import linalg_small as tla
from monorun_tpu_torch.ops import rotated_iou as tri

from torch_share import cpu_share  # noqa: F401

IOU_ATOL = 1e-5
LINALG_RTOL = 1e-4


def _rects(rng, n):
    """(n, 5) BEV rectangles: centre, sides 0.5..4, angle."""
    return np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                     rng.uniform(0.5, 4, n), rng.uniform(0.5, 4, n),
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def _boxes7(rng, n):
    """(n, 7) camera-frame boxes [x, y, z, l, h, w, ry] that often overlap."""
    return np.stack([rng.uniform(-2, 2, n), rng.uniform(0.5, 2, n), rng.uniform(8, 12, n),
                     rng.uniform(3, 4.5, n), rng.uniform(1.4, 1.8, n), rng.uniform(1.5, 1.9, n),
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def _close(got, ref, atol=0.0, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def check_rotated_iou_aligned(criterion):
    """``test_rotated_iou_aligned_matches_jax``."""
    rng = np.random.default_rng(criterion + 1)
    a, b = _rects(rng, 64), _rects(rng, 64)
    b[:8] = a[:8]                                 # identical pairs: IoU 1
    b[8:16, :2] = a[8:16, :2]                     # co-centred, other sides and angle
    got = tri.rotated_iou_aligned(torch.from_numpy(a), torch.from_numpy(b), criterion)
    ref = jri.rotated_iou_aligned(jnp.asarray(a), jnp.asarray(b), criterion)
    _close(got, ref, atol=IOU_ATOL)
    assert got.shape == (64,) and bool((got > 0).any())


def _spd(rng, batch, n):
    m = rng.normal(0, 1, (batch, n, n)).astype(np.float32)
    return (m @ m.transpose(0, 2, 1) + 0.5 * n * np.eye(n, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("n", [3, 4, 5])
def test_cholesky_and_solves_match_jax(n):
    rng = np.random.default_rng(n)
    a = _spd(rng, 16, n)
    b = rng.normal(0, 1, (16, n)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)

    l_t = tla.cholesky_unrolled(ta)
    _close(l_t, jla.cholesky_unrolled(ja), atol=1e-6, rtol=LINALG_RTOL)
    assert bool((torch.triu(l_t, 1) == 0).all())
    torch.testing.assert_close(l_t @ l_t.transpose(-1, -2), ta, rtol=LINALG_RTOL, atol=1e-4)

    _close(tla.cho_solve(l_t, tb), jla.cho_solve(jla.cholesky_unrolled(ja), jb),
           atol=1e-6, rtol=LINALG_RTOL)
    x = tla.spd_solve(ta, tb)
    _close(x, jla.spd_solve(ja, jb), atol=1e-6, rtol=LINALG_RTOL)
    torch.testing.assert_close((ta @ x[..., None])[..., 0], tb, rtol=LINALG_RTOL, atol=1e-4)

    logdet = tla.slogdet_spd(ta)
    _close(logdet, jla.slogdet_spd(ja), atol=1e-5, rtol=LINALG_RTOL)
    np.testing.assert_allclose(logdet.numpy(), np.linalg.slogdet(a.astype(np.float64))[1],
                               rtol=LINALG_RTOL, atol=1e-4)
