"""``tests/test_torch_small_ops.py``'s 3D overlaps, the dimension-only IoU and
the aligned rotated IoU's last criterion, in a file of at most 3 tests (xdist
hands it out late); that file states the cases and the tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu.ops import rotated_iou as jri
from monorun_tpu_torch.ops import rotated_iou as tri

from test_torch_small_ops import IOU_ATOL, _boxes7, _close, check_rotated_iou_aligned
from torch_share import cpu_share  # noqa: F401


def test_bbox3d_overlaps_matches_jax():
    rng = np.random.default_rng(7)
    a, b = _boxes7(rng, 6), _boxes7(rng, 9)
    b[:3] = a[:3]
    got = tri.bbox3d_overlaps(torch.from_numpy(a), torch.from_numpy(b))
    ref = jri.bbox3d_overlaps(jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (6, 9)
    _close(got, ref, atol=IOU_ATOL)
    np.testing.assert_allclose(np.diag(got.numpy()[:3, :3]), 1.0, atol=IOU_ATOL)


def test_dimonly_iou_aligned_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(0.5, 4.5, (32, 3)).astype(np.float32)
    b = rng.uniform(0.5, 4.5, (32, 3)).astype(np.float32)
    got = tri.dimonly_iou_aligned(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, jri.dimonly_iou_aligned(jnp.asarray(a), jnp.asarray(b)), atol=IOU_ATOL)


@pytest.mark.parametrize("criterion", [2])
def test_rotated_iou_aligned_matches_jax(criterion):
    check_rotated_iou_aligned(criterion)
