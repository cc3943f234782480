"""``tests/test_torch_modules.py``'s rotated IoU with the BEV NMS, and the NMS
on a deep chain, in a file of at most 3 tests (xdist hands it out late); that
file states the tolerances.
"""

import jax.numpy as jnp
import numpy as np

from monorun_tpu.ops import nms as jnms
from monorun_tpu.ops import rotated_iou as jriou
from monorun_tpu_torch.ops import nms as tnms
from monorun_tpu_torch.ops import rotated_iou as triou

from test_torch_modules import _chain, _close, _t
from torch_share import cpu_share  # noqa: F401


def test_rotated_iou_and_bev_nms():
    rng = np.random.default_rng(4)
    n = 24
    bev = np.concatenate([
        rng.uniform(-5, 5, (n, 2)), rng.uniform(1, 4, (n, 2)),
        rng.uniform(-np.pi, np.pi, (n, 1)),
    ], 1).astype(np.float32)
    bev[3] = bev[2]                           # identical boxes
    _close(triou.rotated_iou(_t(bev), _t(bev)),
           jriou.rotated_iou(jnp.asarray(bev), jnp.asarray(bev)), rtol=1e-4)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    ref = jnms.nms_rotated_bev(jnp.asarray(bev), jnp.asarray(scores), 0.1, n,
                               exact=False, fixpoint_iters=n)
    got = tnms.nms_rotated_bev(_t(bev), _t(scores), 0.1, n, exact=False,
                               fixpoint_iters=n)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_nms_deep_chain_keeps_the_fixpoint_extras():
    """On a chain deeper than 16 the RPN's 16-round fixpoint keeps more
    boxes than greedy NMS; the port keeps exactly the same extra boxes."""
    boxes, scores = _chain(n=48, step=0.9)
    fix = tnms.nms(_t(boxes), _t(scores), 0.75, 48, exact=False, fixpoint_iters=16)
    greedy = tnms.nms(_t(boxes), _t(scores), 0.75, 48, exact=True)
    assert fix[1].sum() > greedy[1].sum()
    jfix = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.75, 48,
                    exact=False, fixpoint_iters=16)
    np.testing.assert_array_equal(fix[0].numpy(), np.asarray(jfix[0]))
    np.testing.assert_array_equal(fix[1].numpy(), np.asarray(jfix[1]))
