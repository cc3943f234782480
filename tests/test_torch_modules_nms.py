"""``tests/test_torch_modules.py``'s NMS fixpoint against the exact NMS, in a
file of at most 3 tests (xdist hands it out late); that file states the
tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from monorun_tpu.ops import nms as jnms
from monorun_tpu_torch.ops import nms as tnms

from test_torch_modules import _chain, _t
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("exact,iters", [(True, 12), (False, 16), (False, 3)])
def test_nms_fixpoint_and_exact(exact, iters):
    boxes, scores = _chain()
    rng = np.random.default_rng(2)
    scores = scores[rng.permutation(len(scores))]
    scores[5] = jnms.NEG_INF                  # a padded slot
    jk = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.7, 30, exact, iters)
    tk = tnms.nms(_t(boxes), _t(scores), 0.7, 30, exact, iters)
    np.testing.assert_array_equal(tk[0].numpy(), np.asarray(jk[0]))
    np.testing.assert_array_equal(tk[1].numpy(), np.asarray(jk[1]))
