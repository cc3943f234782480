"""``tests/test_torch_cold_start.py``'s warm start on the CPU, in a file of at
most 3 tests (xdist hands it out late); that file states the cases and the
tolerances.
"""

import math

import pytest
import torch

from monorun_tpu_torch.utils import warm_start as ws

from test_torch_cold_start import B, _request, _session, tiny_config
from torch_share import cpu_share  # noqa: F401


def test_warm_start_on_the_cpu_returns_its_pieces():
    cfg = tiny_config()
    sess = _session(cfg)
    outs = []
    sess.model.register_forward_hook(lambda m, args, out: outs.append(out))
    times = ws.warm_start(cfg, sess.model, B, "cpu")
    assert set(times) == {"build", "build_wait", "load", "forward"}
    assert all(math.isfinite(t) and t >= 0 for t in times.values())
    (det,) = outs
    assert det.bboxes_3d.shape == (B, cfg.test.max_per_img, 8)
    for name in ("bboxes_2d", "scores_2d", "bboxes_3d", "pose_cov"):
        assert torch.isfinite(getattr(det, name)).all(), name


@pytest.mark.parametrize("raw", [False, True])
def test_a_request_after_warm_start_is_bit_equal(raw):
    cfg = tiny_config()
    req = _request(cfg, raw)
    cold = _session(cfg, raw).run(*req, seed=4)
    sess = _session(cfg, raw)
    ws.warm_start(cfg, sess.model, B, "cpu", raw=raw)
    warm = sess.run(*req, seed=4)
    for name, a in cold._asdict().items():
        if name != "extras":
            assert torch.equal(a, getattr(warm, name)), name
