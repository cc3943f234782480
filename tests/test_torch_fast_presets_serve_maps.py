"""The fast presets' ``_fast2`` and ``_fast3_r50`` rungs served by the port:
the no-CARAFE maps and the align switch in the served forward, in a file of
at most 3 tests, which xdist hands out late. JAX serves each rung once per
test run (``test_torch_fast_presets.py:serve_jax``), for the draws.
"""

import pytest

from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models.detector import MonoRUn

from test_torch_fast_presets import B, RUNGS, serve_rungs, tiny_rung
from torch_share import cpu_share  # noqa: F401


@pytest.fixture(scope="module")
def served():
    return serve_rungs(("fast2", "fast3_r50"))


def test_no_carafe_rung_serves_roi_sized_maps(served):
    """dense_size == roi_size: no CARAFE, 14x14 NOC and uncertainty maps in
    every slot, and so a 196-point PnP (its RANSAC keys, JAX's, are 196
    wide)."""
    for case, rung in (("fast2", "fast2"), ("fast3_r50_at", "fast3_r50")):
        cfg = tiny_rung(tget_config, rung)
        assert MonoRUn(cfg).roi_head.noc_head.upsample is None
        tdet = served[case][1]
        M = cfg.test.max_per_img
        assert tdet.extras["oc_maps"].shape == (B, M, 14, 14, 3), case
        assert tdet.extras["std_maps"].shape == (B, M, 14, 14, 2), case


def test_proposal_align_at_and_below_the_switch(served):
    """The port's dispatch in the served forward: the proposal align
    counts B x proposals RoIs, takes the band route at the switch and the
    sorted one just below it; the detection aligns (B x head slots) never
    do. Both runs give JAX's detections (test above)."""
    n = B * RUNGS["fast3_r50"]["proposals"]
    slots = B * RUNGS["fast3_r50"]["slots"]
    at, below = served["fast3_r50_at"][2], served["fast3_r50_below"][2]
    assert [c[0] for c in at] == [n, slots, slots] == [c[0] for c in below]
    assert [c[1] for c in at] == ["tiered", "kernel", "kernel"]
    assert [c[1] for c in below] == ["kernel", "kernel", "kernel"]
