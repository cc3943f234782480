"""The port's profiling tools on the CPU, at the tiny configuration of
``test_torch_serve.py`` (ResNet-26, 64-wide neck, a 64x128 canvas):

- the stage ranges of ``utils/stages.py`` cover the whole serving forward
  in order, and a forward under either timer (the ladder's synchronised
  one, ``tools/profile_stages.py``, or ``record_function``,
  ``tools/profile_trace.py``) gives bit-equal detections to one without;
- ``tools/flop_budget.py``'s counts equal an exact count of the backbone's
  and the neck's convolutions (2 Cin Cout k^2 Hout Wout / groups a
  convolution);
- ``tools/profile_trace.py`` runs on the CPU profiler and its stage table
  sums to its total.

The ladder's stage coverage and the trace are in
``test_torch_profile_tools_trace.py``: files of at most 3 tests, which xdist
hands out late (ROADMAP's test-time budget).
"""

import dataclasses
import importlib

import pytest
import torch
from torch import nn

from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models.detector import MonoRUn
from monorun_tpu_torch.tools import flop_budget, profile_stages
from monorun_tpu_torch.utils import stages
from torch.profiler import record_function

from test_torch_serve import tiny_config
from torch_share import cpu_share  # noqa: F401

B = 2


@pytest.fixture(scope="module")
def served():
    cfg = tiny_config(tget_config)
    session = profile_stages.serving_session(cfg, B, "cpu")
    requests = profile_stages.canvases(cfg, B, 2, session.device)
    return cfg, session, requests


def test_stage_is_a_shared_null_context_without_a_timer(served):
    _, session, _ = served
    model, other = session.model, MonoRUn(session.cfg)
    assert model.stage_hook is None
    assert model.stage("pnp") is model.stage("noc_head") is stages.NULL
    seen = []
    with stages.timing(model, lambda name: seen.append(name) or stages.NULL):
        with model.stage("pnp"), other.stage("noc_head"):
            pass
    assert seen == ["pnp"] and model.stage_hook is None


def test_paired_split_is_the_median_of_each_forwards_own_ratio():
    """Hand-made records: three pairs whose ratios are 1.0, 1.1 and 0.5.
    The median of the pairs is 1.0, where the ratio of the medians taken
    apart (stage sums 10, 22, 30 over unsplit 10, 20, 60) is 22 / 20 = 1.1:
    a forward that ran slow beside a slow partner does not count as split
    time."""
    def records(*ms):
        return [dict(stage=f"s{i}", ms=m, launches={}) for i, m in enumerate(ms)]

    unsplit = [10.0, 20.0, 60.0]
    runs = [records(4.0, 6.0), records(12.0, 10.0), records(25.0, 5.0)]
    assert profile_stages.paired_split(unsplit, runs) == pytest.approx(1.0, rel=1e-12)
    assert profile_stages.paired_split(unsplit[:2], runs[:2]) == pytest.approx(1.05, rel=1e-12)
    with pytest.raises(ValueError):
        profile_stages.paired_split(unsplit, runs[:2])


@pytest.mark.parametrize("timer", ["ladder", "record_function"])
def test_timed_forward_is_bit_equal(served, timer):
    _, session, requests = served
    plain = session.run(*requests[1], seed=3)
    hook = (profile_stages.StageTimer(session.device) if timer == "ladder"
            else record_function)
    with stages.timing(session.model, hook):
        timed = session.run(*requests[1], seed=3)
    for name, want in plain._asdict().items():
        got = getattr(timed, name)
        if name == "extras":
            assert sorted(got) == sorted(want) and len(want) > 0
            assert all(torch.equal(got[k], want[k]) for k in want)
        else:
            assert torch.equal(got, want), name
    assert int(plain.valid.sum()) > 0
    if timer == "ladder":
        assert [r["stage"] for r in hook.records] == list(stages.STAGES)


def conv_flops(module: nn.Module, run) -> int:
    """2 Cin Cout k^2 Hout Wout / groups over every convolution ``run``
    calls in ``module``, from their output shapes."""
    total = 0

    def hook(conv, _, out):
        nonlocal total
        n, cout, h, w = out.shape
        kh, kw = conv.kernel_size
        total += 2 * n * (conv.in_channels // conv.groups) * cout * kh * kw * h * w

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, nn.Conv2d)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return total


def test_flop_budget_is_the_exact_convolution_count():
    tiny = tiny_config(tget_config)
    cfg = dataclasses.replace(tiny, neck=dataclasses.replace(tiny.neck, lazy_lower=False))
    assert flop_budget.budget_config("kitti_multiclass").neck.lazy_lower is False
    rows = flop_budget.flop_budget(cfg, B, "cpu")
    assert [r[0] for r in rows] == ["backbone", "backbone_fpn", "forward"]
    model = MonoRUn(cfg).eval()
    x = torch.zeros(B, cfg.data.pad_height, cfg.data.pad_width, 3)
    with torch.no_grad():
        backbone = conv_flops(model.backbone, lambda: model.backbone(x))
        torso = conv_flops(model, lambda: model.extract_feats(x))
    assert backbone > 0 and rows[0][1] == rows[0][2] == backbone
    assert rows[1][1] == torso and rows[1][2] == torso - backbone
    # the heads' fully connected layers and products come on top
    assert rows[2][1] > rows[1][1] and rows[2][2] == rows[2][1] - rows[1][1]
    # the dense stride-2 level costs its 3x3 convolution at four times the cells
    lazy = dataclasses.replace(cfg, neck=dataclasses.replace(cfg.neck, lazy_lower=True))
    lazy_model = MonoRUn(lazy).eval()
    with torch.no_grad():
        lazy_torso = conv_flops(lazy_model, lambda: lazy_model.extract_feats(x))
    c = cfg.neck.out_channels
    level0 = 2 * B * c * c * 9 * (cfg.data.pad_height // 4) * (cfg.data.pad_width // 4)
    assert torso - lazy_torso == 3 * level0


@pytest.mark.parametrize("tool", ["parity", "profile_stages", "flop_budget", "profile_trace"])
def test_tool_help(tool, capsys):
    mod = importlib.import_module(f"monorun_tpu_torch.tools.{tool}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0 and "--device" in capsys.readouterr().out
