"""``tests/test_torch_profile_tools.py``'s stage coverage of the ladder and the
trace's stage table, in a file of at most 3 tests (xdist hands it out late);
that file states the cases and the tolerances.
"""

import pytest

from monorun_tpu_torch.tools import profile_stages, profile_trace
from monorun_tpu_torch.utils import stages

from test_torch_profile_tools import served  # noqa: F401
from torch_share import cpu_share  # noqa: F401


def test_stages_cover_the_forward_in_order(served):  # noqa: F811
    _, session, requests = served
    result = profile_stages.ladder(session, requests, forwards=2, warmup=1)
    for records in result["forward_records"]:
        assert [r["stage"] for r in records] == list(stages.STAGES)
        assert all(r["ms"] > 0 and r["launches"] == {} for r in records)
    assert [s["stage"] for s in result["stages"]] == list(stages.STAGES)
    assert result["stage_sum_ms"] == pytest.approx(sum(s["ms"] for s in result["stages"]))
    assert result["unsplit_ms"] > 0 and len(result["unsplit_ms_each"]) == 2
    assert result["paired_split"] == profile_stages.paired_split(
        result["unsplit_ms_each"], result["forward_records"])


def test_profile_trace_stage_table_sums_to_its_total(served, tmp_path):  # noqa: F811
    _, session, requests = served
    table = tmp_path / "trace.txt"
    result = profile_trace.trace_forwards(session, requests, forwards=2, top_n=5, table=table)
    rows = result["stages"]
    assert [r["stage"] for r in rows] == [*stages.STAGES, profile_trace.OUTSIDE]
    assert result["stage_ranges"] == 2 * len(stages.STAGES)
    assert sum(r["ms"] for r in rows) == pytest.approx(result["ms_per_forward"], rel=1e-9)
    assert sum(r["launches"] for r in rows) == pytest.approx(result["launches_per_forward"])
    assert sum(r["share"] for r in rows) == pytest.approx(1.0)
    assert all(r["ms"] > 0 and r["launches"] > 0 for r in rows[:-1])
    assert result["covered_share"] > 0.9 and result["idle_share"] is None
    assert len(result["top"]) == 5 and "aten::" in table.read_text()
