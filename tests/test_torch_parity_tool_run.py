"""``tests/test_torch_parity_tool.py``'s whole parity run against JAX's tool,
in a file of at most 3 tests (xdist hands it out late); that file states the
cases and the tolerances.
"""

from pathlib import Path

import numpy as np

from test_torch_eval_path import _self_labelled, assert_result_files_close
from test_torch_parity_tool import (  # noqa: F401
    assert_summaries_equal, run_jax_tool, run_port_tool, world,
)
from torch_share import cpu_share  # noqa: F401


def test_parity_tool_matches_jax(world, tmp_path, monkeypatch, capsys):  # noqa: F811
    """Both tools on the mini-KITTI: equal summaries and result files, the
    parity mode in effect, the activation diff at the tiny widths within
    1e-5 of each stage's std; then again on labels made from JAX's result
    files, where the AP is not 0."""
    got, tout = run_port_tool(world, world["root"], "random", monkeypatch, ["--activations"])
    printed = capsys.readouterr().out
    assert "[parity] deviations OFF: lazy_lower=False head_slots=0 dtype=float32" in printed
    cfg = got["cfg"]
    assert cfg.neck.lazy_lower is False and cfg.test.head_slots == 0
    assert cfg.compute_dtype == "float32" and cfg.test.max_per_img == 12
    assert cfg.data.train_root == str(world["root"] / "training") + "/"
    # 4 backbone stages, 6 FPN levels (the dense stride-2 one first), 5 + 5 RPN outputs
    rows = got["activations"]
    assert len(rows) == 4 + 6 + 5 + 5
    assert rows[4][0] == "fpn P1 (stride 2)"
    for tag, d, rel in rows:
        assert np.isfinite(d) and rel <= 1e-5, (tag, d, rel)
    assert "of stage std" in printed

    jout = run_jax_tool(world, world["root"], "random", monkeypatch)
    ap = assert_summaries_equal(tout, jout)
    assert got["ap"] == ap
    assert any("_aos_" in k for k in ap) and any("_3d_" in k for k in ap)
    assert_result_files_close(str(tout / "results"), str(jout / "results"))

    labelled = Path(_self_labelled(str(world["root"] / "training"), str(jout / "results"),
                                   str(tmp_path / "self" / "training"))).parent
    _, tout2 = run_port_tool(world, labelled, "self", monkeypatch)
    jout2 = run_jax_tool(world, labelled, "self", monkeypatch)
    ap2 = assert_summaries_equal(tout2, jout2)
    assert max(ap2.values()) > 0.0
    assert_result_files_close(str(tout2 / "results"), str(jout2 / "results"))
