"""``tests/test_torch_cold_start.py``'s ``tools.cold_profile`` against JAX's
marks, in a file of at most 3 tests (xdist hands it out late); that file states
the cases and the tolerances.
"""

import math
from pathlib import Path

import numpy as np
import pytest

from monorun_tpu_torch.tools import cold_profile
from monorun_tpu_torch.utils import compile_cache as cc

from test_torch_cold_start import TINY_OPTIONS, default_align, jax_marks, root  # noqa: F401
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("warm", [False, True])
def test_cold_profile_prints_jax_marks_in_order(capsys, root, default_align, warm):  # noqa: F811
    argv = ["2", "--device", "cpu", "--cache-dir", str(root / "cc"),
            "--cfg-options", *TINY_OPTIONS] + (["--warm"] if warm else [])
    out = cold_profile.main(argv)
    labels = [m["mark"] for m in out["marks"]]
    assert labels == jax_marks(warm)
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[cold ")]
    assert [ln.split(":")[0].split("]")[1].strip() for ln in printed] == labels
    totals = np.cumsum([m["s"] for m in out["marks"]])
    np.testing.assert_allclose([m["total_s"] for m in out["marks"]], totals, rtol=1e-9)
    assert out["checksum"][0] == out["checksum"][1] and math.isfinite(out["checksum"][0])
    assert out["nvcc_jobs"] == [] and out["first_request_nvcc_jobs"] == 0
    assert out["cache_dir"] == str(root / "cc") and (root / "cc").is_dir()
    assert cc._root is None                        # the process's root given back
    assert out["warm"] is warm and out.get("warm_seconds") is None


def test_cold_profile_removes_its_fresh_cache(root, monkeypatch, tmp_path):  # noqa: F811
    monkeypatch.setattr(cold_profile.tempfile, "tempdir", str(tmp_path))
    out = cold_profile.main(["1", "gather", "backbone", "--device", "cpu",
                             "--cfg-options", *TINY_OPTIONS])
    assert Path(out["cache_dir"]).parent == tmp_path and not Path(out["cache_dir"]).exists()
    assert cc._root is None
    assert [m["mark"] for m in out["marks"]][-3:-1] == ["first exec+fetch",
                                                        "second exec+fetch"]
    assert out["stage"] == "backbone" and out["align_impl"] == "gather"
