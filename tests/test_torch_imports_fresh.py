"""``tests/test_torch_imports.py``'s fresh interpreters that import the port
with JAX and the reference blocked, in a file of at most 3 tests (xdist hands
it out late); that file states the cases and the tolerances.
"""

import pkgutil
import subprocess
import sys

from test_torch_imports import BLOCKED, PKG
from torch_share import cpu_share  # noqa: F401


def test_port_imports_with_jax_and_reference_blocked():
    names = [m.name for m in pkgutil.walk_packages([str(PKG)], "monorun_tpu_torch.")]
    for name in ("apis.inference", "targets", "targets.assigner", "targets.sampler",
                 "targets.rpn_targets", "targets.dense_target", "losses", "train",
                 "utils.synthetic", "data.kitti", "data.loader", "data.transforms",
                 "eval", "eval.kitti_eval", "eval.rotated_iou_np", "eval._native",
                 "apis.test", "utils.visualizer", "tools.test", "tools.prepare_kitti",
                 "demo", "demo.infer_imgs", "demo.infer_webcam", "apis.train",
                 "utils.checkpoint", "tools.train", "parallel", "parallel.mesh",
                 "parallel.gather", "utils.stages", "tools.parity", "tools.profile_stages",
                 "tools.flop_budget", "tools.profile_trace", "utils.compile_cache",
                 "utils.warm_start", "tools.cold_profile"):
        assert f"monorun_tpu_torch.{name}" in names, name
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_parallel_layer_imports_with_jax_and_reference_blocked():
    """The data-parallel layer, alone in a fresh interpreter."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import monorun_tpu_torch.parallel.mesh, monorun_tpu_torch.parallel.gather\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
