"""The port stands alone: it imports neither ``jax`` nor ``monorun_tpu``.

A fresh interpreter with both names blocked in ``sys.modules`` imports
every module of ``monorun_tpu_torch``; and no source file of the package
names either in an import statement.
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import monorun_tpu_torch

PKG = Path(monorun_tpu_torch.__file__).parent
BLOCKED = ("jax", "jaxlib", "flax", "monorun_tpu")


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
                 "tools.flop_budget", "tools.profile_trace"):
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


def test_no_source_file_imports_jax_or_the_reference():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in BLOCKED, f"{path}: imports {m}"


CARD_SCRIPTS = ("chip_smoke.py", "tests/torch_e2e_closure.py", "tests/torch_parallel_child.py")


@pytest.mark.parametrize("script", CARD_SCRIPTS)
def test_card_scripts_import_neither_jax_nor_the_reference(script):
    """The scripts that run on the card, where JAX is not installed: no
    import statement names a blocked module, and the shared helpers import
    in a fresh interpreter with the blocked names."""
    path = PKG.parent / script
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in BLOCKED, f"{script}: imports {m}"
    if not script.startswith("tests/"):
        return
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(path.parent)!r})\n"
        f"import {path.stem}\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
