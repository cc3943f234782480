"""The port stands alone: it imports neither ``jax`` nor ``monorun_tpu``.

A fresh interpreter with both names blocked in ``sys.modules`` imports
every module of ``monorun_tpu_torch``; and no source file of the package
names either in an import statement. And every port test file that runs
torch takes its thread share from ``tests/torch_share.py`` (read from the
sources).
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


TESTS = PKG.parent / "tests"
JAX_ERA = ("test_torch_parity.py",)        # in the repository before the port began
SHARE_EXEMPT = {
    "test_torch_imports.py": "reads sources; torch runs only in the fresh interpreters "
                             "it starts, which import and compute nothing",
}


def takes_the_share(source: str) -> bool:
    """Whether a test module imports ``cpu_share`` from ``torch_share`` at
    its top level (so the module-scoped autouse fixture is its own) and
    defines no ``cpu_share`` of its own; ``True`` for a module that imports
    neither torch nor the port."""
    body = ast.parse(source).body
    mods = {(a.name if isinstance(n, ast.Import) else n.module or "").split(".")[0]
            for n in body if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in n.names}
    if not mods & {"torch", "monorun_tpu_torch"}:
        return True
    shared = any(isinstance(n, ast.ImportFrom) and n.module == "torch_share"
                 and "cpu_share" in [a.name for a in n.names] for n in body)
    own = any(isinstance(n, ast.FunctionDef) and n.name == "cpu_share" for n in body)
    return shared and not own


def test_every_port_test_file_takes_the_thread_share():
    """Under xdist each worker takes its share of torch's threads from the
    one fixture: a port test file that imports torch or the port and does
    not is listed, with its reason, in ``SHARE_EXEMPT``."""
    files = sorted(p.name for p in TESTS.glob("test_torch_*.py") if p.name not in JAX_ERA)
    assert set(SHARE_EXEMPT) <= set(files)
    without = [f for f in files if f not in SHARE_EXEMPT
               and not takes_the_share((TESTS / f).read_text())]
    assert not without, f"no cpu_share from tests/torch_share.py: {without}"
    fixture = ast.parse((TESTS / "torch_share.py").read_text()).body
    (share,) = [n for n in fixture if isinstance(n, ast.FunctionDef) and n.name == "cpu_share"]
    assert ast.unparse(share.decorator_list[0]) == \
        "pytest.fixture(scope='module', autouse=True)"


@pytest.mark.parametrize("source,takes", [
    ("import torch\n", False),
    ("import torch\nfrom torch_share import cpu_share\n", True),
    ("from monorun_tpu_torch import train\n", False),
    ("import torch\nfrom torch_share import cpu_share\n\ndef cpu_share():\n    pass\n",
     False),
    ("import torch\n\ndef f():\n    from torch_share import cpu_share\n", False),
    ("import numpy\n", True),
])
def test_the_share_guard_reads_imports(source, takes):
    assert takes_the_share(source) is takes
