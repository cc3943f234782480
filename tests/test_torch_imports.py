"""The port stands alone: it imports neither ``jax`` nor ``monorun_tpu``.

A fresh interpreter with both names blocked in ``sys.modules`` imports
every module of ``monorun_tpu_torch``; and no source file of the package
names either in an import statement. And every port test file that runs
torch takes its thread share from ``tests/torch_share.py`` (read from the
sources).

The cases that start fresh interpreters are in
``test_torch_imports_{fresh,scripts}.py``: files of at most 3 tests, which
xdist hands out late (ROADMAP's test-time budget).
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

import monorun_tpu_torch

PKG = Path(monorun_tpu_torch.__file__).parent
BLOCKED = ("jax", "jaxlib", "flax", "monorun_tpu")


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


CARD_SCRIPTS = ("chip_smoke.py", "tests/torch_e2e_closure.py", "tests/torch_parallel_child.py",
                "tests/torch_share.py")


def check_card_script(script):
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


@pytest.mark.parametrize("script", CARD_SCRIPTS[:1])
def test_card_scripts_import_neither_jax_nor_the_reference(script):
    """The script that starts no interpreter; the others in
    ``test_torch_imports_scripts.py``."""
    check_card_script(script)



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
