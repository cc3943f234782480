"""What the port's CPU test files share: torch's threads and the JAX references.

``cpu_share``: each pytest-xdist worker's share of the host's cores for
torch on the CPU. Every ``tests/test_torch_*.py`` file that runs torch
imports it (``from torch_share import cpu_share  # noqa: F401``): an
autouse fixture of module scope, so it is set up before the module's other
fixtures and its setups run under the share too. Under xdist the workers
share the host's cores: with torch's default of one thread per core in each
of 6 workers on 8 cores, beside XLA's own pool, an oversubscribed thread
pool slows every worker many times over (one file took 83.2 s at the
default threads and 12.1 s at its share). Outside xdist the share is every
thread.

``run_shared(key, compute)``: a reference computed once per test run and
read by every file that needs it. xdist hands whole files to its workers,
most tests first, so a file of few tests runs late in the run; a heavy case
goes into such a file, and the files that compare against one JAX
reference (a compiled train step, a loop) get it from here instead of
compiling it each. ``pack`` and ``unpack`` carry a result made of torch
tensors and Python values (a two-process run's) through it. The run's last
worker to exit removes the run's directory; a run killed before that
leaves it to the next run to remove.

No JAX and nothing of ``monorun_tpu`` here: the card's test files import it
where JAX is not installed; a caller passes its JAX computation in.
``tests/test_torch_imports.py`` fails on a port test file that imports torch
without ``cpu_share`` and is not exempt.
"""

import atexit
import contextlib
import fcntl
import glob
import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import pytest


def share(threads: int) -> int:
    """This worker's share of ``threads``: at least one."""
    return max(1, threads // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


@pytest.fixture(scope="module", autouse=True)
def cpu_share():
    import torch        # here, so that a process that only shares references starts faster

    threads = torch.get_num_threads()
    torch.set_num_threads(share(threads))
    yield
    torch.set_num_threads(threads)


_MEMO = {}
_TREE = "__tree__"


def _flatten(tree, leaves):
    """``tree`` -> a JSON-able spec; each array leaf appended to ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError(f"run_shared: dict keys must be str, got {list(tree)}")
        return {"d": [[k, _flatten(v, leaves)] for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        return {"l" if isinstance(tree, list) else "t": [_flatten(v, leaves) for v in tree]}
    leaf = np.asarray(tree)
    if leaf.dtype.hasobject:
        raise TypeError(f"run_shared: {type(tree).__name__} is not an array")
    leaves.append(leaf)
    return len(leaves) - 1


def _unflatten(spec, leaves):
    if spec is None:
        return None
    if isinstance(spec, int):
        return leaves[str(spec)]
    if "d" in spec:
        return {k: _unflatten(v, leaves) for k, v in spec["d"]}
    items = [_unflatten(v, leaves) for v in spec.get("l", spec.get("t"))]
    return items if "l" in spec else tuple(items)


def save_tree(path, tree):
    leaves = []
    spec = json.dumps(_flatten(tree, leaves))
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{_TREE: np.array(spec)}, **{str(i): a for i, a in enumerate(leaves)})
    os.replace(tmp, path)


def load_tree(path):
    with np.load(path, allow_pickle=False) as z:
        leaves = {k: z[k] for k in z.files}
    return _unflatten(json.loads(str(leaves.pop(_TREE))), leaves)


def shared_dir():
    """This run's directory of references, or None outside xdist."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    return os.path.join(tempfile.gettempdir(), f"{PREFIX}{run}") if run else None


PREFIX = "monorun_t1_"
_ENTERED = set()


@contextlib.contextmanager
def _dir_lock(d, how):
    """``flock`` on the file beside ``d``: shared while a worker uses ``d``,
    exclusive to remove it. The file goes with ``d``; a worker that locked
    it before then still loses nothing, since a worker marks itself in
    ``d`` before it uses a file there and only a directory with no live
    mark is removed."""
    with open(d + ".lock", "a") as f:
        fcntl.flock(f, how)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _users(d):
    """The worker pids marked in ``d`` that still run; dead ones' marks go."""
    live = []
    for name in os.listdir(os.path.join(d, "workers")):
        if _alive(int(name)):
            live.append(int(name))
        else:
            os.remove(os.path.join(d, "workers", name))
    return live


def _leave(d):
    """At a worker's exit: its mark goes, and the last worker out removes
    the run's directory."""
    with contextlib.suppress(FileNotFoundError):
        os.remove(os.path.join(d, "workers", str(os.getpid())))
    with _dir_lock(d, fcntl.LOCK_EX), contextlib.suppress(FileNotFoundError):
        if not _users(d):
            _remove(d)


def _remove(d):
    shutil.rmtree(d, ignore_errors=True)
    with contextlib.suppress(FileNotFoundError):
        os.remove(d + ".lock")


def _enter(d):
    """A worker's first use of the run's directory: its mark, removed at
    its exit (``_leave``); and the directories of earlier runs whose workers
    all died without removing them (a run cut by a kill) go."""
    os.makedirs(os.path.join(d, "workers"), exist_ok=True)
    open(os.path.join(d, "workers", str(os.getpid())), "w").close()
    if d in _ENTERED:
        return
    _ENTERED.add(d)
    atexit.register(_leave, d)
    for other in glob.glob(os.path.join(os.path.dirname(d), PREFIX + "*")):
        if other == d or not os.path.isdir(os.path.join(other, "workers")):
            continue
        try:
            with _dir_lock(other, fcntl.LOCK_EX | fcntl.LOCK_NB):
                if not _users(other):
                    _remove(other)
        except BlockingIOError:
            pass                        # in use by a run of its own


def run_shared(key: str, compute):
    """``compute()``, a tree (dicts with str keys, lists, tuples, None) of
    numpy arrays, computed once per test run for ``key`` and returned with
    every leaf as a numpy array.

    ``key`` names everything the result depends on: configuration, widths,
    seed, dtype. Under xdist the first worker to ask computes it while it
    holds an exclusive ``flock`` on a file in this run's directory
    (``shared_dir()``, named by ``PYTEST_XDIST_TESTRUNUID``) and writes it
    with ``np.savez`` (arrays only, no pickle); every other worker waits on
    the lock and loads the file. A worker that dies releases its lock with
    its file descriptor, and the next one computes. No other run's directory
    is read, so no reference outlives its run, and the run's last worker to
    exit removes the directory. Outside xdist the result is memoised in the
    process. Either way it is the same tree, rebuilt from the arrays as they
    are saved."""
    d = shared_dir()
    if d is None:
        if key not in _MEMO:
            leaves = []
            spec = _flatten(compute(), leaves)
            _MEMO[key] = _unflatten(spec, {str(i): a for i, a in enumerate(leaves)})
        return _MEMO[key]
    with _dir_lock(d, fcntl.LOCK_SH):
        _enter(d)
        name = os.path.join(d, hashlib.sha256(key.encode()).hexdigest()[:32])
        with open(name + ".lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not os.path.exists(name + ".npz"):
                    save_tree(name + ".npz", compute())
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        return load_tree(name + ".npz")


def pack(obj):
    """``obj`` as a tree that ``run_shared`` stores, ``unpack``'s inverse:
    torch tensors, numpy arrays and scalars, Python scalars and strings and
    None, in lists, tuples and dicts (keys of any of those scalar kinds). A
    tensor comes back a tensor, a scalar the same kind of scalar, a dict with
    its keys in their order."""
    import torch

    if obj is None or isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, np.generic):
        return {"np": np.asarray(obj)}
    if isinstance(obj, torch.Tensor):
        return {"tensor": obj.detach().cpu().numpy()}
    if isinstance(obj, (bool, int, float, str)):
        return {"py": np.asarray(obj)}
    if isinstance(obj, dict):
        return {"dict": [[pack(k), pack(v)] for k, v in obj.items()]}
    if type(obj) in (list, tuple):
        return type(obj)(pack(v) for v in obj)
    raise TypeError(f"pack: {type(obj).__name__}")


def unpack(tree):
    """``pack``'s inverse."""
    import torch

    if isinstance(tree, dict):
        (kind, value), = tree.items()
        if kind == "tensor":
            return torch.from_numpy(value)
        if kind == "py":
            return value.item()
        if kind == "np":
            return value[()]
        return {unpack(k): unpack(v) for k, v in value}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unpack(v) for v in tree)
    return tree
