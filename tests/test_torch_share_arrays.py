"""``tests/torch_share.py``: what ``run_shared`` stores and loads, in this
process under a made-up run id (``fake_run``): arrays bit for bit, the
trees it refuses, and ``pack``/``unpack``. The cross-process cases are in
``test_torch_share.py``; each file holds at most 3 tests, which xdist hands
out late.
"""

import os
import uuid

import numpy as np
import pytest
import torch

import torch_share
from torch_share import cpu_share, pack, run_shared, unpack  # noqa: F401


@pytest.fixture
def fake_run(tmp_path, monkeypatch):
    """A run id and temporary directory of this test's own, in this process:
    at its end the worker leaves as at exit, which removes the directory."""
    monkeypatch.setattr(torch_share.tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("PYTEST_XDIST_TESTRUNUID", f"fake-{uuid.uuid4().hex}")
    exits = []
    monkeypatch.setattr(torch_share.atexit, "register", lambda f, *a: exits.append((f, a)))
    yield
    assert [a for _, a in exits] == [(torch_share.shared_dir(),)]
    for f, a in exits:
        f(*a)
    assert not os.path.exists(torch_share.shared_dir())
    assert not os.path.exists(torch_share.shared_dir() + ".lock")


def test_arrays_round_trip_bit_equal(fake_run):
    """Through the file: each leaf's dtype, shape and bytes, and the tree's
    dicts (in order), lists, tuples and None."""
    rng = np.random.default_rng(0)
    special = np.array([np.nan, -0.0, np.inf, -np.inf, 1e-45, 3.4e38], np.float32)
    tree = {
        "z": special, "a": rng.standard_normal((3, 4, 5)),
        "nested": {"ints": rng.integers(-2**62, 2**62, 7), "bool": rng.random(9) > 0.5,
                   "u8": rng.integers(0, 255, (2, 2), dtype=np.uint8),
                   "empty": np.zeros((0, 3), np.float16)},
        "seq": [np.float64(1 / 3), (np.int32(-1), None), []], "scalar": np.array(7.25),
    }
    key = f"round trip {uuid.uuid4().hex}"
    run_shared(key, lambda: tree)
    got = run_shared(key, lambda: pytest.fail("computed again: the file was not read"))
    assert list(got) == list(tree) and list(got["nested"]) == list(tree["nested"])
    assert isinstance(got["seq"], list) and isinstance(got["seq"][1], tuple)
    assert got["seq"][1][1] is None and got["seq"][2] == []

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [] if t is None else [np.asarray(t)]

    for want, have in zip(leaves(tree), leaves(got), strict=True):
        assert isinstance(have, np.ndarray)
        assert (have.dtype, have.shape) == (want.dtype, want.shape)
        assert have.tobytes() == want.tobytes()


def test_what_is_not_an_array_tree_is_refused(fake_run):
    with pytest.raises(TypeError):
        run_shared(f"object {uuid.uuid4().hex}", lambda: {"f": object()})
    with pytest.raises(TypeError):
        run_shared(f"int key {uuid.uuid4().hex}", lambda: {1: np.ones(2)})


def test_pack_carries_tensors_and_python_values_through_a_file(fake_run):
    """A two-process run's kind of result: tensors (float, int, bool), dicts
    with int and str keys, tuples, Python and numpy scalars, strings and
    None come back as they went, tensors bit for bit."""
    gen = torch.Generator().manual_seed(0)
    obj = {"grads": {"w": torch.randn(3, 4, generator=gen), "n": torch.arange(5)},
           7: [{"boxes": np.ones((2, 8), np.float32)}, None], "ok": torch.tensor([True]),
           "logged": [(1, {"AP": 0.25})], "pose_ok": 3, "loss": 1.5, "name": "plain",
           "ap": np.float64(0.125), "flag": True}
    key = f"pack {uuid.uuid4().hex}"
    run_shared(key, lambda: pack(obj))
    got = unpack(run_shared(key, lambda: pytest.fail("computed again")))
    assert list(got) == list(obj) and list(got["grads"]) == ["w", "n"]
    for k in ("w", "n"):
        assert torch.equal(got["grads"][k], obj["grads"][k])
        assert got["grads"][k].dtype == obj["grads"][k].dtype
    assert torch.equal(got["ok"], obj["ok"])
    assert got[7][1] is None and np.array_equal(got[7][0]["boxes"], obj[7][0]["boxes"])
    assert got["logged"] == [(1, {"AP": 0.25})] and isinstance(got["logged"][0], tuple)
    for k in ("pose_ok", "loss", "name", "flag"):
        assert got[k] == obj[k] and type(got[k]) is type(obj[k])
    assert got["ap"] == 0.125 and type(got["ap"]) is np.float64
    with pytest.raises(TypeError):
        pack({"cfg": object()})
