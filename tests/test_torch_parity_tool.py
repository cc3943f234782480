"""The port's parity runbook (``python -m monorun_tpu_torch.tools.parity``)
against the JAX package's ``tools/parity.py``, on the CPU.

A mini-KITTI (``make_mini_kitti``, 5 random 375x1242 PNGs under
``KITTI_ROOT/training/`` with ``mono3dsplit_val_list.txt``) and a ``.pth``
in the reference key layout, written from seeded weights (the JAX
package's, given non-trivial values as ``test_torch_serve.py`` does, and
saved by the port's ``from_jax_params``). Both tools read them with the
same argv (the port's adds ``--device cpu``) at the tiny widths of
``test_torch_serve.py:tiny_config`` given as ``--cfg-options``, and the
parity mode on top: float32, ``neck.lazy_lower=False`` (the dense
stride-2 level) and ``test.head_slots=0`` (the 3D heads on all 12
slots). JAX's tool is loaded from its file and run unedited; its session
is built once (one compile) and kept for the second run. The port's
session is given the draws the JAX session takes from each batch's seed.

Tolerances as in ``test_torch_eval_path.py``: the summary files' APs to
1e-9 (the AOS rows, continuous in the alphas, to 1e-5), result files
field by field at its tolerances; the activation diff against
``tests/torch_ref/backbone.py:DetectorTorso`` within 1e-5 of each stage's
standard deviation (both float32 on the CPU).

The whole parity run is in ``test_torch_parity_tool_run.py``: files of at most
3 tests, which xdist hands out late (ROADMAP's test-time budget).
"""

import dataclasses
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fixtures import make_mini_kitti
from monorun_tpu.apis import inference as jinf
from monorun_tpu_torch.apis import inference as tinf
from monorun_tpu_torch.models.detector import HeadDraws
from monorun_tpu_torch.tools import parity as tparity
from monorun_tpu_torch.utils.weights import from_jax_params

from test_torch_eval_path import TINY_OPTIONS
from test_torch_modules import jax_mc_masks
from test_torch_serve import jax_variables
from torch_share import cpu_share  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
N_IMAGES = 5          # assert_result_files_close's count
B = 2                 # batches of 2: the last one wraps to the front
# the tiny widths; the head slots stay the parity mode's 0
OPTIONS = [o for o in TINY_OPTIONS if not o.startswith(("test.head_slots", "compute_dtype"))]


def load_jax_tool():
    """``tools/parity.py`` as a module, unedited. Its import points JAX's
    persistent compilation cache at ``~/.cache/jax``; the config is put
    back at once, so the test writes no cache."""
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location("jax_parity_tool", REPO / "tools" / "parity.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def parity_draws(cfg, seed, batch):
    """The MC-dropout masks and RANSAC keys the JAX session draws from
    ``PRNGKey(seed)`` for ``batch`` images, at the head-slot count
    ``heads_forward`` serves (all ``max_per_img`` slots when
    ``head_slots`` is 0)."""
    tc = cfg.test
    K = tc.head_slots if 0 < tc.head_slots < tc.max_per_img else tc.max_per_img
    rng_mc, rng_pnp = jax.random.split(jax.random.PRNGKey(seed))
    n = batch * K
    masks = jax_mc_masks(cfg.global_head, rng_mc, n, cfg.neck.out_channels)
    keys = np.array(jax.random.uniform(
        rng_pnp, (n, cfg.pose_head.ransac_hypotheses, cfg.noc_head.dense_size ** 2)))
    return HeadDraws(tuple(torch.from_numpy(m.copy()) for m in masks), torch.from_numpy(keys))


class JaxDrawsSession:
    """A port session whose ``run`` is given the JAX session's draws."""

    def __init__(self, session):
        self.session = session

    def __getattr__(self, name):
        return getattr(self.session, name)

    def run(self, images, cam, shapes, seed=0):
        return self.session.run(images, cam, shapes, seed=seed,
                                draws=parity_draws(self.session.cfg, seed, len(images)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    base = tmp_path_factory.mktemp("parity")
    root = base / "kitti"
    make_mini_kitti(str(root / "training"), n_images=N_IMAGES, seed=1)
    shutil.copy(root / "training" / "train_list.txt",
                root / "training" / "mono3dsplit_val_list.txt")
    jtool = load_jax_tool()
    jcfg = jtool.parity_config("kitti_multiclass", str(root), OPTIONS)
    variables = jax_variables(jcfg)
    ckpt = base / "weights.pth"
    torch.save({"state_dict": from_jax_params(variables["params"], variables["batch_stats"])},
               ckpt)
    return dict(base=base, root=root, ckpt=ckpt, jtool=jtool, jsessions=[])


def argv_of(world, root, tag):
    out = world["base"] / tag
    return [str(root), str(world["ckpt"]), "--batch-size", str(B),
            "--result-dir", str(out / "results"), "--summary-file", str(out / "ap.json"),
            "--cfg-options", *OPTIONS], out


def run_jax_tool(world, root, tag, monkeypatch):
    """JAX's ``tools/parity.py`` main on ``root``: its first session is
    built by JAX's ``init_inference`` from the ``.pth`` and kept."""
    made = world["jsessions"]
    init = jinf.init_inference

    def keeping(cfg, checkpoint, batch_size=1, **kw):
        assert kw == {"explicit_lazy": True}
        if not made:
            made.append(init(cfg, checkpoint, batch_size=batch_size, **kw))
        assert made[0].cfg.neck.lazy_lower is False and made[0].cfg.test.head_slots == 0
        return made[0]

    argv, out = argv_of(world, root, f"{tag}_jax")
    with monkeypatch.context() as m:
        m.setattr(jinf, "init_inference", keeping)
        m.setattr(sys, "argv", ["parity.py", *argv])
        world["jtool"].main()
    return out


def run_port_tool(world, root, tag, monkeypatch, extra=()):
    sessions = []

    def wrapped(*args, **kw):
        sessions.append(tinf.init_inference(*args, **kw))
        return JaxDrawsSession(sessions[-1])

    argv, out = argv_of(world, root, f"{tag}_port")
    with monkeypatch.context() as m:
        m.setattr(tparity, "init_inference", wrapped)
        got = tparity.main([*argv, "--device", "cpu", *extra])
    assert len(sessions) == 1 and sessions[0].device == torch.device("cpu")
    return got, out


def assert_summaries_equal(tout, jout):
    """The APs to 1e-9. The AOS rows are continuous in the detections'
    alphas, which agree to the result files' tolerance, not bit for bit,
    and the evaluator sums them in float32: those to 1e-5 (a few float32
    ulps of an AOS in percent)."""
    ap_t = json.loads((tout / "ap.json").read_text())
    ap_j = json.loads((jout / "ap.json").read_text())
    assert list(ap_t) == list(ap_j) and len(ap_j) > 0
    for k, v in ap_j.items():
        tol = 1e-5 if "_aos_" in k else 1e-9
        assert abs(ap_t[k] - v) <= tol, (k, ap_t[k], v)
    return ap_t


def test_parity_config_is_jax_parity_config(world):
    """The port's parity mode is field for field the JAX tool's."""
    for overrides in ([], OPTIONS):
        j = world["jtool"].parity_config("kitti_multiclass", str(world["root"]), overrides)
        t = tparity.parity_config("kitti_multiclass", str(world["root"]), overrides)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_cli_help_and_a_missing_checkpoint_fail_loudly(world, capsys):
    with pytest.raises(SystemExit) as e:
        tparity.main(["--help"])
    out = capsys.readouterr().out
    assert e.value.code == 0 and "--activations" in out and "--device" in out
    with pytest.raises(FileNotFoundError):
        tparity.main([str(world["root"]), str(world["base"] / "absent.pth"), "--device",
                      "cpu", "--cfg-options", *OPTIONS])


def test_activation_diff_stops_without_the_replica(world, monkeypatch):
    """Outside a checkout (no ``tests/torch_ref``) ``--activations`` says so
    and stops; it never skips the diff silently."""
    cfg = tparity.parity_config("kitti_multiclass", str(world["root"]), OPTIONS)
    assert tparity.load_replica(cfg, str(world["ckpt"])).neck is not None
    monkeypatch.setattr(tparity, "REPLICA", world["base"] / "absent" / "backbone.py")
    with pytest.raises(SystemExit, match="absent"):
        tparity.load_replica(cfg, str(world["ckpt"]))
