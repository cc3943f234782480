"""The training entry point as a whole: the port's ``train_detector`` against
JAX's on one small KITTI-layout directory.

(d) Whole-loop parity at the tiny configuration of
``test_torch_train_step.py`` (ResNet-26, the lidar NOC loss on) with 56x120
images in a 64x128 pad: 2 epochs of 1 step, a checkpoint every epoch, no
validation. Both packages start from one JAX init through ``load_from`` (a
``.pth`` written from it by ``utils/weights.py``); JAX's ``make_mesh`` is
given one device, and its ``create_train_state`` the structural init
(``load_from`` replaces the values), so JAX compiles its train step once
and nothing else. The port's step is given the draws of the keys JAX's
loop splits from ``PRNGKey(seed + 1)``, recomputed with the JAX calls
(``jax_train_draws``). Tolerances: step 1's losses to 1e-4 relative (the
terms after the 2-iteration PnP to 1e-3), step 2's to 1e-3 (what step 1's
update leaves apart, through a second forward); ``loss_ema`` to 1e-4.
Observed in a CPU run: step 1 within 7.3e-6, step 2 within 1.5e-5 (both
``loss_proj``), ``loss_ema`` 1.2e-5. The parameters after the run within
2 lr per step of JAX's (Adam's first steps turn the summation-order noise
of near-zero gradients into up to +-lr, ``test_torch_train_step.py``;
observed 1.6 times the two steps' summed rate), and each leaf's change
over the run to 0.1 of JAX's in norm (observed 0.046, ``noc_head/conv1``'s
bias; the frozen leaves unmoved in both). Adam's count equal and its
moments, which carry no such noise, leaf by leaf to 1e-2 of the leaf's
largest value (observed: first 2.7e-3, second 3.2e-4, both in
``noc_head``, whose gradients pass the PnP);
``train_log.jsonl``'s records (keys in order, ``step``, ``epoch``) and the
``step_N`` directories the same. Each loop runs once per test run
(``jax_loop``, ``port_loop``: ``tests/torch_share.py:run_shared``), and the
tests are spread over files that xdist hands out late: this file of 3, whose
first test runs both, and files of at most 2 that read them, which go out
after every file of 3 (``test_torch_train_entry_X.py`` for X in rpn, cls,
heads, pose, score and totals).

(e) The port's own run through ``tools.train`` is in
``tests/test_torch_train_cli.py``.
"""

import dataclasses
import json
import math
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monorun_tpu import train as jtrain
from monorun_tpu.apis import train as japi
from monorun_tpu.config import get_config
from monorun_tpu.models.detector import MonoRUn as JMonoRUn
from monorun_tpu.models.detector import init_detector
from monorun_tpu.parallel import mesh as jmesh
from monorun_tpu_torch import train as ttrain
from monorun_tpu_torch.apis import train as tapi
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.utils.weights import from_jax_params, to_jax_leaves

from test_torch_modules import _randomize
from test_torch_train_loop import small_data, write_small_kitti
from test_torch_train_step import (
    AFTER_PNP, _rel, draw_arrays, draw_counts, jax_train_draws, tiny_train_config,
    train_draws_of,
)
from torch_share import cpu_share, run_shared  # noqa: F401

H, W = 64, 128


def entry_config(get, root):
    cfg = small_data(tiny_train_config(get), root)
    r = dataclasses.replace
    return r(cfg, train=r(cfg.train, samples_per_device=2, total_epochs=2,
                          checkpoint_interval=1, eval_interval=0, log_interval=1,
                          tensorboard=False))


def flat_leaves(tree):
    """{"backbone/conv1/kernel": array, ...} of a JAX tree."""
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_adam_state(opt_state):
    """The ``ScaleByAdamState`` of the trainable group in JAX's optimizer
    state (``make_optimizer``: a multi_transform whose frozen group keeps
    no moments)."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def recording_logger(base, records):
    """``base`` (a ``MetricLogger``) keeping every step's metrics unrounded."""

    class Logger(base):
        def log(self, step, epoch, metrics):
            records.append({k: float(np.asarray(v)) for k, v in metrics.items()})
            super().log(step, epoch, metrics)

    return Logger


def structural_train_state(variables):
    """JAX's ``create_train_state`` on given variables (the structural init:
    ``load_from`` replaces every value), with no compile of the forward.
    ``loss_ema`` is a strongly typed float32, as the step returns it: JAX's
    own weakly typed 1.0 makes its loop compile the step a second time."""
    def create(cfg, rng, total_steps, image_shape):
        tx = jtrain.make_optimizer(cfg, total_steps)
        return JMonoRUn(cfg), jtrain.TrainState(
            params=variables["params"], batch_stats=variables["batch_stats"],
            opt_state=tx.init(variables["params"]),
            loss_ema=jnp.asarray(1.0, jnp.float32), step=jnp.asarray(0, jnp.int32)), tx

    return create


def jax_loop_draws(jcfg, tcfg, steps):
    """The draws of the keys that JAX's loop splits from ``PRNGKey(seed +
    1)``, one per step, as ``draw_arrays``; made for the loop's batches
    (``samples_per_device`` images in the pad, ``max_gt`` GT slots)."""
    n = jcfg.train.samples_per_device
    counts = draw_counts(tcfg, torch.zeros(n, jcfg.data.pad_height, jcfg.data.pad_width, 3))
    key, out = jax.random.PRNGKey(jcfg.train.seed + 1), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(draw_arrays(jax_train_draws(jcfg, sub, *counts, jcfg.data.max_gt)))
    return out


def with_draws(draws):
    """The port's ``train_step``, given each call the next of ``draws``."""
    draws = [train_draws_of(d) for d in draws]

    def step(model, opt, state, batch, _=None, generator=None, **kw):
        assert batch["gt_boxes"].shape[1] == model.cfg.data.max_gt   # as the draws were made
        return ttrain.train_step(model, opt, state, batch, draws.pop(0), generator, **kw)

    return step


SETTING = (f"entry_config(tiny_train_config(kitti_multiclass_lidar_supv)), float32, "
           f"write_small_kitti(3 images, seed 2) in a {H}x{W} pad, init_detector(PRNGKey(0), "
           "fast=True), _randomize(seed 0), 2 epochs of 1 step")


def log_and_steps(d):
    """A work dir's ``train_log.jsonl`` text and its ``step_N`` names, the
    checkpoints removed (about 0.5 GB each)."""
    with open(os.path.join(d, "train_log.jsonl")) as f:
        log = f.read()
    steps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    for name in steps:
        shutil.rmtree(os.path.join(d, name))
    return log, steps


def jax_loop():
    """JAX's ``train_detector`` on the small directory, once per test run
    (``run_shared``): the init, each step's draws for the port, the logged
    metrics, the parameters, ``loss_ema``, Adam's state and the work dir's
    log, as arrays."""
    def compute():
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "small_kitti")
            write_small_kitti(root, 3, seed=2)
            jcfg = entry_config(get_config, root)
            _, variables = init_detector(jcfg, jax.random.PRNGKey(0), (H, W), fast=True)
            variables = _randomize(variables)
            pth = os.path.join(tmp, "init.pth")
            torch.save({"state_dict": from_jax_params(variables["params"],
                                                      variables["batch_stats"])}, pth)
            jdir, jlog = os.path.join(tmp, "jax"), []
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(japi, "create_train_state", structural_train_state(variables))
                mp.setattr(japi, "make_mesh",
                           lambda: jmesh.make_mesh(devices=jax.devices()[:1]))
                mp.setattr(japi, "MetricLogger", recording_logger(japi.MetricLogger, jlog))
                jstate = japi.train_detector(jcfg, jdir, load_from=pth)
            log, steps = log_and_steps(jdir)
            adam = jax_adam_state(jstate.opt_state)
            return dict(
                variables=jax.tree.map(np.asarray, variables), log=np.array(log),
                steps=np.array(steps), records=jlog,
                draws=jax_loop_draws(jcfg, entry_config(tget_config, root), 2),
                params=flat_leaves(jstate.params), step=np.asarray(jstate.step),
                loss_ema=np.asarray(jstate.loss_ema), adam_count=np.asarray(adam.count),
                mu=flat_leaves(adam.mu), nu=flat_leaves(adam.nu))

    return run_shared(f"test_torch_train_entry.jax_loop: {SETTING}", compute)


def port_loop(ref):
    """The port's ``train_detector`` on the same directory, from JAX's init
    (through a ``.pth``) and with JAX's draws, once per test run: its logged
    metrics, parameters, ``loss_ema``, Adam's state (as JAX leaves) and the
    work dir's log."""
    def compute():
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "small_kitti")
            write_small_kitti(root, 3, seed=2)
            tcfg = entry_config(tget_config, root)
            v = ref["variables"]
            pth = os.path.join(tmp, "init.pth")
            torch.save({"state_dict": from_jax_params(v["params"], v["batch_stats"])}, pth)
            tdir, tlog, made = os.path.join(tmp, "torch"), [], []

            def create(*args, **kw):
                made.append(ttrain.create_train_state(*args, **kw))
                return made[-1]

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tapi, "create_train_state", create)
                mp.setattr(tapi, "MetricLogger", recording_logger(tapi.MetricLogger, tlog))
                mp.setattr(tapi, "train_step", with_draws(ref["draws"]))
                model, tstate = tapi.train_detector(tcfg, tdir, load_from=pth, device="cpu")
            log, steps = log_and_steps(tdir)
            opt = made[0][2]
            moments = {kind: to_jax_leaves(
                {n: m for n, m, t in zip(opt.names, getattr(opt, kind), opt.trainable) if t},
                list(ref[kind])) for kind in ("mu", "nu")}
            trainable = sum(opt.trainable)
            schedule = ttrain.make_lr_schedule(tcfg, 2)
            return dict(
                log=np.array(log), steps=np.array(steps), records=tlog,
                params=to_jax_leaves(dict(model.named_parameters()), list(ref["params"])),
                step=np.asarray(tstate.step), loss_ema=np.asarray(float(tstate.loss_ema)),
                adam_count=np.asarray(opt.count), trainable=np.asarray(trainable),
                lr=np.array([float(schedule(i)) for i in range(2)]), **moments)

    return run_shared(f"test_torch_train_entry.port_loop: {SETTING}, JAX's draws", compute)


@pytest.fixture(scope="module")
def parity():
    jax_ref = jax_loop()
    return dict(jax=jax_ref, port=port_loop(jax_ref))


def check_loop_loss(parity, name):
    """``test_loop_losses_match_jax``: ``name`` at both steps."""
    jlog, tlog = parity["jax"]["records"], parity["port"]["records"]
    assert len(jlog) == len(tlog) == 2
    for step, (j, t) in enumerate(zip(jlog, tlog)):
        j, t = float(j[name]), float(t[name])
        rtol = 1e-3 if (step or name in AFTER_PNP) else 1e-4
        assert math.isfinite(t)
        np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * max(abs(j), 1e-5),
                                   err_msg=f"step {step + 1}")


def test_loop_parameters_and_state_match_jax(parity):
    jax_ref, port = parity["jax"], parity["port"]
    assert int(port["step"]) == int(jax_ref["step"]) == 2
    np.testing.assert_allclose(float(port["loss_ema"]), float(jax_ref["loss_ema"]), rtol=1e-4)
    got, init = port["params"], flat_leaves(jax_ref["variables"]["params"])
    lr = float(port["lr"].sum())
    for path, ref in jax_ref["params"].items():
        atol = 2 * lr + 2 * np.spacing(np.abs(ref).max())
        np.testing.assert_allclose(got[path], ref, rtol=0, atol=atol, err_msg=path)
        # each leaf's change over the run, in norm (a loop that applied no
        # update is 1 off); the frozen leaves unmoved in both
        want = ref.astype(np.float64) - init[path]
        change = got[path].astype(np.float64) - init[path]
        if not want.any():
            assert not change.any(), path
            continue
        assert np.linalg.norm(change - want) <= 0.1 * np.linalg.norm(want), path


def test_loop_optimizer_state_matches_jax(parity):
    """Adam's count and moments after the run, leaf by leaf to 1e-2 of the
    leaf's largest value: the first moment is linear in the clipped
    gradients and the second quadratic, so neither carries the +-lr noise
    of the update. A loop that rebuilt the optimizer between steps fails
    here (the count, and a first moment about half JAX's)."""
    jax_ref, port = parity["jax"], parity["port"]
    assert int(port["adam_count"]) == int(jax_ref["adam_count"]) == 2
    for kind in ("mu", "nu"):
        flat, got = jax_ref[kind], port[kind]
        assert len(flat) == int(port["trainable"])
        bad = {p: e for p, e in ((p, _rel(got[p], ref)) for p, ref in flat.items())
               if not e <= 1e-2}
        assert not bad, (kind, bad)


def test_loop_logs_and_checkpoints_match_jax(parity):
    jax_ref, port = parity["jax"], parity["port"]
    assert jax_ref["steps"].tolist() == port["steps"].tolist() == ["step_1", "step_2"]
    jlog, tlog = ([json.loads(ln) for ln in str(d["log"]).splitlines()] for d in (jax_ref, port))
    assert [list(r) for r in tlog] == [list(r) for r in jlog]     # keys, in order
    assert [(r["step"], r["epoch"]) for r in tlog] == [(r["step"], r["epoch"]) for r in jlog] \
        == [(1, 0), (2, 1)]
