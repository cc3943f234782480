"""The training entry point as a whole: the port's ``train_detector`` against
JAX's on one small KITTI-layout directory, and the port's own run through
``python -m monorun_tpu_torch.tools.train`` with validation on.

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
``step_N`` directories the same.

(e) The port's own run, ``tools.train.main`` with ``--device cpu`` and the
tiny configuration by ``--cfg-options``: 2 epochs of 1 step, a checkpoint
and a validation every epoch. Finite losses; the frozen stages unmoved and
the rest moved; each validation leaves the training model's parameters
float32, unchanged, and in train mode; ``init_inference`` on the last
``step_N`` gives the detections, exactly, of a session built from the
trained model in memory.
"""

import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys

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
from monorun_tpu_torch.apis import inference as tinf
from monorun_tpu_torch.apis import train as tapi
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.tools import train as ttools
from monorun_tpu_torch.utils.weights import from_jax_params, to_jax_leaves

from test_torch_modules import _randomize
from test_torch_train_loop import cpu_share, small_data, write_small_kitti  # noqa: F401
from test_torch_train_step import (
    AFTER_PNP, LOSSES, _rel, jax_train_draws, proposal_count, tiny_train_config,
)

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


def with_jax_draws(jcfg):
    """The port's ``train_step``, given each call the draws of the next key
    that JAX's loop splits from ``PRNGKey(seed + 1)``."""
    keys = [jax.random.PRNGKey(jcfg.train.seed + 1)]

    def step(model, opt, state, batch, draws=None, generator=None, **kw):
        keys[0], sub = jax.random.split(keys[0])
        cfg = model.cfg
        with torch.no_grad():
            cls, _ = model.rpn_head(model.extract_feats(batch["images"])
                                    [cfg.rpn.starting_level:])
        sizes = [(c.shape[1], c.shape[2]) for c in cls]
        draws = jax_train_draws(jcfg, sub, sum(c[0].numel() for c in cls),
                                proposal_count(cfg, sizes, cls[0].shape[-1]),
                                batch["gt_boxes"].shape[1])
        return ttrain.train_step(model, opt, state, batch, draws, generator, **kw)

    return step


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    root = tmp_path_factory.mktemp("small_kitti")
    write_small_kitti(str(root), 3, seed=2)
    jcfg, tcfg = entry_config(get_config, root), entry_config(tget_config, root)
    _, variables = init_detector(jcfg, jax.random.PRNGKey(0), (H, W), fast=True)
    variables = _randomize(variables)
    pth = str(root / "init.pth")
    torch.save({"state_dict": from_jax_params(variables["params"], variables["batch_stats"])},
               pth)
    jdir, tdir = str(root / "jax"), str(root / "torch")
    jlog, tlog, made = [], [], []

    def create(*args, **kw):
        made.append(ttrain.create_train_state(*args, **kw))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "create_train_state", create)
        mp.setattr(japi, "create_train_state", structural_train_state(variables))
        mp.setattr(japi, "make_mesh", lambda: jmesh.make_mesh(devices=jax.devices()[:1]))
        mp.setattr(japi, "MetricLogger", recording_logger(japi.MetricLogger, jlog))
        mp.setattr(tapi, "MetricLogger", recording_logger(tapi.MetricLogger, tlog))
        mp.setattr(tapi, "train_step", with_jax_draws(jcfg))
        jstate = japi.train_detector(jcfg, jdir, load_from=pth)
        model, tstate = tapi.train_detector(tcfg, tdir, load_from=pth, device="cpu")
    schedule = ttrain.make_lr_schedule(tcfg, 2)
    out = dict(jdir=jdir, tdir=tdir, jlog=jlog, tlog=tlog, jstate=jstate, model=model,
               tstate=tstate, opt=made[0][2], jinit=flat_leaves(variables["params"]),
               lr=[float(schedule(i)) for i in range(2)],
               steps={d: sorted(n for n in os.listdir(d) if n.startswith("step_"))
                      for d in (jdir, tdir)})
    for d in (jdir, tdir):          # about 0.5 GB a checkpoint
        for name in out["steps"][d]:
            shutil.rmtree(os.path.join(d, name))
    return out


@pytest.mark.parametrize("name", LOSSES + ("mean_iou", "total_loss"))
def test_loop_losses_match_jax(parity, name):
    jlog, tlog = parity["jlog"], parity["tlog"]
    assert len(jlog) == len(tlog) == 2
    for step, (j, t) in enumerate(zip(jlog, tlog)):
        rtol = 1e-3 if (step or name in AFTER_PNP) else 1e-4
        assert math.isfinite(t[name])
        np.testing.assert_allclose(t[name], j[name], rtol=rtol,
                                   atol=rtol * max(abs(j[name]), 1e-5),
                                   err_msg=f"step {step + 1}")


def test_loop_parameters_and_state_match_jax(parity):
    jstate, model, tstate = parity["jstate"], parity["model"], parity["tstate"]
    assert tstate.step == int(jstate.step) == 2
    np.testing.assert_allclose(float(tstate.loss_ema), float(jstate.loss_ema), rtol=1e-4)
    flat = flat_leaves(jstate.params)
    got = to_jax_leaves(dict(model.named_parameters()), list(flat))
    init = parity["jinit"]
    lr = sum(parity["lr"])
    for path, ref in flat.items():
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
    adam, opt = jax_adam_state(parity["jstate"].opt_state), parity["opt"]
    assert opt.count == int(adam.count) == 2
    for kind in ("mu", "nu"):
        flat = flat_leaves(getattr(adam, kind))
        named = {n: m for n, m, t in zip(opt.names, getattr(opt, kind), opt.trainable) if t}
        assert len(flat) == len(named)
        got = to_jax_leaves(named, list(flat))
        bad = {p: e for p, e in ((p, _rel(got[p], ref)) for p, ref in flat.items())
               if not e <= 1e-2}
        assert not bad, (kind, bad)


def test_loop_logs_and_checkpoints_match_jax(parity):
    jdir, tdir = parity["jdir"], parity["tdir"]
    assert parity["steps"][jdir] == parity["steps"][tdir] == ["step_1", "step_2"]
    logs = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "train_log.jsonl")) as f:
            logs.append([json.loads(ln) for ln in f])
    jlog, tlog = logs
    assert [list(r) for r in tlog] == [list(r) for r in jlog]     # keys, in order
    assert [(r["step"], r["epoch"]) for r in tlog] == [(r["step"], r["epoch"]) for r in jlog] \
        == [(1, 0), (2, 1)]


# ---- (e) the port's own run through tools.train -------------------------------------

TINY_OPTIONS = [
    "compute_dtype='float32'", "backbone.depth=26", "rpn.nms_pre=32", "rpn.nms_post=32",
    "rpn.train_nms_pre=32", "train.rcnn_num_samples=32", "train.max_pos=8",
    "train.rpn_num_samples=32", "test.rpn_nms_pre=32", "test.rpn_nms_post=32",
    "test.max_per_img=4", "global_head.mc_samples=2", "pose_head.ransac_hypotheses=2",
    "pose_head.lm_iters=2", f"data.pad_height={H}", f"data.pad_width={W}", "data.max_gt=8",
    "train.samples_per_device=2", "train.total_epochs=2", "train.checkpoint_interval=1",
    "train.eval_interval=1", "train.log_interval=1", "train.tensorboard=False",
]


@pytest.fixture(scope="module")
def own_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("own_kitti")
    write_small_kitti(str(root), 3, seed=4)
    workdir = str(root / "work")
    made, vals = [], []
    run_val = tapi._run_val

    def create(*args, **kw):
        made.append(ttrain.create_train_state(*args, **kw))
        made.append({k: v.clone() for k, v in made[0][0].state_dict().items()})
        return made[0]

    def checked_run_val(cfg, model, val_ds):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ap = run_val(cfg, model, val_ds)
        vals.append(dict(
            ap=ap, training=model.training,
            fp32=all(p.dtype == torch.float32 for p in model.parameters()),
            unchanged=all(torch.equal(p, before[n]) for n, p in model.named_parameters())))
        return ap

    argv = ["kitti_multiclass_lidar_supv", "--work-dir", workdir, "--device", "cpu",
            "--cfg-options", f"data.train_root='{root}'", "data.train_list='train_list.txt'",
            "data.val_list='train_list.txt'", *TINY_OPTIONS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "create_train_state", create)
        mp.setattr(tapi, "_run_val", checked_run_val)
        model, state = ttools.main(argv)
    with open(os.path.join(workdir, "train_log.jsonl")) as f:
        log = [json.loads(ln) for ln in f]
    yield dict(root=root, workdir=workdir, model=model, state=state, init=made[1],
               vals=vals, log=log, cfg=model.cfg)
    shutil.rmtree(workdir)          # about 0.5 GB a checkpoint


def test_own_run_trains(own_run):
    log, model, init = own_run["log"], own_run["model"], own_run["init"]
    assert [(r["step"], r["epoch"]) for r in log] == [(1, 0), (2, 1)]
    assert own_run["state"].step == 2
    for r in log:
        assert all(math.isfinite(v) for v in r.values()), r
    assert sorted(n for n in os.listdir(own_run["workdir"]) if n.startswith("step_")) \
        == ["step_1", "step_2"]
    with open(os.path.join(own_run["workdir"], "config.txt")) as f:
        assert f.read() == repr(own_run["cfg"])
    params = dict(model.named_parameters())
    frozen = [n for n in params if ttrain._is_frozen(n)]
    assert frozen and all(torch.equal(params[n], init[n]) for n in frozen)
    for n in ("backbone.layer2.0.conv1.weight", "neck.lateral_convs.0.conv.weight",
              "rpn_head.rpn_reg.weight"):
        assert not torch.equal(params[n], init[n]), n


def test_run_val_leaves_the_training_model_fp32_in_train_mode(own_run):
    vals = own_run["vals"]
    assert len(vals) == 2
    for v in vals:
        assert v["training"] and v["fp32"] and v["unchanged"]
        assert v["ap"] and all(math.isfinite(x) for x in v["ap"].values())


def test_init_inference_serves_a_port_checkpoint(own_run):
    """``init_inference`` on the run's last ``step_N`` gives the detections
    of a session built from the trained model in memory, exactly."""
    cfg, root = own_run["cfg"], own_run["root"]
    from monorun_tpu_torch.data.kitti import KITTI3DDataset
    from monorun_tpu_torch.data.pipeline import collate, prepare_test_sample

    ds = KITTI3DDataset(str(root), "train_list.txt")
    batch = collate([prepare_test_sample(ds, i, cfg.data) for i in range(2)])
    sess = tinf.init_inference(cfg, os.path.join(own_run["workdir"], "step_2"),
                               batch_size=2, device="cpu")
    ref = tinf.InferenceSession(cfg, copy.deepcopy(own_run["model"]), 2, torch.device("cpu"))
    got_det, want_det = (s.run(batch["images"], batch["cam"], batch["img_shapes"], seed=3)
                         for s in (sess, ref))
    for name, want in want_det._asdict().items():
        if name != "extras":
            assert torch.equal(getattr(got_det, name), want), name
    with pytest.raises(FileNotFoundError):
        tinf.init_inference(cfg, os.path.join(own_run["workdir"], "step_3"), device="cpu")


def test_tools_train_cli():
    out = subprocess.run([sys.executable, "-m", "monorun_tpu_torch.tools.train", "--help"],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0
    for flag in ("--work-dir", "--resume-from", "--load-from", "--seed", "--max-steps",
                 "--no-validate", "--cfg-options", "--device", "--distributed"):
        assert flag in out.stdout, flag
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        ttools.main(["kitti_multiclass", "--distributed"])    # not launched by torchrun
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.train_detector(tget_config("kitti_multiclass"), "unused")
