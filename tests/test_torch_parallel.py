"""The port's data-parallel layer (``monorun_tpu_torch/parallel/``) on two
CPU processes over Gloo, with no JAX model compile.

One fixture, once per test run, starts two ranks
(``tests/torch_parallel_child.py``, ``parallel.init_distributed`` from
torchrun's environment on 127.0.0.1) and, while they run, computes the
one-process references here with the same thread count and deterministic
algorithms:

(a) ``dataset_shard`` against JAX's; the two ranks' ``allgather_results``
against JAX's under the mocked processes of ``tests/test_dist_eval.py``, for
a total that divides over the ranks and one that does not; at world size 1
a pure reassembly.

(b) The data-parallel step against the one-process step on the same global
batch: ``test_torch_train_step.py``'s tiny float32 configuration, seeded
weights, a global batch of 4 (``synthetic_train_batch``; and a
``synthetic_scene_batch`` under ``train.debug`` and ``refined_reassign``,
where the PnP recovers poses and ``mean_iou`` is not 0), one set of global
``TrainDraws`` from ``utils/draws.py:train_draws`` (as ``train_detector``
makes them); each rank takes its 2 images and its slice of the draws. The
one-process step is the one held to JAX's
``_train_forward`` gradient by ``test_torch_train_step.py``. Every
batch-wide reduction is also checked alone (``run_units``). A negative
control runs the ranks again with ``global_sum`` set to the identity: the
comparison must then fail.

(b') The score head (``ScoreHead`` itself, seeded weights) on the score
rows of the full-width kitti_multiclass step at the training init, as the
card gave them (``tests/data/dp_score_rows.npz``, the 23 valid rows of 768,
written by ``tests/torch_dp_rows.py``; covariance entries up to 44392):
each rank on its rows against one process on all of them, in float64 and
in float32: the loss and the gradients summed over the ranks, and the
pose norm's running statistics.

(c) ``run_eval(distributed=True)`` at 2 ranks on a 5-image mini-KITTI at
``test_torch_eval_path.py``'s tiny configuration (random weights): every
index gathered once; each rank's results bitwise equal to a one-process
``run_eval`` over that rank's ``dataset_shard`` (the same batches and
per-batch seeds); the AP dict that of ``ds.evaluate`` on the gathered list.
And ``train_detector`` at 2 ranks for one step with its validation on a
4-image small KITTI directory: each rank detects one of a one-process
run's batches, and the AP that rank 0 logs, and the gathered results,
equal a one-process ``_run_val`` on the trained weights, bitwise.

(d) The CLIs under ``torch.distributed.run`` are in
``tests/test_torch_parallel_cli.py``.

The ranks and their references run once per test run (``ranks``, through
``tests/torch_share.py:run_shared``; the weights' comparisons are taken
there, ``step_errors``, so that no copy of the weights is shared); the
tests that read them are in files that xdist hands out late:
``test_torch_parallel_gather.py`` (3 tests, the first runs the ranks) and
files of at most 2, which go out after every file of 3
(``test_torch_parallel_X.py`` for X in eval, validation, losses, control,
gradients, params, stats, rows, equal, score_head and units_factor, _sum,
_ema, _bn, _sampler). This file keeps (a)'s one-process cases.

Tolerances: losses and ``mean_iou`` (the ranks' values summed) to 1e-5
relative; each gradient to 1e-5 of its leaf's largest entry (the batch's
sum split in two partial sums; the convolutions see 2 images instead of
4); ``loss_ema`` to 1e-6 relative; the score BatchNorm's statistics,
taken on the PnP's outputs, to 1e-3 of their scale (2 LM iterations in
float32 carry the convolutions' last-bit differences between a batch of
2 and of 4 to 1e-4 relative in the pose and covariance, at world size 1
too; ``test_torch_train_step.py`` allows the same against JAX; alone, on
the same inputs, the statistics agree to 1e-6 below);
the score head on the captured rows to 1e-9 of each leaf's scale in
float64 and 1e-4 in float32 (the global moments' sums in another order);
the parameters after one AdamW step as ``test_torch_train_step.py`` states
(Adam's first step turns the summation-order noise of near-zero gradients
into up to +-lr); the unit reductions to 1e-6 relative; equality across
ranks bitwise.
"""

import dataclasses
import hashlib
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from fixtures import make_mini_kitti
from monorun_tpu.parallel import dataset_shard as jdataset_shard
from monorun_tpu_torch import parallel
from monorun_tpu_torch import train as ttrain
from monorun_tpu_torch.apis import test as tapi_test
from monorun_tpu_torch.apis import train as tapi_train
from monorun_tpu_torch.apis.inference import InferenceSession
from monorun_tpu_torch.config import apply_overrides
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.data.kitti import KITTI3DDataset
from monorun_tpu_torch.models.detector import MonoRUn, init_random_weights
from monorun_tpu_torch.utils.draws import train_draws
from monorun_tpu_torch.utils.synthetic import synthetic_scene_batch, synthetic_train_batch

from test_torch_eval_path import configs
from test_torch_train_cli import NARROW_OPTIONS
from test_torch_train_loop import small_data, write_small_kitti
from test_torch_train_step import tiny_train_config
from torch_parallel_child import gather_cases, run_step, run_units, score_head_on_rows
from torch_share import cpu_share, pack, run_shared, unpack  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).resolve().parent / "torch_parallel_child.py"
SCORE_ROWS = Path(__file__).resolve().parent / "data" / "dp_score_rows.npz"
SCORE_DTYPES = {"torch.float64": 1e-9, "torch.float32": 1e-4}
WORLD = 2
B, H, W = 4, 64, 128            # the global batch: 2 images per rank
EVAL_IMAGES, EVAL_BATCH = 5, 2  # shards of 3 and 2 images: the second rank pads one
VAL_IMAGES = 4                  # the loop's validation: a batch of 2 for each rank
TIMEOUT = 600
UNIT_SUMS = ("avg_factor", "weighted", "unweighted", "kl")   # the ranks' shares sum
UNIT_EQUAL = ("kl_ema", "bn_mean", "bn_var")                # every rank holds the global
UNIT_ROWS = ("bn_out", "sampler")                           # the ranks' rows concatenate
UNITS = UNIT_SUMS + UNIT_EQUAL + UNIT_ROWS   # test_each_batch_wide_reduction_matches' cases


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    return env


def unit_inputs():
    """Global inputs of the unit reductions, 16 rows (8 per rank). The
    score IoUs give rank 0 one positive of 8 and rank 1 three: each rank's
    own keep rates differ from the global batch's, which is balanced."""
    rng = np.random.default_rng(5)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    ious = [0.9] + [0.1] * 7 + [0.8, 0.7, 0.6] + [0.2] * 5
    return dict(pred=t(rng.normal(size=(16, 4))), target=t(rng.normal(size=(16, 4))),
                weight=t(rng.uniform(size=(16, 1)) * (rng.uniform(size=(16, 1)) > 0.3)),
                logstd=t(rng.normal(0, 0.3, size=(16, 4))), x=t(rng.normal(size=(16, 17))),
                valid=torch.ones(16, dtype=torch.bool), ious=t(ious),
                uniform=t(rng.uniform(size=16)))


def make_job(tmp: Path, threads: int):
    cfg = tiny_train_config(tget_config)
    r = dataclasses.replace
    debug = r(cfg, train=r(cfg.train, debug=True, refined_reassign=True))
    model = init_random_weights(MonoRUn(cfg), torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    steps = {}
    for name, c, batch_np in (
            ("plain", cfg, synthetic_train_batch(cfg, B, (H, W), num_gt=6, num_pts=32, seed=0)),
            ("scene_debug", debug, synthetic_scene_batch(debug, B, (H, W), num_gt=6, num_pts=32,
                                                         seed=0))):
        batch = {k: torch.from_numpy(np.array(v)) for k, v in batch_np.items()}
        # the global batch's draws, as train_detector makes them on every rank
        steps[name] = dict(cfg=c, batch=batch, draws=train_draws(
            c, B, (H, W), batch["gt_boxes"].shape[1], gen, "cpu"))

    root = tmp / "mini_kitti"
    make_mini_kitti(str(root), n_images=EVAL_IMAGES, seed=1)
    _, ecfg = configs()
    emodel = init_random_weights(MonoRUn(ecfg), torch.Generator().manual_seed(3))
    with np.load(SCORE_ROWS) as f:
        rows = {k: torch.from_numpy(v) for k, v in f.items()}
    val_root = tmp / "small_kitti"
    write_small_kitti(str(val_root), VAL_IMAGES)
    return dict(threads=threads, sd=model.state_dict(), steps=steps, units=unit_inputs(),
                score_cfg=cfg.score_head,
                score_rows=dict(rows=rows, cfg=tget_config("kitti_multiclass").score_head),
                eval=dict(cfg=ecfg, sd=emodel.state_dict(), root=str(root), batch=EVAL_BATCH),
                val_loop=dict(cfg=val_loop_config(val_root), root=str(val_root),
                              work=str(tmp / "val_work")))


def val_loop_config(root):
    """``test_torch_train_step.py``'s tiny configuration at
    ``test_torch_train_cli.py``'s narrow widths on ``root``'s small KITTI
    directory (train and validation sets), one image per rank, a validation
    every epoch."""
    cfg = small_data(apply_overrides(tiny_train_config(tget_config), NARROW_OPTIONS), root)
    r = dataclasses.replace
    return r(cfg, train=r(cfg.train, samples_per_device=1, total_epochs=1,
                          checkpoint_interval=0, eval_interval=1, log_interval=1,
                          tensorboard=False))


class Recording(KITTI3DDataset):
    def evaluate(self, results, **kw):
        self.results = results
        return super().evaluate(results, **kw)


def one_process_eval(ev, shard_of):
    """``run_eval(distributed=True)`` in this process (world size 1) with
    ``dataset_shard`` giving the indices ``shard_of(n)``: (results, AP)."""
    model = MonoRUn(ev["cfg"])
    model.load_state_dict(ev["sd"])
    session = InferenceSession(ev["cfg"], model, ev["batch"], torch.device("cpu"))
    ds = Recording(ev["root"], "train_list.txt")
    with mock.patch.object(tapi_test, "dataset_shard", shard_of):
        ap = tapi_test.run_eval(session, ds, batch_size=ev["batch"], print_summary=False,
                                progress=False, distributed=True)
    return ds.results, ap


def one_process_val(job, sd):
    """The training loop's validation (``apis/train.py:_run_val``) in this
    process (world size 1) on the weights ``sd``: (results, AP)."""
    cfg = job["cfg"]
    model = MonoRUn(cfg)
    model.load_state_dict(sd)
    ds = Recording(job["root"], "train_list.txt")
    ap = tapi_train._run_val(cfg, model, ds)
    return ds.results, ap


def run_ranks(job, tmp):
    """Two ranks on ``job`` and, while they run, the one-process references
    here with the same thread count and deterministic algorithms."""
    torch.save(job, tmp / "job.pt")
    threads = job["threads"]
    t0 = time.perf_counter()
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(CHILD), str(tmp / "job.pt"), str(r),
                               str(WORLD), str(port), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=child_env())
             for r in range(WORLD)]
    saved = torch.get_num_threads(), torch.are_deterministic_algorithms_enabled()
    try:
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(True)
        ref = {name: run_step(c["cfg"], job["sd"], c["batch"], c["draws"])
               for name, c in job["steps"].items()}
        units = run_units(job["units"], job["score_cfg"])
        rows = job["score_rows"]
        score_rows = {str(d): score_head_on_rows(rows["rows"], rows["cfg"], d)
                      for d in (torch.float64, torch.float32)}
        shard_runs = [one_process_eval(job["eval"], lambda n, r=r: parallel.dataset_shard(
            n, r, WORLD)) for r in range(WORLD)]
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
        if all(p.returncode == 0 for p in procs):
            val_ref = one_process_val(job["val_loop"], torch.load(
                tmp / "rank0.pt", weights_only=False)["val_loop"]["sd"])
    finally:
        torch.set_num_threads(saved[0])
        torch.use_deterministic_algorithms(saved[1])
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"[{r}] DONE" in out, f"rank {r} failed:\n{out}"
    print(f"two ranks and the references: {time.perf_counter() - t0:.1f} s")
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    grads = torch.load(tmp / "rank0_grads.pt", weights_only=False)
    errors = {name: step_errors(ref[name], grads[name], job["sd"], float(
        ttrain.make_lr_schedule(c["cfg"], 100)(0))) for name, c in job["steps"].items()}
    for step in ref.values():
        del step["grads"], step["params"]
    return dict(ref=ref, units=units, ranks=got, step_errors=errors, shard_runs=shard_runs,
                score_rows=score_rows, val_ref=val_ref, job_digest=job_digest(job))


def step_errors(ref, got, start, lr):
    """What the gradient and parameter tests hold of one step, leaf by leaf,
    so that the shared result carries no copy of the weights: both sides'
    leaf names; each gradient's error over its leaf's scale where the
    one-process gradient is not all zero, and elsewhere whether the ranks'
    is; each parameter's largest error in its change where the gradient
    stands above 1e-3 of its leaf's scale, and in its value, each beside
    what is allowed (1e-4 lr and 2 lr, both plus two roundings of the
    parameter: the change is read as a difference of parameters)."""
    out = dict(ref_names=list(ref["grads"]), got_names=list(got["grads"]), grad_rel={},
               zero_leaf_got_any={}, params={})
    for n, g in ref["grads"].items():
        if g.abs().max() > 0:
            out["grad_rel"][n] = _rel(got["grads"][n], g)
        else:
            out["zero_leaf_got_any"][n] = bool(got["grads"][n].any())
    for n, p in ref["params"].items():
        g = ref["grads"][n]
        big = (g.abs() > 1e-3 * g.abs().max().clamp(min=1e-30)).numpy()
        rounding = 2 * float(np.spacing(np.float32(p.abs().max())))
        du_ref = (p - start[n]).numpy()[big]
        du_got = (got["params"][n] - start[n]).numpy()[big]
        out["params"][n] = (float(np.max(np.abs(du_got - du_ref), initial=0.0)),
                            1e-4 * lr + rounding,
                            float((got["params"][n] - p).abs().max()), 2 * lr + rounding)
    return out


def job_digest(job):
    """A digest of the job's weights and steps: a module's own job is the one
    the ranks ran."""
    h = hashlib.sha256()
    tensors = dict(job["sd"], **{f"{name}/{k}": v for name, c in job["steps"].items()
                                 for k, v in c["batch"].items()})
    for name, c in job["steps"].items():
        tensors.update({f"{name}/draws/{f}/{i}": t for f, v in c["draws"]._asdict().items()
                        if v is not None for i, t in enumerate(v if isinstance(v, tuple)
                                                               else (v,))})
    for k, v in tensors.items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The job, made in each module (its mini-KITTI directory under the
    module's own ``tmp``), and ``run_ranks``' results, once per test run
    (``run_shared``, through ``pack``)."""
    tmp = tmp_path_factory.mktemp("parallel")
    threads = max(1, torch.get_num_threads() // 2)
    job = make_job(tmp, threads)
    got = run_shared(
        f"test_torch_parallel.run_ranks: {WORLD} Gloo ranks, make_job (tiny_train_config, "
        f"global batch {B}x{H}x{W}, seeds 0-5, {EVAL_IMAGES}-image eval, {VAL_IMAGES}-image "
        f"validation), {threads} threads", lambda: pack(run_ranks(job, tmp)))
    got = unpack(got)
    assert got.pop("job_digest") == job_digest(job)
    return dict(job=job, **got)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


# ---- (a) dataset_shard and allgather_results ------------------------------------------


@pytest.mark.parametrize("n,world", [(23, 4), (5, 2), (8, 2), (3, 3), (10, 7)])
def test_dataset_shard_matches_jax(n, world):
    for r in range(world):
        np.testing.assert_array_equal(parallel.dataset_shard(n, r, world),
                                      jdataset_shard(n, rank=r, world=world))


def test_allgather_results_at_world_one_is_a_reassembly():
    local = {3: {"a": np.zeros(2)}, 0: {"a": np.ones(2)}}
    got = parallel.allgather_results(local, 5)
    assert got[0] is local[0] and got[3] is local[3]
    assert [i for i, r in enumerate(got) if r is None] == [1, 2, 4]
    for total, results in gather_cases().items():      # the ranks' cases, in one process
        assert len(results) == total and all(r is not None for r in results)


# ---- (b) the data-parallel step ------------------------------------------------------


STEPS = ("plain", "scene_debug")


def _unit_errors(ranks, key):
    ref = ranks["units"]
    return {k: _unit_error(k, [r[key][k] for r in ranks["ranks"]], ref[k])
            for k in UNIT_SUMS + UNIT_EQUAL + UNIT_ROWS}


def _unit_error(k, per_rank, ref):
    if k in UNIT_SUMS:
        return _rel(sum(float(v) for v in per_rank), ref.detach())
    if k in UNIT_EQUAL:
        return max(_rel(v.detach(), ref.detach()) for v in per_rank)
    return _rel(torch.cat(per_rank).detach(), ref.detach())


def check_unit(ranks, key):
    """``test_each_batch_wide_reduction_matches``: the reduction ``key``."""
    err = _unit_errors(ranks, "units")[key]
    assert err <= 1e-6, (key, err)
