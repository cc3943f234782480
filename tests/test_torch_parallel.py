"""The port's data-parallel layer (``monorun_tpu_torch/parallel/``) on two
CPU processes over Gloo, with no JAX model compile.

One module fixture starts two ranks (``tests/torch_parallel_child.py``,
``parallel.init_distributed`` from torchrun's environment on 127.0.0.1)
and, while they run, computes the one-process references here with the
same thread count and deterministic algorithms:

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

(d) ``tools.train --distributed`` and ``tools.test --distributed`` under
``python -m torch.distributed.run --nproc-per-node 2`` with ``--device
cpu``; ``tools.test`` refuses a batch that does not divide over the ranks.

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
import json
import os
import shutil
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
from monorun_tpu_torch.apis.inference import InferenceSession
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.data.kitti import KITTI3DDataset
from monorun_tpu_torch.models.detector import MonoRUn, init_random_weights
from monorun_tpu_torch.utils.draws import train_draws
from monorun_tpu_torch.utils.synthetic import synthetic_scene_batch, synthetic_train_batch

from test_dist_eval import _simulate_multiprocess_gather
from test_torch_eval_path import TINY_OPTIONS, configs
from test_torch_train_entry import TINY_OPTIONS as TRAIN_OPTIONS
from test_torch_train_loop import cpu_share, write_small_kitti  # noqa: F401
from test_torch_train_step import tiny_train_config
from torch_parallel_child import gather_cases, run_step, run_units, score_head_on_rows

REPO = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).resolve().parent / "torch_parallel_child.py"
SCORE_ROWS = Path(__file__).resolve().parent / "data" / "dp_score_rows.npz"
SCORE_DTYPES = {"torch.float64": 1e-9, "torch.float32": 1e-4}
WORLD = 2
B, H, W = 4, 64, 128            # the global batch: 2 images per rank
EVAL_IMAGES, EVAL_BATCH = 5, 2  # shards of 3 and 2 images: the second rank pads one
TIMEOUT = 600
UNIT_SUMS = ("avg_factor", "weighted", "unweighted", "kl")   # the ranks' shares sum
UNIT_EQUAL = ("kl_ema", "bn_mean", "bn_var")                # every rank holds the global
UNIT_ROWS = ("bn_out", "sampler")                           # the ranks' rows concatenate


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
    return dict(threads=threads, sd=model.state_dict(), steps=steps, units=unit_inputs(),
                score_cfg=cfg.score_head,
                score_rows=dict(rows=rows, cfg=tget_config("kitti_multiclass").score_head),
                eval=dict(cfg=ecfg, sd=emodel.state_dict(), root=str(root), batch=EVAL_BATCH))


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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    threads = max(1, torch.get_num_threads() // 2)
    job = make_job(tmp, threads)
    torch.save(job, tmp / "job.pt")
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
    return dict(job=job, ref=ref, units=units, ranks=got, grads=grads, shard_runs=shard_runs,
                score_rows=score_rows)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


# ---- (a) dataset_shard and allgather_results ------------------------------------------


@pytest.mark.parametrize("n,world", [(23, 4), (5, 2), (8, 2), (3, 3), (10, 7)])
def test_dataset_shard_matches_jax(n, world):
    for r in range(world):
        np.testing.assert_array_equal(parallel.dataset_shard(n, r, world),
                                      jdataset_shard(n, rank=r, world=world))


@pytest.mark.parametrize("total", [7, 8])
def test_allgather_results_matches_jax_two_processes(ranks, monkeypatch, total):
    """Each rank's gathered list equals JAX's ``allgather_results`` of rank 0
    under the mocked two processes, field by field and bitwise."""
    rng = np.random.default_rng(total)
    golden = {i: {"boxes": rng.normal(size=(4, 8)).astype(np.float32),
                  "valid": rng.integers(0, 2, size=(4,)).astype(bool)} for i in range(total)}
    local_of_rank = [{int(i): golden[int(i)] for i in jdataset_shard(total, rank=r, world=WORLD)}
                     for r in range(WORLD)]
    want = _simulate_multiprocess_gather(monkeypatch, WORLD, total, local_of_rank)
    for got in (r["gather"][total] for r in ranks["ranks"]):
        assert len(got) == total
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_allgather_results_at_world_one_is_a_reassembly():
    local = {3: {"a": np.zeros(2)}, 0: {"a": np.ones(2)}}
    got = parallel.allgather_results(local, 5)
    assert got[0] is local[0] and got[3] is local[3]
    assert [i for i, r in enumerate(got) if r is None] == [1, 2, 4]
    for total, results in gather_cases().items():      # the ranks' cases, in one process
        assert len(results) == total and all(r is not None for r in results)


# ---- (b) the data-parallel step ------------------------------------------------------


STEPS = ("plain", "scene_debug")


@pytest.mark.parametrize("name", STEPS)
def test_each_rank_has_positive_score_rows(ranks, name):
    """The score head's reductions see real rows on every rank."""
    counts = [r["steps"][name]["pose_ok"] for r in ranks["ranks"]]
    assert all(c > 0 for c in counts), counts
    assert sum(counts) == ranks["ref"][name]["pose_ok"]


@pytest.mark.parametrize("name", STEPS)
def test_losses_match_the_one_process_step(ranks, name):
    ref = ranks["ref"][name]["metrics"]
    got = [r["steps"][name]["metrics"] for r in ranks["ranks"]]
    assert all(g == got[0] for g in got), "the ranks logged different metrics"
    errs = {k: abs(got[0][k] - v) / max(abs(v), 1e-12) for k, v in ref.items()
            if k != "nonfinite_grad_leaves"}
    print(f"{name}: worst loss relative error {max(errs.values()):.3g} (allowed 1e-5)")
    for k, v in ref.items():
        np.testing.assert_allclose(got[0][k], v, rtol=1e-5, atol=1e-12, err_msg=k)
    if name == "scene_debug":
        assert ref["mean_iou"] > 0.1


@pytest.mark.parametrize("name", STEPS)
def test_gradients_match_the_one_process_step(ranks, name):
    ref = ranks["ref"][name]["grads"]
    got = ranks["grads"][name]["grads"]
    assert list(got) == list(ref)
    worst = {n: _rel(got[n], ref[n]) for n in ref if ref[n].abs().max() > 0}
    bad = {n: e for n, e in worst.items() if not e <= 1e-5}
    print(f"{name}: worst gradient error {max(worst.values()):.3g} of its leaf's scale "
          f"(allowed 1e-5)")
    assert not bad, bad
    for n in set(ref) - set(worst):
        assert not got[n].any(), n


@pytest.mark.parametrize("name", STEPS)
def test_parameters_after_one_step_match(ranks, name):
    """The step's change of each parameter to 1e-4 of lr where the gradient
    stands above 1e-3 of its leaf's scale; everywhere within 2 lr; both
    plus two roundings of the parameter (the change is read as a difference
    of parameters)."""
    ref, got = ranks["ref"][name], ranks["grads"][name]
    lr = float(ttrain.make_lr_schedule(ranks["job"]["steps"][name]["cfg"], 100)(0))
    start = ranks["job"]["sd"]
    for n, p in ref["params"].items():
        g = ref["grads"][n]
        big = (g.abs() > 1e-3 * g.abs().max().clamp(min=1e-30)).numpy()
        rounding = 2 * float(np.spacing(np.float32(p.abs().max())))
        du_ref = (p - start[n]).numpy()[big]
        du_got = (got["params"][n] - start[n]).numpy()[big]
        np.testing.assert_allclose(du_got, du_ref, rtol=0, atol=1e-4 * lr + rounding,
                                   err_msg=n)
        np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), rtol=0,
                                   atol=2 * lr + rounding, err_msg=n)


@pytest.mark.parametrize("name", STEPS)
def test_loss_ema_and_score_statistics_match(ranks, name):
    ref = ranks["ref"][name]
    for r in ranks["ranks"]:
        got = r["steps"][name]
        np.testing.assert_allclose(float(got["loss_ema"]), float(ref["loss_ema"]), rtol=1e-6)
        for k in ("mean", "var"):
            assert _rel(got["bn"][k], ref["bn"][k]) <= 1e-3, k
    moved = ref["bn"]["mean"].abs().max() > 0
    assert moved, "the score BatchNorm's statistics did not move"


@pytest.mark.parametrize("name", STEPS)
def test_ranks_hold_equal_state_after_the_step(ranks, name):
    """Gradients, parameters, loss_ema and the score statistics bit-equal
    on both ranks (checked over the group in the children)."""
    assert all(r["steps"][name]["same_on_every_rank"] for r in ranks["ranks"])
    assert [r["rank"] for r in ranks["ranks"]] == list(range(WORLD))


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


@pytest.mark.parametrize("key", UNIT_SUMS + UNIT_EQUAL + UNIT_ROWS)
def test_each_batch_wide_reduction_matches(ranks, key):
    err = _unit_errors(ranks, "units")[key]
    assert err <= 1e-6, (key, err)


@pytest.mark.parametrize("dtype", SCORE_DTYPES)
def test_score_head_on_captured_rows_matches_one_process(ranks, dtype):
    """The card's ill-conditioned score rows: every rank holds the one
    process's loss, gradients and running statistics."""
    ref = ranks["score_rows"][dtype]
    rows = ranks["job"]["score_rows"]["rows"]
    assert [int((rows["rank"] == r).sum()) for r in range(WORLD)] == [10, 13]
    assert float(rows["pose_cov"].abs().max()) > 4e4
    for r, got in enumerate(rank["score_rows"][dtype] for rank in ranks["ranks"]):
        errs = {n: _rel(got["grads"][n], g) for n, g in ref["grads"].items()}
        errs.update({k: _rel(got[k], ref[k]) for k in ("loss", "running_mean", "running_var")})
        print(f"rank {r} {dtype}: the score head within {max(errs.values()):.3g} of its scale")
        assert max(errs.values()) <= SCORE_DTYPES[dtype], (r, errs)


def test_negative_control_without_global_sums_fails(ranks):
    """With ``global_sum`` the identity in the ranks, every unit reduction
    and the step's losses and statistics miss the one-process values."""
    errs = _unit_errors(ranks, "control_units")
    assert all(e > 1e-3 for e in errs.values()), errs
    ref = ranks["ref"]["plain"]
    ctl = [r["control_step"] for r in ranks["ranks"]]
    loss_errs = {k: abs(sum(c["metrics"][k] for c in ctl) / WORLD - v) / max(abs(v), 1e-12)
                 for k, v in ref["metrics"].items() if k.startswith("loss") and v}
    print(f"negative control: losses off by up to {max(loss_errs.values()):.3g}")
    assert max(loss_errs.values()) > 1e-3
    assert abs(float(ctl[0]["loss_ema"]) - float(ctl[1]["loss_ema"])) > 0
    assert _rel(ctl[0]["bn"]["mean"], ref["bn"]["mean"]) > 1e-3


# ---- (c) distributed evaluation ------------------------------------------------------


def test_distributed_eval_gathers_every_index_once(ranks):
    for r in ranks["ranks"]:
        results = r["eval_results"]
        assert len(results) == EVAL_IMAGES and all(res is not None for res in results)


def test_each_rank_equals_a_one_process_run_over_its_shard(ranks):
    gathered = ranks["ranks"][0]["eval_results"]
    for r, (results, _) in enumerate(ranks["shard_runs"]):
        shard = set(parallel.dataset_shard(EVAL_IMAGES, r, WORLD).tolist())
        assert {i for i, res in enumerate(results) if res is not None} == shard
        for i in shard:
            for k, v in results[i].items():
                assert np.array_equal(gathered[i][k], v), (i, k)
    for other in ranks["ranks"][1:]:
        for a, b in zip(other["eval_results"], gathered):
            assert all(np.array_equal(a[k], b[k]) for k in b)


def test_distributed_ap_is_evaluate_of_the_gathered_list(ranks):
    ds = KITTI3DDataset(ranks["job"]["eval"]["root"], "train_list.txt")
    want = ds.evaluate(ranks["ranks"][0]["eval_results"], print_summary=False)
    for r in ranks["ranks"]:
        assert list(r["eval_ap"]) == list(want)
        assert all(r["eval_ap"][k] == v for k, v in want.items())


# ---- (d) the CLIs under torch.distributed.run ------------------------------------------


def torchrun(module, args, cwd, timeout=TIMEOUT):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(WORLD),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()), "-m", module,
           *args]
    env = child_env()
    env["OMP_NUM_THREADS"] = str(max(1, torch.get_num_threads() // WORLD))
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out


def test_tools_train_distributed_two_ranks(tmp_path):
    """Two CPU ranks over Gloo, a global batch of 4 (2 per rank), an epoch
    of 2 steps with a checkpoint, a validation and a log record a step:
    rank 0 alone writes the log and the checkpoint."""
    root, work = tmp_path / "kitti", tmp_path / "work"
    write_small_kitti(str(root), 8)
    opts = [f"data.train_root='{root}'", "data.train_list='train_list.txt'",
            "data.val_list='train_list.txt'", *TRAIN_OPTIONS, "train.total_epochs=1"]
    out = torchrun("monorun_tpu_torch.tools.train",
                   ["kitti_multiclass_lidar_supv", "--device", "cpu", "--distributed",
                    "--work-dir", str(work), "--max-steps", "2", "--cfg-options", *opts], REPO)
    log = [json.loads(ln) for ln in (work / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2], log   # 8 images: 2 global batches of 4
    assert all(np.isfinite(v) for r in log for v in r.values())
    assert sorted(os.listdir(work)) == ["config.txt", "step_2", "train_log.jsonl"]
    assert os.listdir(work / "step_2") == ["checkpoint.pt"]
    assert out.stdout.count("[e0 it2]") == 1, out.stdout    # one rank logged
    shutil.rmtree(work)


def test_tools_test_distributed_two_ranks(tmp_path):
    root = tmp_path / "kitti"
    make_mini_kitti(str(root), n_images=EVAL_IMAGES, seed=1)
    summary, results = tmp_path / "ap.json", tmp_path / "results"
    torchrun("monorun_tpu_torch.tools.test",
             ["kitti_multiclass", "--val-set", "--device", "cpu", "--distributed",
              "--batch-size", "4", "--summary-file", str(summary), "--result-dir",
              str(results), "--cfg-options", f"data.train_root='{root}'",
              "data.val_list='train_list.txt'", *TINY_OPTIONS], REPO)
    ap = json.loads(summary.read_text())
    assert ap and all(np.isfinite(v) for v in ap.values())
    assert len(os.listdir(results)) == EVAL_IMAGES


def test_tools_test_refuses_a_batch_that_does_not_divide(monkeypatch):
    from monorun_tpu_torch.tools import test as tools_test

    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", LOCAL_WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="--batch-size 3 must be a multiple of the mesh "
                                         "size 2"):
        tools_test.main(["kitti_multiclass", "--device", "cpu", "--distributed",
                         "--batch-size", "3"])
    assert parallel.world_size() == 1


@pytest.mark.parametrize("tool", ["train", "test"])
def test_distributed_without_the_launch_environment_raises(monkeypatch, tool):
    import importlib

    for k in parallel.mesh.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    main = importlib.import_module(f"monorun_tpu_torch.tools.{tool}").main
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        main(["kitti_multiclass", "--device", "cpu", "--distributed"])
