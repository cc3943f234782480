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
And ``train_detector`` at 2 ranks for one step with its validation on a
4-image small KITTI directory: each rank detects one of a one-process
run's batches, and the AP that rank 0 logs, and the gathered results,
equal a one-process ``_run_val`` on the trained weights, bitwise.

(d) The CLIs under ``torch.distributed.run`` are in
``tests/test_torch_parallel_cli.py``.

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

from test_dist_eval import _simulate_multiprocess_gather
from test_torch_eval_path import configs
from test_torch_train_cli import NARROW_OPTIONS
from test_torch_train_loop import small_data, write_small_kitti
from test_torch_train_step import tiny_train_config
from torch_parallel_child import gather_cases, run_step, run_units, score_head_on_rows
from torch_share import cpu_share  # noqa: F401

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
    return dict(job=job, ref=ref, units=units, ranks=got, grads=grads, shard_runs=shard_runs,
                score_rows=score_rows, val_ref=val_ref)


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


def test_train_detector_validates_on_every_rank(ranks):
    """``train_detector``'s validation at two ranks: each rank detects one
    of the two batches of 2 that a one-process run makes, with that run's
    seed (the batch's first index), and the AP that rank 0 alone logs,
    and every rank evaluated, is a one-process ``_run_val``'s on the same
    weights, per-image results bitwise."""
    loops = [r["val_loop"] for r in ranks["ranks"]]
    assert [v["runs"] for v in loops] == [[(0, 2)], [(2, 2)]]
    assert [len(v["logged"]) for v in loops] == [1, 0]
    step, ap = loops[0]["logged"][0]
    results, want = ranks["val_ref"]
    assert step == 1 and list(ap) == list(want) and ap == want
    assert sum(int(r["valid"].sum()) for r in results) >= VAL_IMAGES
    for v in loops:
        (gathered,) = v["results"]
        assert len(gathered) == len(results) == VAL_IMAGES
        for got, ref in zip(gathered, results):
            assert sorted(got) == sorted(ref)
            assert all(np.array_equal(got[k], ref[k]) for k in ref)
