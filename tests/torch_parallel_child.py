"""One rank of ``tests/test_torch_parallel.py``'s two-process Gloo run, and
the helpers the test shares with it.

    python tests/torch_parallel_child.py JOB RANK WORLD PORT OUT_DIR

``JOB`` is a ``torch.save`` file the test writes (configs, weights, the
global batches and draws, the unit inputs, the mini-KITTI's root). The
rank joins the group through ``parallel.init_distributed`` (torchrun's
environment, set here) on the CPU, runs each case on its rows of the
global inputs and writes what it got to ``OUT_DIR/rank{RANK}.pt``; rank 0
also writes the step's gradients and parameters, which every rank holds
bit-equal (checked here over the group).
"""

import os
import sys
from typing import Dict

import numpy as np
import torch

from monorun_tpu_torch import train as ttrain
from monorun_tpu_torch.losses import robust_kl_loss, smooth_l1_loss
from monorun_tpu_torch.models.detector import MonoRUn
from monorun_tpu_torch.models.score_head import BatchNormSmooth, iou3d_balanced_sample_weights


def run_step(cfg, sd, batch, draws) -> Dict[str, object]:
    """One ``train_step`` from the weights ``sd``: the metrics, the
    gradients the optimizer was given (after the all-reduce), the
    parameters after the step, ``loss_ema``, the score BatchNorm's
    statistics and the number of rows that passed ``pose_ok``."""
    model = MonoRUn(cfg)
    model.load_state_dict(sd)
    opt = ttrain.make_optimizer(cfg, model, 100)
    seen = {}
    step, score = opt.step, model.roi_head.score_head.forward

    def keep_grads(grads):
        seen["grads"] = [g.detach().clone() for g in grads]
        step(grads)

    def keep_pose_ok(*args, **kw):
        seen["pose_ok"] = int(kw["valid"].sum())
        return score(*args, **kw)

    opt.step = keep_grads
    model.roi_head.score_head.forward = keep_pose_ok
    state, metrics = ttrain.train_step(model, opt, ttrain.TrainState(0, torch.ones(())),
                                       batch, draws)
    norm = model.roi_head.score_head.pose_norm
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads=dict(zip(opt.names, seen["grads"])),
        params={n: p.detach().clone() for n, p in model.named_parameters()},
        loss_ema=state.loss_ema.clone(), pose_ok=seen["pose_ok"],
        bn=dict(mean=norm.running_mean.clone(), var=norm.running_var.clone()),
    )


def run_units(u, score_cfg) -> Dict[str, torch.Tensor]:
    """Every batch-wide reduction alone on the (global or sharded) unit
    inputs: the weighted means (an ``avg_factor``, a weight, neither), the
    robust KL loss and its EMA, the score BatchNorm's training forward and
    statistics, the score sampler's weights."""
    pred, target, weight = u["pred"], u["target"], u["weight"]
    out = dict(
        avg_factor=smooth_l1_loss(pred, target, weight=weight,
                                  avg_factor=(weight > 0).sum()),
        weighted=smooth_l1_loss(pred, target, weight=weight),
        unweighted=smooth_l1_loss(pred, target),
    )
    out["kl"], out["kl_ema"] = robust_kl_loss(pred, target, u["logstd"], torch.tensor(1.0),
                                             weight=weight)
    bn = BatchNormSmooth(u["x"].shape[1], momentum=0.5)
    out["bn_out"] = bn(u["x"], train=True, valid=u["valid"])
    out["bn_mean"], out["bn_var"] = bn.running_mean, bn.running_var
    out["sampler"] = iou3d_balanced_sample_weights(score_cfg, u["ious"], u["uniform"],
                                                   valid=u["valid"])
    return out


def same_on_every_rank(tensors) -> bool:
    """Whether every rank holds tensors bit-equal to rank 0's."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    ok = torch.tensor([int(torch.equal(ref, flat))])
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok)


def without_global_sums():
    """Every module's ``global_sum`` set to the identity (the negative
    control: each rank's denominators and statistics its own); returns the
    undo."""
    from monorun_tpu_torch.parallel import mesh

    original = mesh.global_sum
    owners = [m for name, m in list(sys.modules.items())
              if name.startswith("monorun_tpu_torch") and getattr(m, "global_sum", None)
              is original]
    for m in owners:
        m.global_sum = lambda t: t

    def undo():
        for m in owners:
            m.global_sum = original
    return undo


def gather_cases():
    """``allgather_results`` of this process's shard of 7 and of 8 results."""
    from monorun_tpu_torch.parallel import allgather_results, dataset_shard

    out = {}
    for total in (7, 8):
        rng = np.random.default_rng(total)
        golden = {i: {"boxes": rng.normal(size=(4, 8)).astype(np.float32),
                      "valid": rng.integers(0, 2, size=(4,)).astype(bool)}
                  for i in range(total)}
        local = {int(i): golden[int(i)] for i in dataset_shard(total)}
        out[total] = allgather_results(local, total)
    return out


def main(job_path, rank, world, port, out_dir):
    from monorun_tpu_torch import parallel
    from monorun_tpu_torch.apis.inference import InferenceSession
    from monorun_tpu_torch.apis.test import run_eval
    from monorun_tpu_torch.data.kitti import KITTI3DDataset
    from monorun_tpu_torch.parallel import shard_batch

    job = torch.load(job_path, weights_only=False)
    torch.set_num_threads(job["threads"])
    torch.use_deterministic_algorithms(True)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device = parallel.init_distributed(device="cpu")
    assert device == torch.device("cpu") and parallel.world_size() == world
    out = {"rank": parallel.rank(), "gather": gather_cases()}

    units = shard_batch(job["units"], rank, world)
    out["units"] = run_units(units, job["score_cfg"])
    steps, grads = {}, {}
    for name, case in job["steps"].items():
        got = run_step(case["cfg"], job["sd"], shard_batch(case["batch"], rank, world),
                       shard_batch(case["draws"], rank, world))
        got["same_on_every_rank"] = same_on_every_rank(
            list(got["grads"].values()) + list(got["params"].values())
            + [got["loss_ema"], got["bn"]["mean"], got["bn"]["var"]])
        if rank == 0:
            grads[name] = dict(grads=got["grads"], params=got["params"])
        steps[name] = {k: v for k, v in got.items() if k not in ("grads", "params")}
    out["steps"] = steps

    undo = without_global_sums()
    try:
        out["control_units"] = run_units(units, job["score_cfg"])
        case = job["steps"]["plain"]
        got = run_step(case["cfg"], job["sd"], shard_batch(case["batch"], rank, world),
                       shard_batch(case["draws"], rank, world))
        out["control_step"] = {k: got[k] for k in ("metrics", "loss_ema", "bn")}
    finally:
        undo()

    ev = job["eval"]
    model = MonoRUn(ev["cfg"])
    model.load_state_dict(ev["sd"])
    session = InferenceSession(ev["cfg"], model, ev["batch"], device)
    ds = KITTI3DDataset(ev["root"], "train_list.txt")
    seen = []
    evaluate = ds.evaluate

    def keep(results, **kw):
        seen.append(results)
        return evaluate(results, **kw)

    ds.evaluate = keep
    out["eval_ap"] = run_eval(session, ds, batch_size=ev["batch"], print_summary=False,
                              progress=False, distributed=True)
    out["eval_results"] = seen[0]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    if rank == 0:
        torch.save(grads, os.path.join(out_dir, "rank0_grads.pt"))
    parallel.barrier()
    torch.distributed.destroy_process_group()
    print(f"[{rank}] DONE", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
