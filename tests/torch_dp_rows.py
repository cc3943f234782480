"""Where the score rows of a data-parallel step differ from one process's
(ROADMAP Queue 3 item 10). No JAX; runs on the card.

    python tests/torch_dp_rows.py [OUT_DIR]        # default build/dp_rows

The forward of ``chip_smoke.py`` phase 16's step at the training init
(``create_train_state``, seed 0): kitti_multiclass at full width in
float32, a ``synthetic_train_batch`` of 6 (seed 0), the global draws
(``utils/draws.py:train_draws``, a generator seeded 4), the loss schedule
of step 0. It runs forward only, and is captured at each stage a score
row passes: the backbone's and the FPN's outputs, the proposals, the
PnP's inputs and outputs, and the score head's inputs with its loss's
targets and weights. Three runs:

(a) one process on the batch of 6;
(b) one process on each half, a batch of 3, with that half's draws;
(c) two Gloo ranks on the card, each on its half (world 2).

Prints one JSON line ``dp_rows``:

- ``b_vs_a``: per stage, the largest |(b) - (a)| over the largest |(a)|
  (the proposals and the PnP's inlier masks: the rows that differ);
- ``c_vs_b``: the same for the ranks against (b), stage by stage from the
  proposals on: 0 when the world adds nothing to the batch size (the
  score loss's weights, which are the global batch's in (c), against
  (a)'s);
- ``stem``: the first convolution alone on the 6 images and on each 3;
  ``bbox_fcs``: each FC of the bbox head alone on its input in (a), all
  rows and each half;
- ``rows``: the valid score rows of (a) that (b) moves by over 1e-3 of
  the row's scale, with their largest |pose_cov|;
- ``pnp_float64``: the PnP again in float64 on (a)'s inputs and on (b)'s:
  how far its outputs then differ, and how far float32 is from float64 on
  (a)'s inputs. Rows that float64 still moves are moved by their inputs.

Writes ``OUT_DIR/score_rows.npz``, (a)'s valid score rows (the inputs of
``ScoreHead``, the loss's targets and weights, each row's rank at world 2),
which ``tests/test_torch_parallel.py`` holds the score head to across two
ranks on the CPU. The ranks' captures go to ``build/dp_rows/rank{r}.pt``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing
import os
import socket
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from monorun_tpu_torch import parallel  # noqa: E402
from monorun_tpu_torch.config import apply_loss_schedule, get_config  # noqa: E402
from monorun_tpu_torch.models import detector as detector_module  # noqa: E402
from monorun_tpu_torch.models.resnet import nchw  # noqa: E402
from monorun_tpu_torch.models.score_head import ScoreHead  # noqa: E402
from monorun_tpu_torch.ops import roi_align_cuda as rc  # noqa: E402
from monorun_tpu_torch.train import create_train_state  # noqa: E402
from monorun_tpu_torch.utils.draws import train_draws  # noqa: E402
from monorun_tpu_torch.utils.synthetic import synthetic_train_batch  # noqa: E402

BATCH, WORLD = 6, 2
WORK = REPO / "build" / "dp_rows"
SCORE_ARGS = ("reg_fc_out", "yaw", "t_vec", "pose_cov", "dimensions", "valid")
PNP_ARGS = ("coords_2d", "istd", "coords_3d", "cam_mats", "u_range", "v_range")
PNP_OUT = ("valid", "yaw", "t_vec", "pose_cov", "inlier_mask")
ALIGNS = ("sampled_7x7", "positive_7x7", "positive_14x14")


def step_config():
    """kitti_multiclass at full width in float32, as phase 16's step."""
    return dataclasses.replace(get_config("kitti_multiclass"), compute_dtype="float32")


def step_inputs(cfg, device):
    """Phase 16's global batch and draws on ``device``."""
    H, W = cfg.data.pad_height, cfg.data.pad_width
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in synthetic_train_batch(cfg, BATCH, (H, W), seed=0).items()}
    gen = torch.Generator(device=device).manual_seed(4)
    draws = train_draws(cfg, BATCH, (H, W), batch["gt_boxes"].shape[1], gen, device)
    return batch, draws


@contextlib.contextmanager
def patched(owner, name, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def captured_forward(model, batch, draws):
    """One training forward (no gradient), and what it passed at each stage:
    ``backbone`` and ``fpn`` (the levels), ``proposals`` (boxes, valid),
    ``align`` (the three aligns' outputs, in run order), ``bbox_head``
    (its logits and deltas), ``pnp`` (the PnP's array inputs, its keyword
    inputs and its outputs), ``score`` (``SCORE_ARGS``, and the loss's
    ``targets`` and ``weight``)."""
    seen = {"align": []}
    hooks = [model.backbone.register_forward_hook(
                 lambda m, i, o: seen.setdefault("backbone", o)),
             model.neck.register_forward_hook(lambda m, i, o: seen.setdefault("fpn", o)),
             model.roi_head.bbox_head.register_forward_hook(
                 lambda m, i, o: seen.setdefault("bbox_head", o))]
    align = model._align

    def aligned(*args, **kw):
        out = align(*args, **kw)
        seen["align"].append(out)
        return out
    get_proposals, pnp_uncert = detector_module.get_proposals, detector_module.pnp_uncert
    score_forward, score_loss = ScoreHead.forward, detector_module.sigmoid_bce_loss

    def proposals(*args, **kw):
        out = get_proposals(*args, **kw)
        seen.setdefault("proposals", out)
        return out

    def pnp(*args, **kw):
        out = pnp_uncert(*args, **kw)
        seen["pnp"] = dict(args=dict(zip(PNP_ARGS, args)), kw=kw,
                           out={k: getattr(out, k) for k in PNP_OUT})
        return out

    def head(self, *args, train=False, valid=None):
        if train:
            seen["score"] = dict(zip(SCORE_ARGS, (*args, valid)))
        return score_forward(self, *args, train=train, valid=valid)

    def loss(logits, targets, weight=None, **kw):
        seen["score"].update(targets=targets[:, 0], weight=weight[:, 0])
        return score_loss(logits, targets, weight=weight, **kw)

    try:
        with torch.no_grad(), \
                patched(detector_module, "get_proposals", proposals), \
                patched(detector_module, "pnp_uncert", pnp), \
                patched(ScoreHead, "forward", head), \
                patched(detector_module, "sigmoid_bce_loss", loss), \
                patched(model, "_align", aligned):
            state_ema = torch.ones((), device=batch["images"].device)
            model.train_forward(batch, state_ema, draws, cfg=apply_loss_schedule(model.cfg, 0))
    finally:
        for h in hooks:
            h.remove()
    return seen


def rows_of(seen):
    """The per-row captures (proposals per image, the PnP, the score rows),
    detached: what runs (b) and (c) are compared on."""
    boxes, valid = seen["proposals"]
    cls, deltas = seen["bbox_head"]
    return dict(proposals=boxes, proposals_valid=valid,
                **{f"align.{name}": t for name, t in zip(ALIGNS, seen["align"])},
                **{"bbox_head.cls": cls, "bbox_head.deltas": deltas},
                **{f"pnp_in.{k}": v for k, v in seen["pnp"]["args"].items()},
                **{f"pnp_out.{k}": v for k, v in seen["pnp"]["out"].items()},
                **{f"score.{k}": v for k, v in seen["score"].items()})


def concat(parts):
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def rel(got, ref):
    """max |got - ref| over max |ref| (0 for equal tensors), in float64."""
    got, ref = got.double(), ref.double()
    if torch.equal(got, ref):
        return 0.0
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def compare(got, ref):
    """Per key of ``ref``: booleans as the count of rows that differ, the
    rest as ``rel``."""
    out = {}
    for k, v in ref.items():
        g = got[k]
        if v.dtype == torch.bool:
            out[k] = int((g != v).reshape(v.shape[0], -1).any(1).sum())
        else:
            out[k] = rel(g, v)
    return out


def pose_features(score):
    """The score head's 17 inputs before its pose norm, zero on invalid
    rows (``ScoreHead.forward``)."""
    ix, iy = torch.tril_indices(4, 4, device=score["pose_cov"].device)
    x = torch.cat([score["yaw"], score["t_vec"], score["pose_cov"][:, ix, iy],
                   score["dimensions"]], 1)
    return torch.where(score["valid"][:, None], x, torch.zeros_like(x))


def pnp_rerun(pnp, dtype):
    """The captured PnP call again, its inputs cast to ``dtype``."""
    args = [pnp["args"][k].to(dtype) for k in PNP_ARGS]
    kw = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
          for k, v in pnp["kw"].items()}
    out = detector_module.pnp_uncert(*args, **kw)
    return {k: getattr(out, k) for k in PNP_OUT}


def row_rel(got, ref):
    """Per row, the largest |got - ref| over the row's largest |ref|."""
    g, r = got.double().flatten(1), ref.double().flatten(1)
    return (g - r).abs().amax(1) / r.abs().amax(1).clamp(min=1e-30)


def pnp_outputs_rel(got, ref):
    """Per row, the PnP's pose and covariance as ``row_rel``."""
    pose = lambda o: torch.cat([o["yaw"], o["t_vec"], o["pose_cov"].flatten(1)], 1)  # noqa: E731
    return row_rel(pose(got), pose(ref))


def rank_main(rank, port):
    """One rank of run (c): its half of the batch over Gloo on the card."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    with parallel.process_group(backend="gloo", device="cuda:0") as dev:
        rc.build_all()
        cfg = step_config()
        model, _, _ = create_train_state(cfg, total_steps=1000, device=dev, seed=0)
        batch, draws = step_inputs(cfg, dev)
        seen = captured_forward(model, parallel.shard_batch(batch, rank, WORLD),
                                parallel.shard_batch(draws, rank, WORLD))
        torch.save({k: v.cpu() for k, v in rows_of(seen).items()}, WORK / f"rank{rank}.pt")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(timeout=900):
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, port)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * WORLD:
        raise RuntimeError(f"the ranks exited with {codes}")
    return [torch.load(WORK / f"rank{r}.pt") for r in range(WORLD)]


def save_rows(path, score):
    """(a)'s valid score rows as ``score_rows.npz``, each with its rank at
    world 2 (the rows are the ranks' contiguous halves)."""
    valid = score["valid"]
    rank = torch.arange(valid.numel(), device=valid.device) // (valid.numel() // WORLD)
    arrays = {k: score[k][valid].float().cpu().numpy()
              for k in ("reg_fc_out", "yaw", "t_vec", "pose_cov", "dimensions",
                        "targets", "weight")}
    np.savez_compressed(path, rank=rank[valid].to(torch.int8).cpu().numpy(), **arrays)
    return path.stat().st_size


def main(out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    WORK.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    rc.build_all()
    cfg = step_config()
    model, _, _ = create_train_state(cfg, total_steps=1000, device="cuda", seed=0)
    dev = next(model.parameters()).device
    batch, draws = step_inputs(cfg, dev)

    a = captured_forward(model, batch, draws)
    halves = [captured_forward(model, parallel.shard_batch(batch, r, WORLD),
                               parallel.shard_batch(draws, r, WORLD)) for r in range(WORLD)]
    rows_a, rows_b = rows_of(a), concat([rows_of(h) for h in halves])
    b_vs_a = {f"backbone.C{i + 2}": rel(torch.cat([h["backbone"][i] for h in halves]), t)
              for i, t in enumerate(a["backbone"])}
    b_vs_a.update({f"fpn.P{i}": rel(torch.cat([h["fpn"][i] for h in halves]), t)
                   for i, t in enumerate(a["fpn"])})
    b_vs_a.update(compare(rows_b, rows_a))

    # the first convolution alone: does a batch of 3 round as one of 6?
    with torch.no_grad():
        x = nchw(batch["images"].float())
        stem = model.backbone.conv1(x)
        stem_halves = torch.cat([model.backbone.conv1(x[3 * r:3 * r + 3]) for r in range(WORLD)])
        stem_rel = rel(stem_halves, stem)
        # the bbox head's FCs, each alone on its input in (a): all rows, then each half
        head = model.roi_head.bbox_head
        x = rows_a["align.sampled_7x7"].permute(0, 3, 1, 2).flatten(1)
        bbox_fcs = {}
        for name, fc in [("shared_fcs.0", head.shared_fcs[0]), ("shared_fcs.1", head.shared_fcs[1]),
                         ("fc_cls", head.fc_cls), ("fc_reg", head.fc_reg)]:
            bbox_fcs[name] = rel(torch.cat([fc(h) for h in x.chunk(WORLD)]), fc(x))
            if name.startswith("shared"):
                x = torch.relu(fc(x))
    pnp_halves = [h["pnp"] for h in halves]
    del a["backbone"], a["fpn"], halves
    torch.cuda.empty_cache()

    ranks = run_ranks()
    rows_c = {k: v.to(dev) for k, v in concat(ranks).items()}
    # the score loss's weights are the global batch's in (c), the half's in (b)
    c_vs_b = compare(rows_c, {k: v for k, v in rows_b.items() if k != "score.weight"})
    c_vs_b["score.weight against (a)"] = rel(rows_c["score.weight"], rows_a["score.weight"])

    # the score rows that (b) moves, and the PnP again in float64
    score_a = {k[len("score."):]: v for k, v in rows_a.items() if k.startswith("score.")}
    score_b = {k[len("score."):]: v for k, v in rows_b.items() if k.startswith("score.")}
    valid = score_a["valid"]
    moved = row_rel(pose_features(score_b), pose_features(score_a))
    moved_rows = (moved > 1e-3) & valid
    cov_max = score_a["pose_cov"].double().abs().flatten(1).amax(1)
    inlier_flip = (rows_b["pnp_out.inlier_mask"] != rows_a["pnp_out.inlier_mask"]).any(1)
    pnp_b = dict(args=concat([h["args"] for h in pnp_halves]),
                 kw={k: torch.cat([h["kw"][k] for h in pnp_halves]) if torch.is_tensor(v) else v
                     for k, v in pnp_halves[0]["kw"].items()})
    f64_a, f64_b = pnp_rerun(a["pnp"], torch.float64), pnp_rerun(pnp_b, torch.float64)
    f32_a = a["pnp"]["out"]
    f64_moved = pnp_outputs_rel(f64_b, f64_a)
    f32_vs_f64 = pnp_outputs_rel(f32_a, f64_a)
    both_valid = f64_a["valid"] & f64_b["valid"]
    result = dict(
        config="kitti_multiclass float32, training init, forward of phase 16's step",
        batch=BATCH, world=WORLD, n_rows=int(valid.numel()), valid_rows=int(valid.sum()),
        b_vs_a=b_vs_a, c_vs_b=c_vs_b, stem=stem_rel, bbox_fcs=bbox_fcs,
        rows=dict(
            moved_over_1e_3=int(moved_rows.sum()),
            moved_max=float(moved[valid].max()) if valid.any() else 0.0,
            moved_index=moved_rows.nonzero()[:, 0].tolist(),
            moved_rel=moved[moved_rows].tolist(),
            moved_max_abs_pose_cov=cov_max[moved_rows].tolist(),
            moved_with_inlier_flip=int((moved_rows & inlier_flip).sum()),
            inlier_flips_valid_rows=int((inlier_flip & valid).sum()),
            pnp_inputs_rel_on_moved=[
                max(float(row_rel(rows_b[f"pnp_in.{k}"], rows_a[f"pnp_in.{k}"])[i])
                    for k in PNP_ARGS) for i in moved_rows.nonzero()[:, 0].tolist()],
            max_abs_pose_cov=float(cov_max[valid].max()) if valid.any() else 0.0),
        pnp_float64=dict(
            b_vs_a_over_1e_3=int(((f64_moved > 1e-3) & both_valid).sum()),
            b_vs_a_on_moved=f64_moved[moved_rows].tolist(),
            b_vs_a_max_valid=float(f64_moved[both_valid].max()) if both_valid.any() else 0.0,
            valid_differs=int((f64_a["valid"] != f64_b["valid"]).sum()),
            inlier_flips=int((f64_a["inlier_mask"] != f64_b["inlier_mask"]).any(1).sum()),
            float32_vs_float64_on_a_max_valid=float(f32_vs_f64[valid].max())
            if valid.any() else 0.0,
            float32_vs_float64_on_moved=f32_vs_f64[moved_rows].tolist()),
        npz_bytes=save_rows(out_dir / "score_rows.npz", score_a),
        seconds=time.perf_counter() - t0)
    print("dp_rows " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(Path(sys.argv[1]) if len(sys.argv) > 1 else WORK)
