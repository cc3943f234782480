"""Data-parallel draws equal a one-process step's: the training step's random
inputs are the global batch's at every world size, as in JAX's loop (one key
per step for the whole batch, ``monorun_tpu/apis/train.py``).

(a) ``utils/draws.py:train_draws``, the one statement of the step's draws,
gives each the width of the forward's own tensor (the tiny training
configuration, with and without ``refined_reassign``), and a step handed
no draws draws those.

(b) ``train_detector`` with ``world_size``/``rank`` patched to (2, r) and
the step stubbed hands ``train_step`` rank r's rows of the draws that a
run at world size 1 hands its step over the same global batches: the
per-image fields' rows r*b..(r+1)*b, the per-slot fields' rows r*b*P..
(r+1)*b*P (P = ``train.max_pos``). No processes, no JAX compile.
"""

import dataclasses

import pytest
import torch

from monorun_tpu_torch.apis import train as tapi
from monorun_tpu_torch import train as ttrain
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models.detector import MonoRUn, init_random_weights
from monorun_tpu_torch.models.rpn import get_proposals
from monorun_tpu_torch.utils.draws import TrainDraws, train_draws
from monorun_tpu_torch.utils.synthetic import synthetic_train_batch

from test_torch_train_loop import small_data, write_small_kitti
from test_torch_train_step import tiny_train_config
from torch_share import cpu_share  # noqa: F401

PER_IMAGE = ("rpn_noise", "rcnn_noise", "rcnn_noise_refined")


def _leaves(draws: TrainDraws):
    """(field, tensor) of every drawn tensor, pairs and mask triples flattened."""
    out = []
    for name, v in zip(TrainDraws._fields, draws):
        for t in (v if isinstance(v, tuple) else (v,)):
            if t is not None:
                out.append((name, t))
    return out


@pytest.mark.parametrize("refined", [False, True])
def test_train_draws_are_the_forwards_own(refined):
    """``train_draws``' widths, taken from the configuration and the canvas,
    are those of the forward's own tensors (the anchors of every RPN level,
    the proposals and GT slots, the positive slots' heads), on a canvas of
    whole strides and on one whose coarsest RPN level is not; and a step handed no draws takes
    ``train_draws``' from its generator."""
    r = dataclasses.replace
    cfg = tiny_train_config(tget_config)
    cfg = r(cfg, train=r(cfg.train, refined_reassign=refined))
    tr, G = cfg.train, 6
    model = init_random_weights(MonoRUn(cfg), torch.Generator().manual_seed(0))
    for B, H, W in ((1, 96, 160), (2, 64, 128)):
        batch = {k: torch.as_tensor(v)
                 for k, v in synthetic_train_batch(cfg, B, (H, W), num_gt=G, num_pts=32,
                                                   seed=0).items()}
        draws = train_draws(cfg, B, (H, W), G, torch.Generator().manual_seed(7), "cpu")
        with torch.no_grad():
            feats = model.extract_feats(batch["images"])
            cls, reg = model.rpn_head(feats[cfg.rpn.starting_level:])
            proposals, _ = get_proposals(cls, reg, cfg.rpn, (H, W), cfg.rpn.train_nms_pre,
                                         cfg.rpn.nms_post, valid_shapes=batch["img_shapes"])
        n, C = B * tr.max_pos, cfg.neck.out_channels
        F = cfg.global_head.fc_out_channels
        want = dict(
            rpn_noise=[(B, sum(c[0].numel() for c in cls))] * 2,
            rcnn_noise=[(B, proposals.shape[1] + G)] * 2,
            rcnn_noise_refined=[(B, tr.rcnn_num_samples + G)] * 2 if refined else [],
            global_masks=[(n, C), (n, F), (n, F)],
            noc_mask=[(n, C)],
            ransac_keys=[(n, cfg.pose_head.ransac_hypotheses, cfg.noc_head.dense_size ** 2)],
            score_uniform=[(n,)])
        for name in TrainDraws._fields:
            got = [tuple(t.shape) for f, t in _leaves(draws) if f == name]
            assert got == want[name], (H, W, name)
    with torch.no_grad():
        own, (own_losses, _) = model.train_forward(batch, torch.ones(()), TrainDraws(),
                                                   torch.Generator().manual_seed(7))
        given, (given_losses, _) = model.train_forward(batch, torch.ones(()), draws, None)
    assert torch.equal(own, given)
    for k, v in own_losses.items():
        assert torch.equal(v, given_losses[k]), k


def _run_loop(monkeypatch, cfg, workdir, world, me):
    """``train_detector`` at (world, me) with the step stubbed: the draws
    each step receives."""
    got = []

    def create_train_state(cfg, total_steps, device="cuda", seed=0):
        model = torch.nn.Linear(2, 1)
        return model, ttrain.TrainState(0, torch.ones(())), ttrain.AdamW(
            cfg, model.named_parameters(), total_steps)

    def train_step(model, opt, s, b, draws=TrainDraws(), generator=None, **kw):
        got.append((b["images"].shape[0], draws))
        m = {"total_loss": b["images"].sum() * 0, "nonfinite_grad_leaves": 0}
        return ttrain.TrainState(s.step + 1, s.loss_ema), m

    for name, value in (("create_train_state", create_train_state),
                        ("train_step", train_step), ("world_size", lambda: world),
                        ("rank", lambda: me), ("barrier", lambda: None),
                        ("replicate", lambda model: None)):
        monkeypatch.setattr(tapi, name, value)
    tapi.train_detector(cfg, str(workdir), max_steps=2, device="cpu")
    return got


def test_ranks_take_rows_of_the_world_one_draws(tmp_path, monkeypatch):
    root = tmp_path / "kitti"
    write_small_kitti(str(root), 8, seed=1)
    r = dataclasses.replace
    cfg = small_data(tget_config("kitti_multiclass_lidar_supv"), root)
    cfg = r(cfg, train=r(cfg.train, samples_per_device=2, total_epochs=1,
                         tensorboard=False, checkpoint_interval=0, eval_interval=0, seed=3))
    one = _run_loop(monkeypatch, r(cfg, train=r(cfg.train, samples_per_device=4)),
                    tmp_path / "w1", 1, 0)
    assert len(one) == 2 and all(rows == 4 for rows, _ in one)
    # world 1 hands its step the draws of one generator seeded seed + 1
    gen = torch.Generator().manual_seed(cfg.train.seed + 1)
    for _, draws in one:
        ref = train_draws(cfg, 4, (cfg.data.pad_height, cfg.data.pad_width),
                          cfg.data.max_gt, gen, "cpu")
        assert [n for n, _ in _leaves(draws)] == [n for n, _ in _leaves(ref)]
        for (name, got), (_, want) in zip(_leaves(draws), _leaves(ref)):
            assert torch.equal(got, want), name
    P = cfg.train.max_pos
    for me in (0, 1):
        two = _run_loop(monkeypatch, cfg, tmp_path / f"w2_{me}", 2, me)
        assert len(two) == 2
        for (rows, draws), (_, full) in zip(two, one):
            assert rows == 2
            assert len(_leaves(draws)) == len(_leaves(full))
            for (name, got), (_, whole) in zip(_leaves(draws), _leaves(full)):
                per = 2 if name in PER_IMAGE else 2 * P
                assert torch.equal(got, whole[me * per:(me + 1) * per]), name
