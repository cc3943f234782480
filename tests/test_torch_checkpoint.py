"""The port's checkpoints against the JAX package's rule, at the tiny
training configuration.

A save and load is bit-exact, ``latest_checkpoint`` follows JAX's rule,
and at the tiny training configuration (``test_torch_train_step.py``'s, at
``test_torch_train_cli.py``'s narrow widths) steps 3-4 after a save at step 2
and a load into a fresh model and optimizer give the uninterrupted run's
losses and parameters, bit for bit (on the CPU, with PyTorch's
deterministic algorithms; on the GPU the RoIAlign backward has no atomics
and repeats bit for bit, but cuDNN's convolution backward does not unless
``torch.use_deterministic_algorithms`` is on). Part (c) of
``tests/test_torch_train_loop.py``'s plan, in a file of its own of at most
3 tests, which xdist hands out late (ROADMAP's test-time budget).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from monorun_tpu.utils.checkpoint import latest_checkpoint as jlatest
from monorun_tpu_torch import train as ttrain
from monorun_tpu_torch.config import apply_overrides
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models.detector import MonoRUn, init_random_weights
from monorun_tpu_torch.utils import checkpoint as tckpt
from monorun_tpu_torch.utils.synthetic import synthetic_train_batch

from test_torch_train_cli import NARROW_OPTIONS
from test_torch_train_step import tiny_train_config
from torch_share import cpu_share  # noqa: F401


def tiny_config():
    return apply_overrides(tiny_train_config(tget_config), NARROW_OPTIONS)


def _model(cfg, seed):
    return init_random_weights(MonoRUn(cfg), torch.Generator().manual_seed(seed))


def test_checkpoint_round_trip_is_bit_exact(ckpt_dir):
    """Every tensor of the model (parameters and buffers), the optimizer's
    moments and count, and the train state come back bit-equal."""
    cfg = tiny_config()
    model = _model(cfg, 1)
    for name, b in model.named_buffers():
        if b.is_floating_point():
            b.uniform_(0.5, 1.5)
    opt = ttrain.make_optimizer(cfg, model, 100)
    gen = torch.Generator().manual_seed(2)
    for _ in range(2):
        opt.step([torch.randn(p.shape, generator=gen) for p in opt.params])
    state = ttrain.TrainState(7, torch.tensor(0.913))
    path = tckpt.save_checkpoint(str(ckpt_dir), model, opt, state, 7)
    assert path == str(ckpt_dir / "step_7")

    fresh = _model(cfg, 3)
    fresh_opt = ttrain.make_optimizer(cfg, fresh, 100)
    got = tckpt.load_checkpoint(path, fresh, fresh_opt)
    assert got.step == 7 and torch.equal(got.loss_ema, state.loss_ema)
    ref, out = model.state_dict(), fresh.state_dict()
    assert list(out) == list(ref)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    assert fresh_opt.count == opt.count == 2
    for a, b, t in zip(opt.mu + opt.nu, fresh_opt.mu + fresh_opt.nu, opt.trainable * 2):
        assert (a is None and b is None) if not t else torch.equal(a, b)
    assert any(t is None for t in fresh_opt.mu)       # the frozen stages keep no moments
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(ckpt_dir / "step_8"), fresh)


def test_latest_checkpoint_picks_the_largest_step(tmp_path):
    assert tckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    assert tckpt.latest_checkpoint(str(tmp_path)) is None is jlatest(str(tmp_path))
    for name in ("step_2", "step_10", "step_9", "step_x", "step_11.tmp", "xstep_12"):
        os.makedirs(tmp_path / name)
    got = tckpt.latest_checkpoint(str(tmp_path))
    assert got == jlatest(str(tmp_path)) == os.path.join(str(tmp_path), "step_10")


@pytest.fixture
def ckpt_dir(tmp_path):
    """``tmp_path``, removed after the test."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms: with several threads a CPU step
    is not bitwise repeatable without them (XLA's CPU steps are)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_resume_is_bit_exact_at_the_step_level(ckpt_dir, deterministic):
    """Steps 1-4 with seeded draws, saved after step 2, against a load of
    that checkpoint into a fresh model and optimizer and steps 3-4: the
    same losses and parameters, bit for bit (``tests/test_convergence.py``'s
    check of JAX)."""
    cfg = tiny_config()
    batches = [{k: torch.as_tensor(v) for k, v in synthetic_train_batch(
        cfg, 1, (64, 128), num_gt=6, num_pts=32, seed=s).items()} for s in (0, 1)]

    def run(model, opt, state, steps):
        losses = []
        for i in steps:
            state, m = ttrain.train_step(model, opt, state, batches[i % 2],
                                         generator=torch.Generator().manual_seed(1000 + i))
            losses.append(float(m["total_loss"]))
        return state, losses

    def fresh(seed):
        model = _model(cfg, seed)
        return model, ttrain.make_optimizer(cfg, model, 100), ttrain.TrainState(
            0, torch.ones(()))

    model, opt, state = fresh(5)
    state, first = run(model, opt, state, range(2))
    path = tckpt.save_checkpoint(str(ckpt_dir), model, opt, state, state.step)
    _, rest = run(model, opt, state, range(2, 4))
    assert all(np.isfinite(first + rest))

    model2, opt2, _ = fresh(6)
    state2 = tckpt.load_checkpoint(path, model2, opt2)
    assert state2.step == 2
    _, resumed = run(model2, opt2, state2, range(2, 4))
    assert resumed == rest
    ref, got = model.state_dict(), model2.state_dict()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
