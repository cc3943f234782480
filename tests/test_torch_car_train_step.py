"""The LiDAR-supervised single-class preset's training forward, port against
JAX, at a tiny configuration.

``tests/test_torch_train_step.py``'s case at ``kitti_car_lidar_supv``: the
configuration of ``tests/test_train_step.py`` (ResNet-26, 64x128 images,
batch 2, 2 MC samples, 2 LM iterations) of the car preset, so one class,
the car anchors, the class-agnostic NOC head under dropout2d 0.5 and
``loss_noc`` from the LiDAR points. JAX variables of the training init
(``create_train_state``, as there) with non-trivial values are carried
over by ``from_jax_train_state``, and every
random draw of the step is computed with the JAX calls on the JAX step's
own split keys and injected as ``TrainDraws``. JAX's side is one
``jax.jit`` of ``jax.value_and_grad`` of ``_train_forward``, computed once
per test run (``run_shared``, keyed by the preset and every size); the
optimizer does not depend on the preset and
``tests/test_torch_train_step.py`` holds it. The batch is
``synthetic_train_batch`` of each package, held equal.

Tolerances as there: every loss to 1e-5 relative (1e-3 after the PnP),
each parameter's gradient to 1e-4 of its leaf's largest entry. Two
findings shape the gradient check (ROADMAP Queue 3 item 13):

- At this seed one ReLU of the NOC head's first conv (RoI 10, channel
  129, cell (9, 10)) sits within 2.2e-6 of zero, and the summation order
  decides its side. JAX's jitted sum and the port's at one thread give
  -2.7e-8, so the gradient stops there; the port's at 8 threads gives
  +2.2e-6, which moves ``noc_head/conv0``'s gradient by 8.8e-4 of its
  scale and the backbone's by up to 1.6e-4. So the port's side runs at
  one thread, as a worker of a six-worker run on eight cores runs it
  (``torch_share.cpu_share``), and the test asserts that the unit is on
  JAX's side before it compares a gradient, so that a changed summation
  order fails as that and not as a gradient mismatch.
  JAX's float64 ``conv0`` gradient is 8.8e-4 of its scale from JAX's
  float32 one, the gap of the port's 8-thread sum, so float64 puts the
  unit above zero: the test holds the port to JAX's float32 side, which
  is not the exact one.
- JAX's jitted float32 gradient of a leaf can be further than 1e-4 of
  its scale from the exact one: ``noc_head/upsample/content_encoder/kernel``
  is 1.18e-4 from JAX's own forward in float64 (the port 4.2e-6). Such a
  leaf of the NOC head (at most two) is held to JAX's float64 gradient at
  1e-4 instead, and JAX's float32 one must be the further from it. The
  float64 arbiter is JAX's ``_train_forward`` under ``jax_enable_x64`` on
  the same variables, batch and draws, differentiated in the NOC head's
  parameters only (``torch_float64_refs.train_x64``, a process of its own
  that this file starts), so it shares no code with the port. Its losses
  that reach the NOC head, and those of the second stage, are held to
  JAX's float32 ones at ``check_loss``'s tolerance, which shows that it
  took the same draws and samples. The RPN's two are not: in float32 three
  anchors tie a GT's largest IoU exactly and are matched to it
  (``monorun_tpu/targets/assigner.py:75``), in float64 they do not, so
  float64 moves ``loss_rpn_cls`` by 1.3 % and the backbone's gradients,
  and a leaf outside the NOC head has no arbiter.

One test, so that xdist hands this file out last, after the JAX
package's long tests other than ``tests/test_train_step.py`` have ended
(ROADMAP's test-time budget).
"""

import contextlib
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu.config import get_config
from monorun_tpu.models.detector import _train_forward
from monorun_tpu.train import create_train_state
from monorun_tpu.utils.synthetic import synthetic_train_batch
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models.detector import MonoRUn
from monorun_tpu_torch.utils.synthetic import synthetic_train_batch as tsynthetic_train_batch
from monorun_tpu_torch.utils.weights import from_jax_train_state, to_jax_leaves

from test_torch_modules import _randomize
from test_torch_train_step import (
    LOSSES, B, H, W, _flat, _rel, check_loss, draw_arrays, draw_counts,
    jax_train_draws, tiny_train_config, train_draws_of,
)
import torch_float64_refs
from torch_share import cpu_share, load_tree, run_shared, save_tree  # noqa: F401

PRESET = "kitti_car_lidar_supv"
BATCH = dict(num_gt=6, num_pts=32)
JAX_FORWARD = (f"tiny_train_config({PRESET}), float32, B {B}, {H}x{W}, "
               "synthetic_train_batch(num_gt=6, num_pts=32), create_train_state(PRNGKey(0), "
               "total_steps=100), _randomize(seed 0), step key PRNGKey(1), value_and_grad; "
               "in float64, value_and_grad in noc_head")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE = (10, 129, 9, 10)      # (RoI, channel, row, column) of the NOC head's first conv
SCOPE = "noc_head"          # the module whose gradients the float64 arbiter gives
NOT_RPN = ("loss_cls", "loss_bbox", "loss_dim", "loss_noc", "loss_proj", "loss_calib",
           "loss_score", "mean_iou")


def jax_forward():
    """JAX's train forward and its gradients, once per test run: the
    randomized variables, the batch, the draws of the step key, the losses,
    ``loss_ema`` and the gradients, as arrays; and under ``x64`` the float64
    arbiter's losses and ``SCOPE``'s gradients."""
    def compute():
        cfg = tiny_train_config(get_config, PRESET)
        model, state, _ = create_train_state(cfg, jax.random.PRNGKey(0), total_steps=100,
                                             image_shape=(H, W))
        variables = _randomize({"params": state.params, "batch_stats": state.batch_stats})
        params = jax.tree.map(jnp.asarray, variables["params"])
        stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
        batch_np = synthetic_train_batch(cfg, B, (H, W), **BATCH)
        key = jax.random.PRNGKey(1)

        def loss_fn(p):
            (total, (metrics, new_ema)), _ = model.apply(
                {"params": p, "batch_stats": stats}, jax.tree.map(jnp.asarray, batch_np),
                key, state.step, state.loss_ema, method=_train_forward,
                mutable=["batch_stats"])
            return total, (metrics, new_ema)

        inputs = dict(variables=variables, batch=batch_np, step=np.asarray(state.step),
                      loss_ema=np.asarray(state.loss_ema))
        with float64_beside(inputs) as x64:
            (total, (metrics, ema)), grads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))(params)
            counts = draw_counts(tiny_train_config(tget_config, PRESET),
                                 torch.from_numpy(np.array(batch_np["images"])))
            draws = jax_train_draws(cfg, key, *counts, batch_np["gt_boxes"].shape[1])
        return dict(
            inputs, draws=draw_arrays(draws), ema=np.asarray(ema),
            metrics={k: np.asarray(v) for k, v in dict(metrics, total_loss=total).items()},
            grads=_flat(grads), x64=x64)

    return run_shared(f"test_torch_car_train_step.jax_forward: {JAX_FORWARD}", compute)


@contextlib.contextmanager
def float64_beside(inputs):
    """JAX's float64 forward on ``inputs`` (the variables, the batch,
    ``step`` and ``loss_ema``), differentiated in ``SCOPE``'s parameters, in
    a process of its own while the block runs
    (``torch_float64_refs.train_x64``): a dict that holds its ``metrics``
    and ``grads`` once the block has ended."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        save_tree(src, inputs)
        path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
        child = subprocess.Popen(
            [sys.executable, torch_float64_refs.__file__, "--train-x64", PRESET, SCOPE, src,
             dst], env=dict(os.environ, PYTHONPATH=path))
        try:
            yield out
        except BaseException:
            child.kill()
            raise
        finally:
            child.wait()
        assert child.returncode == 0, f"the float64 forward exited with {child.returncode}"
        out.update(load_tree(dst))


def port_forward(tcfg, ref, batch):
    """The port's train forward on ``ref``'s weights and draws and on
    ``batch``, at one thread: (total, metrics, ``loss_ema``, gradients as
    JAX leaves, the first NOC conv's output at ``TIE`` before its ReLU)."""
    v = ref["variables"]
    sd, ema0, step0 = from_jax_train_state(SimpleNamespace(
        params=v["params"], batch_stats=v["batch_stats"], loss_ema=ref["loss_ema"],
        step=ref["step"]))
    assert step0 == 0
    model = MonoRUn(tcfg)
    model.load_state_dict(sd)
    tbatch = {k: torch.from_numpy(np.array(a)) for k, a in batch.items()}
    pre = []
    hook = model.roi_head.noc_head.convs[0].register_forward_hook(
        lambda m, i, out: pre.append(float(out[TIE].detach())))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        total, (metrics, ema) = model.train_forward(tbatch, torch.tensor(ema0),
                                                    train_draws_of(ref["draws"]))
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(total, [p for _, p in model.named_parameters()])
    finally:
        torch.set_num_threads(threads)
        hook.remove()
    assert len(pre) == 1
    return total.detach(), {k: m.detach() for k, m in metrics.items()}, ema.detach(), \
        to_jax_leaves(dict(zip(names, grads)), list(ref["grads"])), pre[0]


@pytest.fixture(scope="module")
def both():
    """JAX's forward and gradients in float32 and in float64, and the
    port's on the same weights, draws and (its own) synthetic batch."""
    ref = jax_forward()
    tcfg = tiny_train_config(tget_config, PRESET)
    batch = tsynthetic_train_batch(tcfg, B, (H, W), **BATCH)
    total, metrics, ema, grads, tie = port_forward(tcfg, ref, batch)
    metrics["total_loss"] = total
    return dict(ref=ref, batch=batch, tmetrics=metrics, jmetrics=ref["metrics"],
                tema=ema, jgrads=ref["grads"], tgrads=grads, tie=tie,
                jmetrics64=ref["x64"]["metrics"], jgrads64=ref["x64"]["grads"])


def test_train_forward_matches_jax(both):
    """The one-class batch of both packages; every loss of the step,
    ``mean_iou``, the total and ``loss_ema`` at ``check_loss``'s tolerance
    (``loss_noc`` from the LiDAR points on); the tied unit on JAX's side;
    each leaf's gradient to 1e-4 of its scale of JAX's or, for a leaf of
    the NOC head whose JAX gradient is further than that from JAX's float64
    one, to 1e-4 of the float64 one (the module docstring); the same leaves
    without gradient; and the
    NOC head class-agnostic (one class block a flip bank), every leaf of it
    reached."""
    ref = both["ref"]["batch"]
    assert set(both["batch"]) == set(ref)
    for k, a in ref.items():
        np.testing.assert_array_equal(both["batch"][k], a, err_msg=k)
    assert not np.asarray(ref["gt_labels"]).any()
    for name in LOSSES + ("mean_iou", "total_loss"):
        check_loss(both, name)
    assert float(both["jmetrics"]["loss_noc"]) > 0
    np.testing.assert_allclose(float(both["tema"]), float(both["ref"]["ema"]), rtol=1e-6)

    for name in NOT_RPN:
        check_loss(dict(tmetrics=both["jmetrics64"], jmetrics=both["jmetrics"]), name)
    assert both["tie"] < 0, (
        f"the NOC head's first conv at {TIE} (RoI, channel, row, column) reads "
        f"{both['tie']:.3g} before its ReLU, where JAX's jitted sum reads -2.7e-8: the "
        "port's summation order has moved the tied unit across zero (module docstring), "
        "and with it the NOC head's and the backbone's gradients")

    jg, tg, g64 = both["jgrads"], both["tgrads"], both["jgrads64"]
    assert set(jg) == set(tg) and set(g64) == {p for p in jg if p.startswith(SCOPE + "/")}
    worst = {p: _rel(tg[p], jg[p]) for p in jg}
    by_f64 = {p: (_rel(jg[p], g64[p]), _rel(tg[p], g64[p])) if p in g64 else (None, e)
              for p, e in worst.items() if not e <= 1e-4}
    bad = {p: e for p, e in by_f64.items() if e[0] is None or not e[1] <= 1e-4 < e[0]}
    assert not bad, bad
    assert len(by_f64) <= 2, by_f64
    zero_j = {p for p in jg if not np.abs(jg[p]).any()}
    zero_t = {p for p in tg if not np.abs(tg[p]).any()}
    assert zero_j == zero_t
    assert {p.split("/")[0] for p in zero_j} <= {"score_head", "cov_calib_logscale", "neck"}

    nh = tiny_train_config(tget_config, PRESET).noc_head
    assert nh.class_agnostic and nh.with_lidar_loss and nh.dropout2d_rate == 0.5
    final = jg["noc_head/conv_final/kernel"]
    assert final.shape[-1] == 2 * (nh.noc_channels + nh.uncert_channels)
    for p, g in tg.items():
        if p.startswith("noc_head/"):
            assert np.abs(g).any(), p
