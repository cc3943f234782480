"""Float64 figures for three comparisons that hold at one reference only
(ROADMAP Queue 3 item 11), on the CPU:

- ``loss_ema`` of ``tests/test_torch_train_step.py`` and ``loss_proj`` of
  the no-CARAFE step (``tests/test_torch_fast_presets.py``), each on the
  structural init's weights (``init_detector(fast=True)``, ``_randomize``d)
  in place of the traced init's that the tests use: JAX's step under
  ``jax.jit`` (``value_and_grad``, as the tests run it), the port's at 1, 2
  and 4 threads, and the port's with every float32 of the package promoted
  to float64. Both take ``loss_ema`` from the mean of ``exp(-logstd)``
  over the projection head's whole log-std output (``robust_kl_loss``), and
  ``loss_proj`` is divided by it; each side's log-std is captured and that
  mean taken again in float64, so the reduction's own rounding is told
  apart from the forward's;
- the coplanar problem of ``tests/test_torch_pnp_degenerate.py``: the
  port's ``pnp_uncert`` in float32 and float64, JAX's in float32 eagerly
  and under ``jax.jit``, and JAX's in float64 (``--x64``, a process of its
  own, since ``jax_enable_x64`` is read at start).

Run from the repository root (a few minutes; it starts the ``--x64``
process itself and prints one JSON object)::

    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/torch_float64_refs.py
"""

import contextlib
import json
import subprocess
import sys

import numpy as np

H, W, B = 64, 128, 2


def coplanar_args():
    from test_pnp import K, _make_problem

    p = _make_problem(b=2, n=48, seed=12, noise=0.3)
    p["pts"][..., 0] = 0.9                          # coplanar object points
    return [p[k] for k in ("uv", "istd", "pts", "cams", "ur", "vr")], K


def jax_x64():
    """JAX's ``pnp_uncert`` on the coplanar problem in float64."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from monorun_tpu.ops import pnp as jpnp

    args, _ = coplanar_args()
    res = jpnp.pnp_uncert(*[jnp.asarray(np.asarray(a, np.float64)) for a in args])
    assert res.t_vec.dtype == jnp.float64
    return dict(t_vec=np.asarray(res.t_vec).tolist(), yaw=np.asarray(res.yaw).tolist())


@contextlib.contextmanager
def float64_everywhere():
    """Every float32 of the port promoted to float64: ``torch.float32``,
    ``Tensor.float`` and the default dtype."""
    import torch

    saved = torch.float32, torch.float, torch.Tensor.float, torch.get_default_dtype()
    torch.float32 = torch.float = torch.float64
    torch.Tensor.float = torch.Tensor.double
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.float32, torch.float, torch.Tensor.float = saved[:3]
        torch.set_default_dtype(saved[3])


def pnp_figures():
    import jax
    import jax.numpy as jnp
    import torch

    from monorun_tpu.ops import pnp as jpnp
    from monorun_tpu_torch.ops import pnp as tpnp

    args, _ = coplanar_args()
    out = {}
    out["port32"] = tpnp.pnp_uncert(*map(torch.from_numpy, args)).t_vec.numpy()
    with float64_everywhere():
        res = tpnp.pnp_uncert(*[torch.from_numpy(np.asarray(a, np.float64)) for a in args])
        assert res.t_vec.dtype == torch.float64
        out["port64"] = res.t_vec.numpy()
    ja = [jnp.asarray(a) for a in args]
    out["jax32_eager"] = np.asarray(jpnp.pnp_uncert(*ja).t_vec)
    out["jax32_jit"] = np.asarray(jax.jit(jpnp.pnp_uncert)(*ja).t_vec)
    child = subprocess.run([sys.executable, __file__, "--x64"], capture_output=True,
                           text=True, check=True)
    out["jax64"] = np.asarray(json.loads(child.stdout.splitlines()[-1])["t_vec"])
    ref = out["port64"]
    rel = {k: float(np.abs(v - ref).max() / np.abs(ref).max()) for k, v in out.items()}
    return dict(t_vec={k: v.tolist() for k, v in out.items()}, rel_to_port64=rel,
                rel_jax64_port64=rel["jax64"])


def step_figures(which):
    """``which``: "train_step" or "no_carafe"."""
    import jax
    import jax.numpy as jnp
    import torch

    import monorun_tpu.losses as jlosses
    from monorun_tpu.config import get_config
    from monorun_tpu.models import init_detector
    from monorun_tpu.models.detector import MonoRUn as JMonoRUn
    from monorun_tpu.models.detector import _train_forward
    from monorun_tpu.utils.synthetic import synthetic_train_batch
    from monorun_tpu_torch.config import get_config as tget_config
    from monorun_tpu_torch.models import detector as tdet
    from monorun_tpu_torch.utils.weights import from_jax_params

    from test_torch_fast_presets import no_carafe_train_config
    from test_torch_modules import _randomize
    from test_torch_train_step import draw_counts, jax_train_draws, tiny_train_config

    config = tiny_train_config if which == "train_step" else no_carafe_train_config
    cfg, tcfg = config(get_config), config(tget_config)
    _, variables = init_detector(cfg, jax.random.PRNGKey(0), (H, W), fast=True)
    variables = jax.tree.map(np.asarray, _randomize(variables))
    batch_np = synthetic_train_batch(cfg, B, (H, W), num_gt=6, num_pts=32)
    key = jax.random.PRNGKey(1)
    model = JMonoRUn(cfg)
    seen = {}

    def capture(name, kl):
        def wrapped(pred, target, logstd, *a, **k):
            if name == "jax":
                jax.debug.callback(lambda x: seen.__setitem__(name, np.asarray(x)), logstd)
            else:
                seen[name] = logstd.detach().numpy().copy()
            return kl(pred, target, logstd, *a, **k)
        return wrapped

    def loss_fn(params):
        (total, (metrics, new_ema)), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jax.tree.map(jnp.asarray, batch_np), key, 0, jnp.float32(1.0),
            method=_train_forward, mutable=["batch_stats"])
        return total, (metrics, new_ema)

    kl = jlosses.robust_kl_loss
    jlosses.robust_kl_loss = capture("jax", kl)
    try:
        (_, (jm, jema)), _ = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree.map(jnp.asarray, variables["params"]))
        jax.effects_barrier()
    finally:
        jlosses.robust_kl_loss = kl
    out = {"jax32": dict(loss_ema=float(jema), loss_proj=float(jm["loss_proj"]))}

    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch_np.items()}
    counts = draw_counts(tcfg, tbatch["images"])
    draws = jax_train_draws(cfg, key, *counts, batch_np["gt_boxes"].shape[1])
    sd = from_jax_params(variables["params"], variables["batch_stats"])
    tkl = tdet.robust_kl_loss

    def port(name, threads=None, wide=False):
        model_t = tdet.MonoRUn(tcfg)
        model_t.load_state_dict(sd)
        b, d, ema = tbatch, draws, torch.tensor(1.0)
        if wide:
            model_t.double()
            b = {k: v.double() if v.is_floating_point() else v for k, v in tbatch.items()}
            wide_t = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
            d = type(draws)(*[None if f is None else tuple(map(wide_t, f))
                              if isinstance(f, tuple) else wide_t(f) for f in draws])
            ema = ema.double()
        tdet.robust_kl_loss = capture(name, tkl)
        saved = torch.get_num_threads()
        try:
            if threads:
                torch.set_num_threads(threads)
            with float64_everywhere() if wide else contextlib.nullcontext():
                total, (m, new_ema) = model_t.train_forward(b, ema, d)
        finally:
            tdet.robust_kl_loss = tkl
            torch.set_num_threads(saved)
        assert not wide or new_ema.dtype == torch.float64
        out[name] = dict(loss_ema=float(new_ema), loss_proj=float(m["loss_proj"]))

    for threads in (1, 2, 4):
        port(f"port32_t{threads}", threads)
    port("port64", wide=True)
    ref = out["port64"]
    for name, v in out.items():
        v["rel_to_port64"] = {k: abs(v[k] - ref[k]) / abs(ref[k]) for k in ("loss_ema",
                                                                              "loss_proj")}
    ls64 = seen["port64"]
    stats = {}
    for name in ("jax", "port32_t1", "port32_t2", "port32_t4", "port64"):
        ls = seen[name].astype(np.float64)
        stats[name] = dict(
            mean_inv_std_f64=float(np.mean(np.minimum(np.exp(-ls), 1e4))),
            logstd_max_abs_diff_to_port64=float(np.abs(ls - ls64).max()),
            logstd_mean_diff_to_port64=float(np.mean(ls - ls64)), elements=int(ls.size))
    return dict(losses=out, logstd=stats)


def main():
    if "--x64" in sys.argv:
        print(json.dumps(jax_x64()))
        return
    import jax

    jax.config.update("jax_platforms", "cpu")
    result = dict(pnp_coplanar=pnp_figures(), train_step=step_figures("train_step"),
                  no_carafe=step_figures("no_carafe"))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
