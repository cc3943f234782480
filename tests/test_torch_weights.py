"""Weights between the port and the JAX package.

The port's state dict (reference mmdet key names) is saved with
``torch.save``, converted by the JAX package's own ``.pth`` converter,
and turned back by the port's ``from_jax_params``: every tensor must come
back bit for bit. ``load_pth`` loads a reference-style checkpoint (with
its ``num_batches_tracked`` and loss buffers) strictly.
"""

import jax
import numpy as np
import pytest
import torch

from monorun_tpu.config import get_config
from monorun_tpu.models import init_detector
from monorun_tpu.utils.checkpoint import convert_torch_checkpoint
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models.detector import MonoRUn, init_random_weights
from monorun_tpu_torch.utils.weights import from_jax_params, load_pth

from test_torch_serve import H, W, tiny_config


def _port_model(seed=0):
    model = init_random_weights(MonoRUn(tiny_config(tget_config)),
                                torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():   # non-trivial values in every tensor
        for t in list(model.parameters()) + list(model.buffers()):
            t.add_(0.05 * torch.rand(t.shape, generator=gen))
    return model


def test_pth_round_trip_through_the_jax_converter(tmp_path):
    model = _port_model()
    sd = model.state_dict()
    pth = tmp_path / "port.pth"
    torch.save({"state_dict": sd}, pth)
    _, variables = init_detector(tiny_config(get_config), jax.random.PRNGKey(0),
                                 (H, W), fast=True)
    params, stats, _, report = convert_torch_checkpoint(
        str(pth), variables["params"], variables["batch_stats"]
    )
    assert set(report.values()) == {"ok"}, report
    back = from_jax_params(params, stats)
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)


def test_load_pth_reference_layout(tmp_path):
    model = _port_model(seed=3)
    sd = dict(model.state_dict())
    # what a reference checkpoint carries beyond the serving weights
    sd["backbone.bn1.num_batches_tracked"] = torch.tensor(0)
    sd["roi_head.projection_head.loss_proj.mean_inv_std"] = torch.tensor(1.0)
    pth = tmp_path / "ref.pth"
    torch.save({"state_dict": sd, "meta": {"epoch": 1}}, pth)
    fresh = load_pth(MonoRUn(tiny_config(tget_config)), str(pth))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def _check_init_rules(model):
    w = model.backbone.layer1[0].conv2.weight
    fan_in = w[0].numel()
    assert abs(float(w.detach().std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert not model.roi_head.noc_head.latent_decoder.weight.any()
    bn = model.backbone.bn1
    assert (bn.weight == 1).all() and (bn.running_var == 1).all()
    assert not bn.bias.any() and not bn.running_mean.any()


def _check_lecun_bounds(model, inside: bool):
    """Every >= 2-D weight but the latent decoder within flax's
    ``lecun_normal`` truncation (two standard deviations of its normal),
    or, when not ``inside``, some beyond it (a plain normal)."""
    from monorun_tpu_torch.models.detector import TRUNCATED_STD

    edge = 2.0 / TRUNCATED_STD
    latent = model.roi_head.noc_head.latent_decoder.weight
    beyond = False
    for name, p in model.named_parameters():
        if p.dim() >= 2 and p is not latent:
            over = float(p.detach().abs().max()) > edge / p[0].numel() ** 0.5 * (1 + 1e-6)
            assert not (inside and over), name
            beyond |= over
    assert inside or beyond


def test_random_init_rules():
    model = init_random_weights(MonoRUn(tiny_config(tget_config)),
                                torch.Generator().manual_seed(0))
    _check_init_rules(model)


@pytest.mark.parametrize("fast", [True, False])
def test_init_detector_draws_as_jax_init_detector(fast):
    """``init_detector(cfg, generator, fast)``: JAX's ``fast=True`` serving
    draw (a plain normal, ``init_random_weights``' default, bit for bit on
    the same seed) or its traced training init (``lecun_normal``,
    ``truncated``), each with the init rules above."""
    from monorun_tpu_torch.models.detector import init_detector as tinit_detector

    cfg = tiny_config(tget_config)
    model = tinit_detector(cfg, torch.Generator().manual_seed(0), fast=fast)
    _check_init_rules(model)
    _check_lecun_bounds(model, inside=not fast)
    same = init_random_weights(MonoRUn(cfg), torch.Generator().manual_seed(0),
                               truncated=not fast)
    for (k, a), b in zip(model.state_dict().items(), same.state_dict().values()):
        assert torch.equal(a, b), k


def test_training_init_is_flax_lecun_normal():
    """``create_train_state`` draws as the JAX package's training init does
    (flax's traced init, ``lecun_normal``: a normal truncated at two
    standard deviations, rescaled to variance 1/fan_in); the serving init
    stays a plain normal (``_fast_init_variables``)."""
    import flax.linen as nn

    from monorun_tpu_torch.models.detector import TRUNCATED_STD, truncated_normal
    from monorun_tpu_torch.train import create_train_state

    n = 200_000
    got = truncated_normal((n,), torch.Generator().manual_seed(0)).double().numpy()
    ref = np.asarray(nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (1, n)),
                     np.float64)[0]
    edge = 2.0 / TRUNCATED_STD
    for x in (got, ref):
        assert np.abs(x).max() <= edge * (1 + 1e-6)
        assert abs(x.std() - 1.0) < 0.01 and abs(x.mean()) < 0.01
    q = (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99)
    np.testing.assert_allclose(np.quantile(got, q), np.quantile(ref, q), atol=0.02)

    model, _, _ = create_train_state(tiny_config(tget_config), 10, device="cpu", seed=0)
    latent = model.roi_head.noc_head.latent_decoder.weight
    for name, p in model.named_parameters():
        if p.dim() >= 2 and p is not latent:
            bound = edge / p[0].numel() ** 0.5
            assert float(p.detach().abs().max()) <= bound * (1 + 1e-6), name
    serve = init_random_weights(MonoRUn(tiny_config(tget_config)),
                                torch.Generator().manual_seed(0))
    w = serve.backbone.layer3[0].conv2.weight.detach()
    assert float(w.abs().max()) > edge / w[0].numel() ** 0.5
