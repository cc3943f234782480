"""``tests/test_torch_fast_presets.py``'s ResNet-50 weights both ways and the
fast2 NOC head, in a file of at most 3 tests (xdist hands it out late); that
file states the cases and the tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monorun_tpu.config import get_config
from monorun_tpu.models.noc_head import NOCHead as JNOCHead
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models.detector import MonoRUn
from monorun_tpu_torch.models.detector import init_random_weights
from monorun_tpu_torch.models.noc_head import NOCHead
from monorun_tpu_torch.utils.weights import from_jax_params, load_pth, to_jax_leaves

from test_torch_fast_presets import jax_variables, tiny_rung
from test_torch_modules import _randomize
from test_torch_serve import _close
from test_torch_train_step import _flat
from torch_share import cpu_share  # noqa: F401


def test_r50_weights_round_trip_both_ways(tmp_path):
    """A depth-50 state dict with the reference (mmdet) key names: the
    port's saved as ``.pth``, converted by the JAX package's converter and
    turned back by ``from_jax_params``; and JAX's variables carried into
    the port, loaded strictly, and read back as JAX leaves. Bit for bit
    both ways."""
    from monorun_tpu.utils.checkpoint import convert_torch_checkpoint

    variables = jax_variables("fast3_r50")
    cfg = tiny_rung(tget_config, "fast3_r50")
    assert cfg.backbone.depth == 50
    # JAX -> port -> JAX
    model = MonoRUn(cfg)
    model.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))
    assert len(model.backbone.layer3) == 6 and len(model.backbone.layer2) == 4
    ref = {**_flat(variables["params"]), **_flat(variables["batch_stats"])}
    back = to_jax_leaves(dict(model.state_dict()), list(ref))
    assert set(back) == set(ref)
    for p, v in ref.items():
        np.testing.assert_array_equal(back[p], v, err_msg=p)
    # port -> .pth -> JAX converter -> port
    port = init_random_weights(MonoRUn(cfg), torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for t in list(port.parameters()) + list(port.buffers()):
            t.add_(0.05 * torch.rand(t.shape, generator=gen))
    sd = port.state_dict()
    assert "backbone.layer3.5.conv3.weight" in sd and "backbone.layer4.2.bn3.running_var" in sd
    pth = tmp_path / "r50.pth"
    torch.save({"state_dict": sd}, pth)
    params, stats, _, report = convert_torch_checkpoint(
        str(pth), variables["params"], variables["batch_stats"])
    assert set(report.values()) == {"ok"}, report
    again = from_jax_params(params, stats)
    assert set(again) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0, msg=k)
    fresh = load_pth(MonoRUn(cfg), str(pth))
    for k, v in sd.items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_fast2_noc_head_without_carafe_matches_jax():
    """The fast2 NOC head (``test_fast_preset.py:127-144``): roi-grid-sized
    maps, no CARAFE or post-upsample conv parameters, and JAX's outputs on
    the same weights."""
    cfg = get_config("kitti_multiclass_fast2")
    x = np.random.default_rng(0).normal(size=(4, 14, 14, 256)).astype(np.float32)
    lat = np.random.default_rng(1).normal(
        size=(4, cfg.noc_head.latent_channels)).astype(np.float32)
    lbl = np.asarray([0, 1, 2, 0], np.int32)
    flp = np.asarray([False, True, False, True])
    nh = JNOCHead(cfg.noc_head, dtype=jnp.float32)
    v = nh.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lat), jnp.asarray(lbl),
                jnp.asarray(flp), False)
    v = _randomize(jax.tree.map(np.asarray, v))
    assert "upsample" not in v["params"]
    assert not any(k.startswith("conv_up") for k in v["params"])
    jout = nh.apply(v, jnp.asarray(x), jnp.asarray(lat), jnp.asarray(lbl),
                    jnp.asarray(flp), False)
    head = NOCHead(tget_config("kitti_multiclass_fast2").noc_head)
    assert head.upsample is None and len(head.convs_upsampled) == 0
    prefix = "roi_head.noc_head."
    sd = from_jax_params({"noc_head": v["params"]}, {})
    head.load_state_dict({k[len(prefix):]: t for k, t in sd.items()})
    with torch.no_grad():
        out = head(torch.from_numpy(x), torch.from_numpy(lat), torch.from_numpy(lbl).long(),
                   torch.from_numpy(flp))
    assert out.noc_pred.shape == (4, 14, 14, 3) and out.proj_logstd.shape == (4, 14, 14, 2)
    _close(out.noc_pred, jout.noc_pred, 1e-5)
    _close(out.proj_logstd, jout.proj_logstd, 1e-5)
