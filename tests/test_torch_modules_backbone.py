"""``tests/test_torch_modules.py``'s ResNet with frozen BatchNorm and the FPN,
in a file of at most 3 tests (xdist hands it out late); that file states the
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu.models import fpn as jfpn
from monorun_tpu.models import resnet as jresnet
from monorun_tpu_torch.models import fpn as tfpn
from monorun_tpu_torch.models import resnet as tresnet

from test_torch_modules import _close, _load, _nhwc_feats, _randomize, _t, jitted
from torch_share import cpu_share  # noqa: F401


def test_resnet_frozen_bn():
    img = _nhwc_feats(6, [(1, 64, 96, 3)])[0]
    jm = jresnet.ResNet(depth=26)
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(0), jnp.asarray(img)), seed=6)
    ref = jitted(jm.apply, v, jnp.asarray(img))
    tm = _load(tresnet.ResNet(depth=26), v, "backbone", "backbone.")
    with torch.no_grad():
        got = tm(_t(img))
    for a, b in zip(got, ref):
        _close(a, b, rtol=1e-4)


@pytest.mark.parametrize("lazy", [True, False])
def test_fpn_plus(lazy):
    """Dense build: F.interpolate(bilinear, align_corners=False) must equal
    jax.image.resize(bilinear) everywhere, the image border included."""
    ins = _nhwc_feats(7, [(1, 16, 24, 32), (1, 8, 12, 48), (1, 4, 6, 64), (1, 2, 3, 80)])
    jm = jfpn.FPNplus(out_channels=16, num_outs=5, num_lower_outs=1, lazy_lower=lazy)
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(1), [jnp.asarray(x) for x in ins]), 7)
    ref = jitted(jm.apply, v, [jnp.asarray(x) for x in ins])
    tm = _load(tfpn.FPNplus((32, 48, 64, 80), 16, 5, 1, lazy), v, "neck", "neck.")
    with torch.no_grad():
        got = tm([_t(x) for x in ins])
    assert len(got) == len(ref) == 6
    for a, b in zip(got, ref):
        _close(a, b, rtol=1e-4)
    if not lazy:   # the border rows/columns of the upsampled level
        lat = torch.nn.functional.interpolate(
            torch.arange(6.0).reshape(1, 1, 2, 3), scale_factor=2,
            mode="bilinear", align_corners=False)
        jlat = jax.image.resize(jnp.arange(6.0).reshape(1, 2, 3, 1),
                                (1, 4, 6, 1), "bilinear")
        _close(lat[0, 0], np.asarray(jlat)[0, ..., 0])
