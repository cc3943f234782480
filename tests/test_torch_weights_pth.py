"""``tests/test_torch_weights.py``'s ``.pth`` round trip through the JAX
converter, in a file of at most 3 tests (xdist hands it out late); that file
states the cases and the tolerances.
"""

import jax
import torch

from monorun_tpu.config import get_config
from monorun_tpu.models import init_detector
from monorun_tpu.utils.checkpoint import convert_torch_checkpoint
from monorun_tpu_torch.utils.weights import from_jax_params

from test_torch_serve import H, W, tiny_config
from test_torch_weights import _port_model
from torch_share import cpu_share  # noqa: F401


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
