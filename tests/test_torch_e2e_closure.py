"""Train -> serve -> KITTI AP through the port, on the card.

The closure itself (``tests/torch_e2e_closure.py``, JAX's
``tests/test_e2e_synthetic.py`` in the port) trains for hundreds of steps,
so it runs on a GPU only: the tests marked ``cuda`` skip without one. On a
machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_e2e_closure.py

The CPU tests hold what the closure is built from to the JAX file, without
training: the nano configuration field by field, and every synthetic scene
batch and the 0.75x downscale array by array. They import JAX inside the
test, so the file imports without it.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import torch_e2e_closure as closure
from torch_share import cpu_share  # noqa: F401

# cuBLAS's deterministic kernels need this before CUDA starts
os.environ.setdefault(*closure.CUBLAS_CONFIG)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _report(out):
    print(json.dumps({k: v for k, v in out.items() if k != "summary"}, default=str))
    print(out["summary"])


@pytest.mark.cuda
def test_closure_meets_jax_bars_in_float32(cuda_device):
    """Every bar of ``tests/test_e2e_synthetic.py``, unchanged, with the
    fast2 guard's second training."""
    out = closure.run_closure(cuda_device, "float32")
    _report(out)
    missed = [k for k, ok in closure.bars(out).items() if not ok]
    assert not missed, missed


@pytest.mark.cuda
def test_closure_trains_in_bfloat16(cuda_device):
    """The base closure in bfloat16, where JAX set no bar: finite, and
    ``mean_iou`` above 0.3; its APs are a reading."""
    out = closure.run_closure(cuda_device, "bfloat16", guards=False)
    _report(out)
    missed = [k for k, ok in closure.bars(out).items() if not ok]
    assert not missed, missed


def test_nano_config_equals_jax():
    from test_e2e_synthetic import nano_config

    jcfg = nano_config()
    assert dataclasses.asdict(closure.nano_config()) == dataclasses.asdict(jcfg)
    # the fast2 guard's cut (test_fast2_architecture_trains_and_scores)
    r = dataclasses.replace
    jf2 = r(jcfg, noc_head=r(jcfg.noc_head, dense_size=14),
            train=r(jcfg.train, dense_size=14), test=r(jcfg.test, head_slots=4))
    assert dataclasses.asdict(closure.fast2_config(closure.nano_config())) == \
        dataclasses.asdict(jf2)
    assert closure.nano_config("bfloat16").compute_dtype == "bfloat16"


def _same_batches(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("hw", [closure.HW, (closure.HW[0] * 4 // 3, closure.HW[1] * 4 // 3)])
def test_scene_batches_equal_jax(hw):
    """Seeds 40-45 at the training canvas and at 4/3 of it (the resolution
    guard's scenes)."""
    from monorun_tpu.utils.synthetic import synthetic_scene_batch
    from test_e2e_synthetic import N_SCENES, nano_config

    jcfg = nano_config()
    got = closure.scene_batches(closure.nano_config(), hw)
    assert len(got) == N_SCENES
    for i, g in enumerate(got):
        _same_batches(g, synthetic_scene_batch(jcfg, closure.B, hw, num_gt=4, num_pts=256,
                                               seed=40 + i, n_objects=2))


def test_crowd_scene_equals_jax():
    from monorun_tpu.utils.synthetic import synthetic_scene_batch
    from test_e2e_synthetic import CROWD_HW, nano_config

    assert closure.CROWD_HW == CROWD_HW
    got = closure.crowd_batch(closure.nano_config())
    _same_batches(got, synthetic_scene_batch(nano_config(), closure.B, CROWD_HW, num_gt=8,
                                             num_pts=64, seed=77, n_objects=6,
                                             z_range=(4.5, 7.0), u_span=(0.08, 0.92)))
    assert got["gt_valid"].sum(1).max() >= 5


def test_downscale_equals_jax():
    from test_e2e_synthetic import _scale_batch

    b = closure.scene_batches(closure.nano_config(),
                              (closure.HW[0] * 4 // 3, closure.HW[1] * 4 // 3))[0]
    _same_batches(closure.scale_batch(b, 0.75), _scale_batch(b, 0.75))
