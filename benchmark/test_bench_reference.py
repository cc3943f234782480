"""The plain reference against the program at a tiny float32
configuration on the CPU, where the two must agree to round-off; and the
FLOP count."""

import pytest
import torch

from benchlib import flops, scenes, serve_check, spec, tiny, weights


def _cfg(name, batch=2):
    return tiny.tiny(spec.load_cell(name), batch=batch, config=tiny.NARROW)


def test_reference_serves_what_the_program_serves():
    from monorun_ref.config import MonoRUnConfig as RefConfig
    from monorun_ref.models.detector import MonoRUn as RefModel
    from monorun_tpu_torch.apis.inference import InferenceSession, detections_to_host
    from monorun_tpu_torch.config import MonoRUnConfig
    from monorun_tpu_torch.models.detector import HeadDraws, MonoRUn

    cell = _cfg("serve_mc_b8")
    cfg_d, seed = cell.config["config"], 2 ** 31 + 77
    req = scenes.make_requests(cfg_d, cell.traffic, seed, "cpu")[0]
    masks, keys = scenes.head_draws(cfg_d, 2, torch.float32, torch.Generator().manual_seed(1),
                                    "cpu")
    model = weights.build(MonoRUn, spec.build_config(MonoRUnConfig, cfg_d), seed, "cpu")
    session = InferenceSession(spec.build_config(MonoRUnConfig, cfg_d), model, 2,
                               torch.device("cpu"),
                               raw=True)
    served = detections_to_host(session.run(*req, draws=HeadDraws(masks, keys)))[0]
    ref_model = serve_check.reference_model(RefConfig, RefModel, cfg_d, seed, "cpu")
    ref = serve_check.reference_answers(ref_model, req, masks, keys, served)
    for k, v in served.items():
        torch.testing.assert_close(torch.as_tensor(ref["own"][k]), torch.as_tensor(v),
                                   rtol=1e-5, atol=1e-5, msg=k)
    # the reference's heads on the program's own 2D detections give its answers
    for k in ("bboxes_3d", "valid", "pose_cov"):
        torch.testing.assert_close(torch.as_tensor(ref[f"forced_{k}"]), torch.as_tensor(served[k]),
                                   rtol=1e-5, atol=1e-5, msg=k)


def test_flop_count_of_a_convolution_and_a_product():
    x = torch.randn(2, 8, 10, 12)
    w = torch.randn(16, 8, 3, 3)
    n = flops.counted(lambda: torch.nn.functional.conv2d(x, w, padding=1))
    assert n == 2 * 2 * 16 * 8 * 9 * 10 * 12
    a, b = torch.randn(5, 7), torch.randn(7, 3)
    assert flops.counted(lambda: a @ b) == 2 * 5 * 7 * 3


def test_flop_count_is_the_references_and_is_kept(tmp_path, monkeypatch):
    """The cached count of a configuration is FlopCounterMode's over the
    reference's forward, and a second call reads it back."""
    from monorun_ref.config import MonoRUnConfig as RefConfig
    from monorun_ref.models.detector import MonoRUn as RefModel

    monkeypatch.setattr(flops, "BUILD", tmp_path)
    cell = _cfg("serve_mc_b8")
    cfg_d = cell.config["config"]
    req = scenes.make_requests(cfg_d, cell.traffic, 3, "cpu")[0]
    masks, keys = scenes.head_draws(cfg_d, 2, torch.float32, torch.Generator().manual_seed(1),
                                    "cpu")
    model = serve_check.reference_model(RefConfig, RefModel, cfg_d, 3, "cpu")

    def count():
        with torch.no_grad():
            return flops.counted(lambda: serve_check.reference_answers(model, req, masks, keys))

    first = flops.cached(["t", cfg_d], count)
    assert first > 0 and first == count()
    assert flops.cached(["t", cfg_d], lambda: pytest.fail("counted twice")) == first
