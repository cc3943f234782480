"""The traffic generators repeat for a seed and change with it."""

import numpy as np
import torch

from benchlib import scenes, spec, tiny


def _cell(name, **kw):
    return tiny.tiny(spec.load_cell(name), **kw)


def test_served_requests_repeat_for_a_seed():
    cell = _cell("serve_mc_b8")
    cfg, traffic = cell.config["config"], cell.traffic
    a = scenes.make_requests(cfg, traffic, 2 ** 31 + 17, "cpu")
    b = scenes.make_requests(cfg, traffic, 2 ** 31 + 17, "cpu")
    c = scenes.make_requests(cfg, traffic, 2 ** 31 + 18, "cpu")
    assert len(a.batches) == traffic["batches"]
    for (x, y) in zip(a.batches, b.batches):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)
    assert not np.array_equal(a[0][0], c[0][0])
    raw, cam, shapes = a[0]
    h, w = traffic["image_hw"]
    assert raw.dtype == np.uint8 and raw.shape == (traffic["batch"], tiny.H, tiny.W, 3)
    assert not raw[:, h:].any() and not raw[:, :, w:].any()      # pasted top-left
    assert np.array_equal(shapes, np.tile([[h, w]], (traffic["batch"], 1)))
    assert np.allclose(cam[0], traffic["K"])


def test_served_scenes_show_their_objects():
    K = spec.load_cell("serve_mc_b8").traffic["K"]          # KITTI's camera 2
    traffic = dict(objects=[3, 3], depth_m=[8.0, 9.0], K=K)
    params = scenes.scene_params(traffic, 5, 2)
    assert params["present"].sum() == 6
    K = torch.tensor(traffic["K"])
    img = scenes.render(params, K, (375, 1242), (0.0,) * 3, (1.0,) * 3, "cpu")
    empty = dict(params, present=torch.zeros_like(params["present"]))
    noise = scenes.render(empty, K, (375, 1242), (0.0,) * 3, (1.0,) * 3, "cpu")
    covered = (img != noise).any(-1).float().mean((1, 2))
    # three cars 8-9 m away cover a good share of each image
    assert img.shape == (2, 375, 1242, 3) and (covered > 0.05).all()


def test_head_draws_repeat_for_a_generator_seed():
    cfg = _cell("serve_mc_b8").config["config"]
    a = scenes.head_draws(cfg, 2, torch.float32, torch.Generator().manual_seed(9), "cpu")
    b = scenes.head_draws(cfg, 2, torch.float32, torch.Generator().manual_seed(9), "cpu")
    for x, y in zip(a[0] + (a[1],), b[0] + (b[1],)):
        assert torch.equal(x, y)
    n = 2 * scenes.head_slots(cfg)
    assert a[0][0].shape == (n, cfg["global_head"]["mc_samples"], cfg["neck"]["out_channels"])
    assert set(torch.unique(a[0][1]).tolist()) <= {0.0, 2.0}      # dropout 0.5, pre-scaled
