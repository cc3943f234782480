"""``tests/test_torch_eval_path.py``'s forward against JAX's call, the
session's input and ``show_result``, in a file of at most 3 tests (xdist hands
it out late); that file states the configuration and the tolerances.
"""

import numpy as np
import torch

from monorun_tpu.utils.visualizer import show_result as jshow_result
from monorun_tpu_torch.apis import inference as tinf
from monorun_tpu_torch.apis.test import run_eval as trun_eval
from monorun_tpu_torch.utils.visualizer import show_result as tshow_result
from monorun_tpu_torch.utils.weights import from_jax_params

from test_torch_eval_path import (  # noqa: F401
    B, JaxDraws, TDataset, TOL, _batch, _close, configs, jax_draws, world,
)
from test_torch_serve import H, W
from torch_share import cpu_share  # noqa: F401


def test_forward_matches_jax_call(world):  # noqa: F811
    """``MonoRUn.forward`` against ``MonoRUn.__call__`` (the JAX session's
    program) on one normalised, padded batch, with the JAX draws."""
    batch = _batch(world["root"])
    assert batch["images"].shape == (B, H, W, 3)
    jdet = world["jsess"].run(batch["images"], batch["cam"], batch["img_shapes"], seed=3)
    sess = world["tsess"]
    with torch.no_grad():
        tdet = sess.model(torch.from_numpy(batch["images"]), torch.from_numpy(batch["cam"]),
                          torch.from_numpy(batch["img_shapes"]), jax_draws(sess.cfg, 3, B))
    np.testing.assert_array_equal(tdet.labels.numpy(), np.asarray(jdet.labels))
    np.testing.assert_array_equal(tdet.valid.numpy(), np.asarray(jdet.valid))
    assert tdet.valid.numpy().sum(1).min() >= 1
    for k in ("bboxes_2d", "scores_2d", "bboxes_3d", "pose_cov"):
        _close(getattr(tdet, k).numpy(), getattr(jdet, k), TOL[k], k)
    for k in ("oc_maps", "std_maps", "latent_vecs"):
        _close(tdet.extras[k].numpy(), jdet.extras[k], TOL[k], k)


def test_session_input_is_the_jax_sessions(world, tmp_path):  # noqa: F811
    """``init_inference(...).run`` takes what the JAX session's ``run``
    takes (normalised, padded images, their K and (h, w)); ``raw=True``
    switches to canvases. The JAX weights go in as a .pth file."""
    _, tcfg = configs()
    jsess = world["jsess"]
    ckpt = str(tmp_path / "jax_weights.pth")
    torch.save({"state_dict": from_jax_params(jsess.variables["params"],
                                               jsess.variables["batch_stats"])}, ckpt)
    sess = tinf.init_inference(tcfg, ckpt, batch_size=B, device="cpu", explicit_lazy=True)
    assert sess.raw is False and sess.cfg == tcfg
    assert tinf.init_inference(tcfg, batch_size=B, device="cpu", raw=True).raw
    batch = _batch(world["root"])
    args = (batch["images"], batch["cam"], batch["img_shapes"])
    jdet = jsess.run(*args, seed=6)
    tdet = JaxDraws(sess).run(*args, seed=6)
    np.testing.assert_array_equal(tdet.valid.numpy(), np.asarray(jdet.valid))
    _close(tdet.bboxes_3d.numpy(), jdet.bboxes_3d, TOL["bboxes_3d"])


def test_show_result_pixel_equal(world):  # noqa: F811
    """The port's visualizer draws the same pixels as the JAX package's,
    on a detection result with the debug maps."""
    ds = TDataset(world["root"], "train_list.txt")
    trun_eval(JaxDraws(world["tsess"]), ds, batch_size=B, print_summary=False,
              progress=False)
    import cv2

    shown = [i for i, r in enumerate(ds.results) if r["valid"].any()]
    assert len(shown) >= 2
    for i in shown[:2]:
        res = ds.results[i]
        assert "oc_maps" in res
        img = cv2.imread(ds.image_path(i))
        cam = ds.get_ann(i)["cam_intrinsic"]
        got = tshow_result(img, res, cam, score_thr=0.0)
        ref = jshow_result(img, res, cam, score_thr=0.0)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
