"""The port's KITTI evaluator against the JAX package's.

``kitti_eval`` of both packages on hand-made annotations with known
outcomes (a perfect detector, missed objects, false positives, DontCare
regions, a Van beside a Car, the difficulty filters, a 3D offset that
fails the strict overlap and passes the loose one, orientation for AOS,
and a random mix of all of them): the AP dicts are equal to 1e-9 and
hold the expected values. The port's native statistics path
(``eval/_native``, built with g++) equals its Python path, and the
rotated-IoU helpers equal the JAX package's copies.
"""

import contextlib
import importlib
import os
import subprocess

import numpy as np
import pytest

from monorun_tpu.eval import rotated_iou_np as jri
from monorun_tpu_torch.eval import _native
from monorun_tpu_torch.eval import rotated_iou_np as tri

from torch_share import cpu_share  # noqa: F401

# the modules (each package's eval/__init__.py binds the name to the function)
jke = importlib.import_module("monorun_tpu.eval.kitti_eval")
tke = importlib.import_module("monorun_tpu_torch.eval.kitti_eval")


def build_jax_native():
    """The JAX package's native evaluator (``monorun_tpu/eval/_native``),
    compiled, if it is missing or older than its source, to a name of this
    process's own and renamed into place. Its own ``get_lib`` has g++ write
    the library in place and tries once per process, so a worker that loads
    it while another writes it gets none, and
    ``tests/test_kitti_eval.py::test_native_matches_python`` skips there.
    Where g++ fails, ``get_lib`` is left to try, as before."""
    from monorun_tpu.eval import _native as jnative

    lib, src = jnative._LIB, jnative._SRC
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (subprocess.SubprocessError, FileNotFoundError):
        with contextlib.suppress(FileNotFoundError):
            os.remove(tmp)


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    """``build_jax_native`` before a module's first JAX evaluation: the port's
    files that evaluate with JAX early in a run import it."""
    build_jax_native()

BOX = [100, 100, 200, 200]          # height 100: counts for every difficulty
N_IMG = 50                          # enough score levels for 41 recall points


def _gt(names, bboxes, locs=None, dims=None, rys=None, trunc=None, occ=None,
        alpha=None):
    n = len(names)
    return dict(
        name=np.asarray(names),
        truncated=np.asarray(trunc if trunc is not None else [0.0] * n),
        occluded=np.asarray(occ if occ is not None else [0] * n),
        alpha=np.asarray(alpha if alpha is not None else [0.0] * n, np.float64),
        bbox=np.asarray(bboxes, np.float32).reshape(n, 4),
        dimensions=np.asarray(dims if dims is not None else [[4, 1.5, 1.7]] * n,
                              np.float32).reshape(n, 3),
        location=np.asarray(locs if locs is not None else [[0, 1.5, 20]] * n,
                            np.float32).reshape(n, 3),
        rotation_y=np.asarray(rys if rys is not None else [0.0] * n),
        score=np.zeros(n, np.float32),
    )


def _dt(bboxes, scores, name="Car", **kw):
    a = _gt([name] * len(scores), bboxes, **kw)
    a["score"] = np.asarray(scores, np.float32)
    return a


def _s(i, base=0.9):
    return base - 0.004 * i


def _random_scenes(seed=5, n=30):
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for _ in range(n):
        n_gt = int(rng.integers(1, 5))
        boxes = []
        for _ in range(n_gt):
            x, y = rng.uniform(0, 800), rng.uniform(0, 200)
            boxes.append([x, y, x + rng.uniform(40, 120), y + rng.uniform(20, 120)])
        names = rng.choice(["Car", "Van", "Pedestrian", "DontCare"], n_gt,
                           p=[0.6, 0.15, 0.1, 0.15])
        locs = np.stack([rng.uniform(-5, 5, n_gt), np.full(n_gt, 1.5),
                         rng.uniform(8, 40, n_gt)], 1)
        rys = rng.uniform(-np.pi, np.pi, n_gt)
        gts.append(_gt(list(names), boxes, locs=locs, rys=rys,
                       trunc=rng.uniform(0, 0.6, n_gt), occ=rng.integers(0, 3, n_gt),
                       alpha=rys))
        dboxes, scores, dlocs, drys = [], [], [], []
        for _ in range(int(rng.integers(0, 6))):
            if rng.uniform() < 0.6:
                k = int(rng.integers(0, n_gt))
                dboxes.append(list(np.asarray(boxes[k]) + rng.uniform(-8, 8, 4)))
                dlocs.append(locs[k] + rng.uniform(-0.5, 0.5, 3))
                drys.append(rys[k] + rng.uniform(-0.3, 0.3))
            else:
                x, y = rng.uniform(0, 800), rng.uniform(0, 200)
                dboxes.append([x, y, x + 80, y + 60])
                dlocs.append([rng.uniform(-5, 5), 1.5, rng.uniform(8, 40)])
                drys.append(rng.uniform(-np.pi, np.pi))
            scores.append(float(rng.uniform(0.1, 1.0)))
        n_dt = len(scores)
        dts.append(_dt(dboxes if n_dt else np.zeros((0, 4)), scores,
                       locs=np.asarray(dlocs).reshape(n_dt, 3), rys=drys, alpha=drys))
    return gts, dts


def _scenario(name):
    """(gts, dts, classes, eval_types, {key: (low, high)} expectations)."""
    other = [300, 100, 400, 200]
    if name == "perfect":
        gts = [_gt(["Car"], [BOX])] * N_IMG
        dts = [_dt([BOX], [_s(i)]) for i in range(N_IMG)]
        return gts, dts, ["Car"], ["bbox", "bev", "3d"], {
            "Car_bbox_0.70_easy": (97, 100), "Car_3d_0.70_hard": (97, 100),
            "Car_aos_0.70_easy": (97, 100)}
    if name == "missed":
        gts = [_gt(["Car", "Car"], [BOX, other])] * N_IMG
        dts = [_dt([BOX], [_s(i)]) for i in range(N_IMG)]
        return gts, dts, ["Car"], ["bbox"], {"Car_bbox_0.70_easy": (40, 52)}
    if name == "false_positive":
        gts = [_gt(["Car"], [BOX])] * N_IMG
        dts = [_dt([BOX, [500, 100, 600, 200]], [_s(i), _s(i, 0.89)])
               for i in range(N_IMG)]
        return gts, dts, ["Car"], ["bbox"], {"Car_bbox_0.70_easy": (1, 90)}
    if name == "dontcare":
        gts = [_gt(["Car", "DontCare"], [BOX, [500, 100, 600, 200]])] * N_IMG
        dts = [_dt([BOX, [500, 100, 600, 200]], [_s(i), _s(i, 0.89)])
               for i in range(N_IMG)]
        return gts, dts, ["Car"], ["bbox"], {"Car_bbox_0.70_easy": (97, 100)}
    if name == "van":
        gts = [_gt(["Car", "Van"], [BOX, [500, 100, 600, 200]])] * N_IMG
        dts = [_dt([BOX, [500, 100, 600, 200]], [_s(i), _s(i, 0.89)])
               for i in range(N_IMG)]
        return gts, dts, ["Car"], ["bbox"], {"Car_bbox_0.70_easy": (97, 100)}
    if name == "difficulty":
        small = [100, 100, 160, 130]         # height 30: not easy, moderate
        gts = [_gt(["Car", "Car", "Car"], [small, BOX, other], trunc=[0, 0.4, 0],
                   occ=[0, 0, 1])] * N_IMG
        dts = [_dt([small, BOX, other], [_s(i), _s(i, 0.89), _s(i, 0.88)])
               for i in range(N_IMG)]
        return gts, dts, ["Car"], ["bbox"], {
            "Car_bbox_0.70_easy": (0, 1), "Car_bbox_0.70_moderate": (97, 100)}
    if name == "offset_3d":
        # x offset 1 on an l=4 box: 3D IoU 0.6, fails 0.7 and passes 0.5
        gts = [_gt(["Car"], [BOX], locs=[[0.0, 1.5, 15.0]])] * N_IMG
        dts = [_dt([BOX], [_s(i)], locs=[[1.0, 1.5, 15.0]]) for i in range(N_IMG)]
        return gts, dts, ["Car"], ["3d"], {
            "Car_3d_0.70_easy": (0, 1), "Car_3d_0.50_easy": (97, 100)}
    if name == "aos":
        gts = [_gt(["Car"], [BOX], alpha=[0.0])] * N_IMG
        dts = [_dt([BOX], [_s(i)], alpha=[np.pi / 2 if i % 2 else 0.0])
               for i in range(N_IMG)]
        return gts, dts, ["Car"], ["bbox"], {
            "Car_bbox_0.70_easy": (97, 100), "Car_aos_0.70_easy": (60, 90)}
    if name == "random":
        gts, dts = _random_scenes()
        return gts, dts, ["Car", "Pedestrian", "Cyclist"], ["bbox", "bev", "3d"], {
            "Car_bev_0.50_moderate": (1, 100)}
    raise KeyError(name)


SCENARIOS = ("perfect", "missed", "false_positive", "dontcare", "van", "difficulty",
             "offset_3d", "aos", "random")


@pytest.mark.parametrize("name", SCENARIOS)
def test_kitti_eval_matches_jax(name):
    gts, dts, classes, types, expect = _scenario(name)
    summary_j, ap_j = jke.kitti_eval(gts, dts, classes, eval_types=types)
    summary_t, ap_t = tke.kitti_eval(gts, dts, classes, eval_types=types)
    assert list(ap_t) == list(ap_j) and summary_t == summary_j
    for k, v in ap_j.items():
        assert abs(ap_t[k] - v) <= 1e-9, (k, ap_t[k], v)
    for k, (lo, hi) in expect.items():
        assert lo <= ap_t[k] <= hi, (k, ap_t[k])


@pytest.mark.parametrize("criteria", ["R40", "R11"])
def test_kitti_eval_criteria_match_jax(criteria):
    gts, dts = _random_scenes(seed=8)
    _, ap_j = jke.kitti_eval(gts, dts, ["Car"], criteria=criteria)
    _, ap_t = tke.kitti_eval(gts, dts, ["Car"], criteria=criteria)
    assert ap_t.keys() == ap_j.keys()
    assert max(abs(ap_t[k] - ap_j[k]) for k in ap_j) <= 1e-9
    assert max(ap_t.values()) > 0


def test_native_matches_python(monkeypatch):
    """The C++ statistics reproduce the Python protocol: per eval_class
    curve, and through kitti_eval's whole AP dict."""
    assert _native.get_lib() is not None, "the native eval library did not build"
    assert _native.lib_path().parent.name == "native"
    gts, dts = _random_scenes(seed=11)
    for metric in (0, 1, 2):
        for diff in (0, 1, 2):
            r_py = tke.eval_class(gts, dts, "Car", diff, metric, 0.5,
                                  compute_aos=metric == 0, use_native=False)
            r_c = tke.eval_class(gts, dts, "Car", diff, metric, 0.5,
                                 compute_aos=metric == 0, use_native=True)
            for k in ("precision", "recall", "aos"):
                np.testing.assert_allclose(r_c[k], r_py[k], atol=1e-5)
    _, ap_native = tke.kitti_eval(gts, dts, ["Car", "Pedestrian"])
    monkeypatch.setattr(tke, "_native_lib", lambda: None)
    _, ap_python = tke.kitti_eval(gts, dts, ["Car", "Pedestrian"])
    assert ap_native.keys() == ap_python.keys()
    assert max(abs(ap_native[k] - ap_python[k]) for k in ap_python) <= 1e-3
    assert max(ap_python.values()) > 0


def test_rotated_iou_matches_jax():
    rng = np.random.default_rng(2)
    n, m = 12, 9
    bev_a = np.concatenate([rng.uniform(-5, 5, (n, 2)), rng.uniform(1, 4, (n, 2)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    bev_b = np.concatenate([bev_a[:m, :2] + rng.uniform(-1, 1, (m, 2)),
                            rng.uniform(1, 4, (m, 2)), rng.uniform(-np.pi, np.pi, (m, 1))], 1)
    for crit in (-1, 0, 1):
        got = tri.rotate_iou_matrix(bev_a, bev_b, criterion=crit)
        ref = jri.rotate_iou_matrix(bev_a, bev_b, criterion=crit)
        np.testing.assert_array_equal(got, ref)
    assert got.max() > 0

    def box3d(b):   # bev (x, z, l, w, ry) -> (x, y, z, l, h, w, ry)
        y, h = rng.uniform(1, 2, (2, len(b), 1))
        return np.concatenate([b[:, :1], y, b[:, 1:2], b[:, 2:3], h, b[:, 3:5]], 1)

    a3, b3 = box3d(bev_a), box3d(bev_b)
    for crit in (-1, 0):
        np.testing.assert_array_equal(tri.d3_box_overlap(a3, b3, criterion=crit),
                                      jri.d3_box_overlap(a3, b3, criterion=crit))
