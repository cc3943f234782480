"""The port's cold start: the builds' root (``utils/compile_cache.py``),
the per-library kernel build (``ops/roi_align_cuda.py:KernelBuild``), the
session warm-up (``utils/warm_start.py``) and ``tools.cold_profile``, on
the CPU at a tiny configuration.

The build is held with ``nvcc`` and ``ctypes.CDLL`` replaced by recorders
(the CPU tests run without ``nvcc``): which sources each caller compiles, in
which directory. The warm-up is held to change no result bit: a request
served after it equals the same request served without it. The tool's
marks are held to JAX's ``tools/cold_profile.py``, read from its source
(its ``mark`` calls, in order), with JAX's trace+lower and compile taken
by the port's one kernel build. No JAX is imported here; the card's side
is ``tests/test_torch_cuda.py``.
"""

import ast
import math
import os
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from monorun_tpu_torch.apis import inference
from monorun_tpu_torch.apis.inference import InferenceSession, init_inference
from monorun_tpu_torch.config import apply_overrides, get_config
from monorun_tpu_torch.eval import _native
from monorun_tpu_torch.models.detector import init_detector
from monorun_tpu_torch.ops import roi_align_cuda as rc
from monorun_tpu_torch.tools import cold_profile
from monorun_tpu_torch.utils import compile_cache as cc
from monorun_tpu_torch.utils import warm_start as ws

REPO = Path(__file__).resolve().parents[1]
B, H, W = 2, 64, 128
TINY_OPTIONS = [
    "compute_dtype='float32'", "backbone.depth=26", "neck.out_channels=64",
    "rpn.feat_channels=64", "bbox_head.fc_out_channels=128",
    "global_head.mc_samples=2", "global_head.fc_out_channels=128",
    "noc_head.conv_out_channels=64", "noc_head.carafe_compressed_channels=16",
    "noc_head.roi_size=8", "noc_head.dense_size=16",
    "score_head.reg_fc_out_channels=128", "score_head.pose_fc_out_channels=128",
    "score_head.fc_out_channels=64", "pose_head.ransac_hypotheses=4",
    "test.rpn_nms_pre=64", "test.rpn_nms_post=64", "test.max_per_img=12",
    "test.head_slots=6", f"data.pad_height={H}", f"data.pad_width={W}",
    f"data.raw_height={H}", f"data.raw_width={W}",
]
ALIGN_ENV = ("MONORUN_ALIGN_IMPL", "MONORUN_BAND_TIERED", "MONORUN_BAND_MATMUL")


def tiny_config():
    return apply_overrides(get_config("kitti_multiclass"), TINY_OPTIONS)


@pytest.fixture(scope="module", autouse=True)
def cpu_share():
    """Under pytest-xdist each worker takes its share of torch's threads, as
    ``test_torch_train_loop.py:cpu_share`` does (that file imports JAX, and
    this one must not: ``test_torch_cuda.py`` imports it on the card)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def root(monkeypatch, tmp_path):
    """The builds' root unset, and ``MONORUN_TORCH_CACHE_DIR`` too, for the
    test's span."""
    monkeypatch.setattr(cc, "_root", None)
    monkeypatch.delenv(cc.ENV, raising=False)
    return tmp_path


@pytest.fixture
def default_align(monkeypatch):
    for name in ALIGN_ENV:
        monkeypatch.delenv(name, raising=False)


# ---- compile_cache ----------------------------------------------------------


def test_default_root_is_the_repository_build(root):
    assert cc.DEFAULT_CACHE_DIR == REPO / "build"
    assert cc.cache_root() == REPO / "build"
    assert cc.kernels_dir() == REPO / "build" / "torch_kernels"
    assert _native.lib_path().parent == REPO / "build" / "native"


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_root_moves_both_build_sites(root, monkeypatch, how):
    want = root / how
    if how == "argument":
        monkeypatch.setenv(cc.ENV, str(root / "not_this"))
        got = cc.enable_compilation_cache(want)
    else:
        monkeypatch.setenv(cc.ENV, str(want))
        assert cc.cache_root() == want            # read before any call, too
        got = cc.enable_compilation_cache()
    assert got == want and want.is_dir()
    assert cc.kernels_dir() == want / "torch_kernels"
    assert _native.lib_path().parent == want / "native"
    assert _native.lib_path().name.startswith("libkitti_stats_")


# ---- KernelBuild(stems) -----------------------------------------------------


class FakeLib:
    """A loaded library: any symbol, any attribute set on it."""

    def __init__(self, path):
        self._name = str(path)

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


class Recorder:
    """``_start_nvcc``/``_finish_nvcc``/``ctypes.CDLL`` stand-ins: each
    ``nvcc`` job's source and library are kept, its library file made."""

    def __init__(self):
        self.started, self.libs, self.loaded = [], [], []

    def start(self, src, lib):
        self.started.append(Path(src).stem)
        self.libs.append(Path(lib))
        return lib, None, None

    def finish(self, jobs):
        for lib, _, _ in jobs:
            Path(lib).touch()
        return "", []

    def cdll(self, path):
        self.loaded.append(Path(path).name)
        return FakeLib(path)


@pytest.fixture
def recorder(monkeypatch, root):
    rec = Recorder()
    monkeypatch.setattr(rc, "_start_nvcc", rec.start)
    monkeypatch.setattr(rc, "_finish_nvcc", rec.finish)
    monkeypatch.setattr(rc.ctypes, "CDLL", rec.cdll)
    monkeypatch.setattr(rc, "build_all", rc.KernelBuild())
    cc.enable_compilation_cache(root / "cache")    # set after every import
    return rec


def test_serving_builds_the_direct_kernel_alone(recorder, default_align):
    stems = ws.serving_stems(get_config("kitti_multiclass"), 8)
    assert stems == ("roi_align",)
    assert ws.start_build(stems).result() >= 0.0
    assert recorder.started == ["roi_align"]
    assert all(p.parent.parent == cc.kernels_dir() for p in recorder.libs)
    rc.RoIAlignKernel().build()                    # loads, builds nothing more
    assert recorder.started == ["roi_align"]
    assert rc.build_all.built == ["roi_align"] and list(rc.build_all.libs) == ["roi_align"]


def test_training_builds_the_forward_and_its_backward(recorder):
    rc.RoIAlignKernel().build()
    rc.RoIAlignBackwardKernel().build()
    assert recorder.started == ["roi_align", "roi_align_bwd"]
    assert set(rc.build_all.libs) == {"roi_align", "roi_align_bwd"}


def test_each_staged_kernel_builds_its_own_library(recorder):
    for k in rc.STAGED_KERNELS:
        rc.StagedKernel(k.name, k.lib, k.symbol, k.argtypes).build()
    assert recorder.started == ["roi_align_tile", "roi_align_band", "roi_align_mma"]
    rc.build_all()                                 # every library, as chip_smoke.py asks
    assert sorted(recorder.started) == sorted(rc.KernelBuild.stems())
    assert len(rc.build_all.libs) == len(rc.KernelBuild.stems())


def test_a_library_in_the_build_directory_is_not_rebuilt(recorder):
    rc.build_all(["roi_align"])
    other = rc.KernelBuild()                       # another process, the same root
    other(["roi_align", "roi_align_bwd"])
    assert recorder.started == ["roi_align", "roi_align_bwd"]
    assert other.built == ["roi_align_bwd"]
    assert recorder.loaded == ["libroi_align.so", "libroi_align.so", "libroi_align_bwd.so"]


def test_an_unknown_stem_raises_before_any_nvcc(recorder):
    with pytest.raises(ValueError, match="no_such_kernel"):
        rc.build_all(["roi_align", "no_such_kernel"])
    assert recorder.started == [] and rc.build_all.libs == {}


@pytest.mark.parametrize("env, stems", [
    ({}, ("roi_align",)),
    ({"MONORUN_ALIGN_IMPL": "gather"}, ()),
    ({"MONORUN_ALIGN_IMPL": "bandmm"}, ("roi_align_mma",)),
    ({"MONORUN_ALIGN_IMPL": "band", "MONORUN_BAND_TIERED": "1"}, ("roi_align_band",)),
    ({"MONORUN_BAND_TIERED": "1"}, ("roi_align_band", "roi_align")),
])
def test_serving_stems_follow_the_align_settings(monkeypatch, default_align, env, stems):
    """At batch 8 the proposals' align (8000 RoIs, bfloat16) takes the band
    route under ``auto``, the detections' the direct kernel."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert ws.serving_stems(get_config("kitti_multiclass"), 8) == stems


# ---- warm_start -------------------------------------------------------------


def _session(cfg, raw=False):
    model = init_detector(cfg, torch.Generator().manual_seed(0))
    return InferenceSession(cfg, model, B, torch.device("cpu"), raw=raw, warm=False)


def _request(cfg, raw, seed=3):
    rng = np.random.default_rng(seed)
    if raw:
        images = rng.integers(0, 256, (B, H, W, 3), np.uint8)
    else:
        images = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    cam = np.tile(np.array([[70.0, 0, 64], [0, 70.0, 32], [0, 0, 1]], np.float32), (B, 1, 1))
    return images, cam, np.array([[60.0, 120.0], [64.0, 128.0]], np.float32)


def test_warm_start_on_the_cpu_returns_its_pieces():
    cfg = tiny_config()
    sess = _session(cfg)
    outs = []
    sess.model.register_forward_hook(lambda m, args, out: outs.append(out))
    times = ws.warm_start(cfg, sess.model, B, "cpu")
    assert set(times) == {"build", "build_wait", "load", "forward"}
    assert all(math.isfinite(t) and t >= 0 for t in times.values())
    (det,) = outs
    assert det.bboxes_3d.shape == (B, cfg.test.max_per_img, 8)
    for name in ("bboxes_2d", "scores_2d", "bboxes_3d", "pose_cov"):
        assert torch.isfinite(getattr(det, name)).all(), name


@pytest.mark.parametrize("raw", [False, True])
def test_a_request_after_warm_start_is_bit_equal(raw):
    cfg = tiny_config()
    req = _request(cfg, raw)
    cold = _session(cfg, raw).run(*req, seed=4)
    sess = _session(cfg, raw)
    ws.warm_start(cfg, sess.model, B, "cpu", raw=raw)
    warm = sess.run(*req, seed=4)
    for name, a in cold._asdict().items():
        if name != "extras":
            assert torch.equal(a, getattr(warm, name)), name


def test_warm_default_does_nothing_on_the_cpu(monkeypatch):
    cfg = tiny_config()
    monkeypatch.setattr(inference, "warm_start", lambda *a, **k: pytest.fail("warmed"))
    monkeypatch.setattr(inference, "start_build", lambda *a, **k: pytest.fail("built"))
    sess = init_inference(cfg, batch_size=B, device="cpu")
    assert sess.warm_seconds is None
    assert _session(cfg).warm_seconds is None


def test_a_failed_build_raises_from_the_warm_up(monkeypatch):
    cfg = tiny_config()

    def fail(stems):
        raise RuntimeError("nvcc failed on libroi_align.so")

    monkeypatch.setattr(rc, "build_all", fail)
    build = ws.start_build(("roi_align",))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ws.warm_start(cfg, _session(cfg).model, B, "cpu", build=build)


# ---- tools.cold_profile -----------------------------------------------------


def jax_marks(warm: bool):
    """The labels JAX's ``tools/cold_profile.py`` marks, in order, as the
    port's tool prints them: its trace+lower and compile as one kernel
    build, its f-string fields filled."""
    tree = ast.parse((REPO / "tools" / "cold_profile.py").read_text())
    labels = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "mark":
            labels.append((node.lineno, ast.unparse(node.args[0])))
    labels = [re.sub(r"^f?['\"]|['\"]$", "", s) for _, s in sorted(labels)]
    labels = ["kernel build" if s == "trace+lower" else s for s in labels if s != "compile"]
    labels = [re.sub(r"\{host\.nbytes[^}]*\}", "0", s.replace("{fast}", "True"))
              for s in labels]
    if warm:
        labels = [s for s in labels if s not in ("precast", "kernel build")]
        labels[labels.index("init_detector (fast=True)")] = "init_inference (warm)"
        labels = [s.replace("exec+fetch", "request") for s in labels]
    return labels


@pytest.mark.parametrize("warm", [False, True])
def test_cold_profile_prints_jax_marks_in_order(capsys, root, default_align, warm):
    argv = ["2", "--device", "cpu", "--cache-dir", str(root / "cc"),
            "--cfg-options", *TINY_OPTIONS] + (["--warm"] if warm else [])
    out = cold_profile.main(argv)
    labels = [m["mark"] for m in out["marks"]]
    assert labels == jax_marks(warm)
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[cold ")]
    assert [ln.split(":")[0].split("]")[1].strip() for ln in printed] == labels
    totals = np.cumsum([m["s"] for m in out["marks"]])
    np.testing.assert_allclose([m["total_s"] for m in out["marks"]], totals, rtol=1e-9)
    assert out["checksum"][0] == out["checksum"][1] and math.isfinite(out["checksum"][0])
    assert out["nvcc_jobs"] == [] and out["first_request_nvcc_jobs"] == 0
    assert out["cache_dir"] == str(root / "cc") and (root / "cc").is_dir()
    assert cc._root is None                        # the process's root given back
    assert out["warm"] is warm and out.get("warm_seconds") is None


def test_cold_profile_removes_its_fresh_cache(root, monkeypatch, tmp_path):
    monkeypatch.setattr(cold_profile.tempfile, "tempdir", str(tmp_path))
    out = cold_profile.main(["1", "gather", "backbone", "--device", "cpu",
                             "--cfg-options", *TINY_OPTIONS])
    assert Path(out["cache_dir"]).parent == tmp_path and not Path(out["cache_dir"]).exists()
    assert cc._root is None
    assert [m["mark"] for m in out["marks"]][-3:-1] == ["first exec+fetch",
                                                        "second exec+fetch"]
    assert out["stage"] == "backbone" and out["align_impl"] == "gather"
