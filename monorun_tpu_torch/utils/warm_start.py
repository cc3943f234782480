"""Cold-start warm-up of a serving session; the counterpart of
``monorun_tpu/utils/warm_start.py``.

On a fresh machine the port's first request would pay for what the JAX
package's pays in XLA compiles: ``nvcc`` on the CUDA kernels it launches
(``ops/roi_align_cuda.py:KernelBuild``), the loading of those libraries
and of cuDNN's and cuBLAS's kernels (CUDA loads a module at its first
launch), and the allocator's first growth. ``warm_start`` pays them when
the session is built, so its first request builds nothing:

* ``build``: the libraries the serving path launches (``serving_stems``:
  at the session's geometry and align settings, as the JAX warm-up
  compiles only the serving pieces), built or loaded. ``start_build``
  runs this piece on a worker thread, so that ``init_inference`` overlaps
  it with the model's construction and its weights' init or load, as
  the JAX warm-up overlaps its compiles with the parameter build;
* ``load``: one ``empty_launch`` of the direct kernel on the session's
  device, which loads its module there;
* ``forward``: one forward at the session's batch, canvas and ``raw``
  mode, under ``torch.inference_mode``, on a ``utils/synthetic.py`` scene
  from its own generator, then a synchronisation. Not on zeros: the
  proposal NMS and the PnP are data-dependent loops, and the JAX package
  measured a warm-up on zeros slower than none (388 s against 54 s for its
  first batch), so the scene is a real one. The forward draws from a
  generator of its own, and ``InferenceSession.run`` seeds its own on
  every call, so nothing of it reaches a later request.

Unlike the JAX warm-up, which prints and goes on, a failed build or
launch here raises.
"""

from __future__ import annotations

import concurrent.futures as _fut
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import MonoRUnConfig
from ..models.detector import HeadDraws, MonoRUn, compute_dtype, head_slot_count
from ..ops import roi_align_cuda as rc
from ..ops.roi_align import align_choice
from .synthetic import synthetic_scene_batch

# the source of each kernel route of ``ops/roi_align.py:align_choice``
ROUTE_STEMS = {"kernel": "roi_align", "tiered": rc.band_tiered_kernel.lib,
               "bandmm": rc.band_matmul_kernel.lib}
WARM_SEED = 0


def serving_stems(cfg: MonoRUnConfig, batch_size: int) -> Tuple[str, ...]:
    """The sources (``csrc/<stem>.cu``) whose kernels a forward of
    ``batch_size`` images launches on the GPU under the align settings in
    the environment: the routes ``align_choice`` gives the proposals' and
    the detections' aligns (``rpn_nms_post`` proposals per image, as
    ``get_proposals`` gives at every preset's canvas, and the head
    slots)."""
    dtype = compute_dtype(cfg)
    stems = []
    for n_rois in (batch_size * cfg.test.rpn_nms_post, batch_size * head_slot_count(cfg)):
        stem = ROUTE_STEMS.get(align_choice(n_rois, dtype, on_cuda=True).impl)
        if stem and stem not in stems:
            stems.append(stem)
    return tuple(stems)


def _build(stems: Tuple[str, ...]) -> float:
    t0 = time.perf_counter()
    if stems:
        rc.build_all(stems)
    return time.perf_counter() - t0


def start_build(stems: Tuple[str, ...]) -> "_fut.Future[float]":
    """Piece ``build`` on a worker thread; its result is the build's
    seconds, and re-raises what the build raised."""
    ex = _fut.ThreadPoolExecutor(max_workers=1, thread_name_prefix="warm_build")
    try:
        return ex.submit(_build, tuple(stems))
    finally:
        ex.shutdown(wait=False)


def warm_inputs(cfg: MonoRUnConfig, batch_size: int, device: torch.device, raw: bool):
    """The warm forward's request: one synthetic scene (seeded
    ``WARM_SEED``) repeated over the batch, as ``run`` takes it: the
    normalised padded image, or with ``raw`` the uint8 canvas at native
    resolution."""
    d = cfg.data
    hw = (d.raw_height, d.raw_width) if raw else (d.pad_height, d.pad_width)
    scene = synthetic_scene_batch(cfg, 1, hw, seed=WARM_SEED)
    images = scene["images"]
    if raw:
        pixels = images * np.asarray(d.img_std, np.float32) + np.asarray(d.img_mean, np.float32)
        images = np.clip(np.rint(pixels), 0, 255).astype(np.uint8)

    def batch(x, dtype=None):
        t = torch.as_tensor(x, dtype=dtype).to(device)
        return t.expand(batch_size, *t.shape[1:]).contiguous()

    return (batch(images), batch(scene["cam"], torch.float32),
            batch(scene["img_shapes"], torch.float32))


def warm_start(
    cfg: MonoRUnConfig,
    model: MonoRUn,
    batch_size: int,
    device: torch.device,
    raw: bool = False,
    build: Optional["_fut.Future[float]"] = None,
) -> Dict[str, float]:
    """Warms ``model`` (already cast and on ``device``, in eval mode) for
    requests of ``batch_size``; returns the seconds of each piece:
    ``build`` (the build's own time), ``build_wait`` (how long this call
    waited for it), ``load`` and ``forward``. ``build`` is the
    ``start_build`` future of ``serving_stems``, when the caller started
    it earlier; else the build runs here. On the CPU nothing is built or
    loaded, and only the forward runs."""
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    stems = serving_stems(cfg, batch_size) if on_cuda else ()
    times = {}
    t0 = time.perf_counter()
    times["build"] = build.result() if build is not None else _build(stems)
    times["build_wait"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if "roi_align" in stems:
        rc.roi_align_kernel.empty_launch(device)
        torch.cuda.synchronize(device)
    times["load"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    images, cam, shapes = warm_inputs(cfg, batch_size, device, raw)
    generator = torch.Generator(device=device).manual_seed(WARM_SEED)
    fn = model.serve_raw if raw else model
    with torch.inference_mode():
        fn(images, cam, shapes, HeadDraws(), generator)
    if on_cuda:
        torch.cuda.synchronize(device)
    times["forward"] = time.perf_counter() - t0
    return times
