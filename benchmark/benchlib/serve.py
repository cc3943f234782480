"""A served cell: ``InferenceSession.run`` (``raw=True``) and
``detections_to_host`` in a closed loop of one client, the batches and
the heads' random draws made by the benchmark from the seed."""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Dict, List, Optional

import numpy as np

from . import env, scenes, serve_check, weights
from .control import float8_layers
from .spec import Cell, build_config


class ServeRun:
    """One run of a served cell: set-up, window, trace, check."""

    def __init__(self, cell: Cell, seed: int, device="cuda"):
        import torch
        from monorun_tpu_torch.apis.inference import InferenceSession
        from monorun_tpu_torch.config import MonoRUnConfig
        from monorun_tpu_torch.models.detector import MonoRUn, compute_dtype

        self.cell, self.seed = cell, seed
        self.cfg_dict = cell.config["config"]
        self.traffic = cell.traffic
        self.device = torch.device(device)
        cfg = build_config(MonoRUnConfig, self.cfg_dict)
        # the program's entry (init_inference) serves float32 without TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        lap = env.Laps()
        self.requests = scenes.make_requests(self.cfg_dict, self.traffic, seed, self.device)
        lap("traffic")
        model = weights.build(MonoRUn, cfg, seed, self.device)
        lap("weights")
        B = self.traffic["batch"]
        self.session = InferenceSession(cfg, model, B, self.device, raw=True, warm=True)
        lap("session")
        g = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.draws = [scenes.head_draws(self.cfg_dict, B, compute_dtype(cfg), g, self.device)
                      for _ in range(self.traffic["draw_sets"])]
        # every distinct request once: the shapes are the cell's one shape,
        # and each batch and draw set has been on the device once
        for i in range(max(len(self.requests.batches), len(self.draws))):
            self.request(i)
        self.sync()
        lap("warm requests")
        self.setup_laps = lap.laps

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def request(self, i: int):
        from monorun_tpu_torch.apis.inference import detections_to_host
        from monorun_tpu_torch.models.detector import HeadDraws

        masks, keys = self.draws[i % len(self.draws)]
        det = self.session.run(*self.requests[i], seed=i, draws=HeadDraws(masks, keys))
        return detections_to_host(det)[0]

    def window(self, seconds: float) -> Dict[str, Any]:
        """The window's requests, each waited for: the next batch is sent
        when the last one's detections are back, until ``seconds`` have
        passed. A request's latency runs from its send to its detections
        on the host."""
        lat: List[float] = []
        answers: List[Dict[str, np.ndarray]] = []
        t0 = time.perf_counter()
        end = t0
        while end - t0 < seconds:
            sent = time.perf_counter()
            answers.append(self.request(len(lat)))
            end = time.perf_counter()
            lat.append(end - sent)
        return dict(latency_s=lat, answers=answers, window_s=end - t0,
                    frames=len(lat) * self.requests.batch)

    def traced(self, n: int):
        """``n`` requests under the profiler, the program's stages marked."""
        from torch.profiler import ProfilerActivity, profile, record_function
        from monorun_tpu_torch.utils.stages import STAGES, timing

        from .trace import reduce_profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof, timing(self.session.model, record_function):
            t0 = time.perf_counter()
            for i in range(n):
                self.request(i)
            self.sync()
            wall = time.perf_counter() - t0
        return reduce_profile(prof, STAGES, n, wall)

    def align_inputs(self, n: int):
        """The proposals' align inputs (levels, RoIs, head, output size) of
        requests 0 to ``n - 1``: each request's first align call, read by
        wrapping the program's align in an untraced pass."""
        model = self.session.model
        seen: List[Any] = []
        inner = model._align

        def spy(feats, rois, head_cfg, out_size, tile_h, pyramid):
            if len(seen) <= request:
                n_lvl = len(head_cfg.featmap_strides)
                seen.append((list(feats[:n_lvl]), rois.clone(), head_cfg, out_size))
            return inner(feats, rois, head_cfg, out_size, tile_h, pyramid)

        model._align = spy
        try:
            for request in range(n):
                self.request(request)
        finally:
            del model._align
        return seen

    def free_program(self):
        import torch

        self.session = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def check(run: ServeRun, answers, n_requests: int, seed: int, limits: Dict[str, float],
          control: Optional[str] = None):
    """The sampled requests judged by the reference. With ``control``
    the reference in the configuration's dtype stands in the program's
    place on the same requests: ``"float8"`` (the control), its layers on
    float8 inputs and weights, or ``"stated"`` as it is."""
    from monorun_ref.config import MonoRUnConfig as RefConfig
    from monorun_ref.models.detector import MonoRUn as RefModel

    rng = np.random.default_rng(seed + 2)
    pick = sorted(rng.choice(n_requests, size=min(run.traffic["check_requests"], n_requests),
                             replace=False).tolist())
    model = serve_check.reference_model(RefConfig, RefModel, run.cfg_dict, run.seed,
                                        run.device)
    stated = serve_check.reference_model(RefConfig, RefModel, run.cfg_dict, run.seed,
                                         run.device, stated=True)
    slots = scenes.head_slots(run.cfg_dict)
    readings = []
    for i in pick:
        masks, keys = run.draws[i % len(run.draws)]
        req = run.requests[i]
        if control:
            ctx = float8_layers() if control == "float8" else contextlib.nullcontext()
            with ctx:
                served = serve_check.reference_answers(stated, req, masks, keys)["own"]
        else:
            served = answers[i]
        ref = serve_check.reference_answers(model, req, masks, keys, served)
        ref16 = serve_check.reference_answers(stated, req, masks, keys, served)
        readings.append(serve_check.judge(served, ref, ref16, slots, run.cfg_dict,
                                          run.device))
    del model, stated
    got = serve_check.worst(readings)
    return [dict(name=k, value=v, limit=limits.get(k),
                 ok=limits.get(k) is not None and v <= limits[k])
            for k, v in got.items() if k in limits or not limits], pick


def run_cell(cell: Cell, args, t0: float, device: str, limits: Dict[str, float]):
    """One run: (the result line's fields, the checks)."""
    import torch

    from .cli import Context, read_metrics

    start = time.perf_counter()
    run = ServeRun(cell, args.seed, device)
    ctx = Context(setup_s=time.perf_counter() - t0)
    env.note(f"set-up {ctx.setup_s:.3f} s: before the cell {start - t0:.3f} s, "
             + ", ".join(f"{k} {v:.3f} s" for k, v in run.setup_laps.items()))
    w = run.window(args.seconds)
    ctx.window = dict(items=w["frames"], window_s=w["window_s"], latency_s=w["latency_s"])
    lat = sorted(w["latency_s"])
    env.note(f"window {w['window_s']:.3f} s: {len(lat)} requests, latency ms median "
             f"{1e3 * lat[len(lat) // 2]:.3f}, min {1e3 * lat[0]:.3f}, max {1e3 * lat[-1]:.3f}")
    n_trace = cell.traffic["trace_requests"]
    if args.trace:
        ctx.reduced = run.traced(n_trace)
    cuda = run.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    aligns = run.align_inputs(n_trace) if args.trace else []
    answers = w["answers"]
    run.free_program()
    checks, pick = check(run, answers, len(answers), args.seed, limits)
    if args.trace:
        ctx.bounds = dict(align_proposals=align_bound(run, aligns))
        ctx.flops_per_item = serve_flops(run)
    result = dict(
        correct=bool(checks) and all(c["ok"] for c in checks),
        attempted=len(answers), failed=0,
        metrics=read_metrics(cell, ctx, bool(args.trace)),
        device=env.device_block(cell.chips, peak) if cuda else dict(platform="cpu"),
        checked_requests=pick, card=env.card_line() if cuda else None,
    )
    if args.trace and ctx.reduced is not None:
        result["device"]["busy_s"] = ctx.reduced.busy_s
        result["device"]["window_s"] = ctx.reduced.window_s
        result["breakdown"] = ctx.reduced.breakdown()
    return result, checks


def align_bound(run: ServeRun, aligns) -> Optional[float]:
    """The least seconds per batch of the proposals' align on the traced
    requests' own inputs."""
    from . import alignwork

    if not aligns:
        return None
    total = 0.0
    for feats, rois, head_cfg, out_size in aligns:
        strides = alignwork.strides_of(run.cfg_dict["neck"]["lazy_lower"],
                                       head_cfg.featmap_strides)
        nbytes, flops = alignwork.align_work(feats, rois, strides, out_size,
                                             head_cfg.finest_scale, head_cfg.align_max_ratio)
        total += alignwork.bound_s(nbytes, flops)
    return total / len(aligns)


def serve_flops(run: ServeRun) -> float:
    """The reference's FLOPs per frame of the cell's forward."""
    import torch
    from monorun_ref.config import MonoRUnConfig as RefConfig
    from monorun_ref.models.detector import MonoRUn as RefModel

    from . import flops

    def count():
        model = serve_check.reference_model(RefConfig, RefModel, run.cfg_dict, run.seed,
                                            run.device)
        masks, keys = run.draws[0]
        with torch.no_grad():
            total = flops.counted(lambda: serve_check.reference_answers(
                model, run.requests[0], masks, keys))
        return total / run.requests.batch

    return flops.cached(["serve", run.cfg_dict, run.traffic["batch"],
                         run.traffic["image_hw"]], count)
