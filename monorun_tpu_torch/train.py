"""Train state, optimizer, schedule and the train step, the PyTorch
counterpart of ``monorun_tpu/train.py``.

The optimizer is the JAX package's: frozen stages (the backbone's stem and
layer1) get no update; the rest runs non-finite leaf zapping, then the
gradient clip (a global norm of 35, or per-group norms), then AdamW as
optax computes it (moments, bias correction, eps outside the square root,
decoupled weight decay, then the scheduled learning rate: linear warmup
into a cosine decay). The step follows ``config.apply_loss_schedule`` and
threads the projection loss's EMA (``TrainState.loss_ema``). Two flaws of
the reference are kept, so the two packages report the same values: a
group ``max_norm`` of 0 counts as missing (``clip_by_group_norms``), and
``param_grad_stats`` reports the gradients before the clip.

Entry points run on the GPU (``device="cuda"``) unless the caller asks
for another device; without a GPU they raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from .config import MonoRUnConfig, apply_loss_schedule, get_config
from .models.detector import MonoRUn, TrainDraws, init_random_weights
from .parallel import all_reduce_sum

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    """What JAX's ``TrainState`` holds beside the weights and the optimizer
    state, which live in the model and the ``AdamW`` here."""

    step: int
    loss_ema: Tensor          # the projection loss's mean inverse std (scalar)

    def to_dict(self) -> Dict[str, object]:
        return {"step": self.step, "loss_ema": self.loss_ema.detach().cpu()}

    @classmethod
    def from_dict(cls, d: Dict[str, object], device: str | torch.device) -> "TrainState":
        return cls(step=int(d["step"]),
                   loss_ema=torch.as_tensor(d["loss_ema"], dtype=torch.float32).to(device))


def _is_frozen(name: str) -> bool:
    """frozen_stages=1: the backbone's stem and layer1 do not train."""
    return name.startswith(("backbone.conv1.", "backbone.bn1.", "backbone.layer1."))


def make_lr_schedule(cfg: MonoRUnConfig, total_steps: int):
    """step -> learning rate (float32): linear warmup from lr *
    warmup_ratio over warmup_iters, then a cosine decay to 0 over the rest
    (optax ``linear_schedule`` joined to ``cosine_decay_schedule``)."""
    tr = cfg.train
    f32 = torch.float32
    decay_steps = float(max(total_steps - tr.warmup_iters, 1))

    def schedule(step: int) -> Tensor:
        if step < tr.warmup_iters:
            count = torch.tensor(min(max(step, 0), tr.warmup_iters), dtype=torch.int32)
            frac = 1 - count / tr.warmup_iters
            return (tr.lr * tr.warmup_ratio - tr.lr) * frac + tr.lr
        count = torch.minimum(torch.tensor(float(step - tr.warmup_iters), dtype=f32),
                              torch.tensor(decay_steps, dtype=f32))
        cosine = 0.5 * (1 + torch.cos(math.pi * count / decay_steps))
        return tr.lr * ((1 - 0.0) * cosine + 0.0)

    return schedule


def zap_nonfinite(grads: Sequence[Tensor]) -> List[Tensor]:
    """Zero every gradient leaf that holds a non-finite value (before the
    clip: one such leaf would make the global norm, and so every update,
    NaN)."""
    return [torch.where(torch.isfinite(g).all(), g, torch.zeros_like(g)) for g in grads]


def count_nonfinite_leaves(grads: Iterable[Tensor]) -> Tensor:
    return sum((~torch.isfinite(g).all()).int() for g in grads)


def global_norm(grads: Iterable[Tensor]) -> Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(grads: Sequence[Tensor], max_norm: float) -> List[Tensor]:
    """optax ``clip_by_global_norm``: unchanged below max_norm, else scaled
    to it."""
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]


def clip_by_group_norms(
    names: Sequence[str], grads: Sequence[Tensor], default_norm: float,
    paramwise: Sequence[Tuple[str, float]],
) -> List[Tensor]:
    """Per-group clipping (torch ``clip_grad_norm_`` semantics per group):
    a parameter whose name contains a ``paramwise`` key joins that key's
    group (the first key that matches), the rest clip at ``default_norm``;
    scale = min(1, max_norm / (group norm + 1e-6)). A key's max_norm of 0
    counts as missing (the reference's ``or``)."""
    paramwise = dict(paramwise)

    def group_of(name: str) -> str:
        for k in paramwise:
            if k in name:
                return k
        return ""

    groups = [group_of(n) for n in names]
    sumsq: Dict[str, list] = {}
    for g, leaf in zip(groups, grads):
        sumsq.setdefault(g, []).append(torch.sum(leaf * leaf))
    scale = {g: torch.clamp((paramwise.get(g) or default_norm) / (torch.sqrt(sum(v)) + 1e-6),
                            max=1.0)
             for g, v in sumsq.items()}
    return [leaf * scale[g] for g, leaf in zip(groups, grads)]


class AdamW:
    """The JAX package's optimizer over named parameters (``make_optimizer``):
    the frozen ones get a zero update and no moments; the trainable ones run
    ``zap_nonfinite``, the clip and optax's AdamW with the scheduled rate.
    ``update(grads)`` returns the updates, in the order of ``names``;
    ``step(grads)`` also adds them to the parameters."""

    def __init__(self, cfg: MonoRUnConfig, named_params: Iterable[Tuple[str, Tensor]],
                 total_steps: int, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        tr = cfg.train
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.trainable = [not _is_frozen(n) for n in self.names]
        self.schedule = make_lr_schedule(cfg, total_steps)
        self.max_norm = tr.grad_clip_norm
        self.paramwise = tr.grad_clip_paramwise
        self.weight_decay = tr.weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) if t else None for p, t in zip(self.params, self.trainable)]
        self.nu = [torch.zeros_like(p) if t else None for p, t in zip(self.params, self.trainable)]

    @torch.no_grad()
    def update(self, grads: Sequence[Tensor]) -> List[Tensor]:
        idx = [i for i, t in enumerate(self.trainable) if t]
        g = zap_nonfinite([grads[i] for i in idx])
        if self.paramwise:
            g = clip_by_group_norms([self.names[i] for i in idx], g, self.max_norm,
                                    self.paramwise)
        else:
            g = clip_by_global_norm(g, self.max_norm)
        count = torch.tensor(self.count + 1, dtype=torch.int32)
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** count
        lr = -1 * self.schedule(self.count)
        updates = [torch.zeros_like(p) for p in self.params]
        for i, gi in zip(idx, g):
            p = self.params[i]
            self.mu[i] = (1 - self.b1) * gi + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * (gi * gi) + self.b2 * self.nu[i]
            mu_hat = self.mu[i] / bc1.to(p.device)
            nu_hat = self.nu[i] / bc2.to(p.device)
            u = mu_hat / (torch.sqrt(nu_hat + 0.0) + self.eps)
            u = u + self.weight_decay * p
            updates[i] = lr.to(device=p.device, dtype=p.dtype) * u
        self.count += 1
        return updates

    @torch.no_grad()
    def step(self, grads: Sequence[Tensor]) -> None:
        for p, u in zip(self.params, self.update(grads)):
            p.add_(u)

    def state_dict(self) -> Dict[str, object]:
        """The update count and the moments of the trainable parameters,
        keyed by parameter name, copied to the host."""
        def host(moments):
            return {n: m.detach().cpu() for n, m in zip(self.names, moments) if m is not None}

        return {"count": self.count, "mu": host(self.mu), "nu": host(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restores ``state_dict()``'s output; the moments go to their
        parameters' devices. The trainable parameters must be the same."""
        if list(state["mu"]) != [n for n, t in zip(self.names, self.trainable) if t]:
            raise ValueError("the optimizer state is for other parameters")
        for i, (n, p) in enumerate(zip(self.names, self.params)):
            if self.trainable[i]:
                self.mu[i] = state["mu"][n].to(p.device, p.dtype, copy=True)
                self.nu[i] = state["nu"][n].to(p.device, p.dtype, copy=True)
        self.count = int(state["count"])


def make_optimizer(cfg: MonoRUnConfig, model: torch.nn.Module, total_steps: int) -> AdamW:
    return AdamW(cfg, model.named_parameters(), total_steps)


def create_train_state(
    config: str | MonoRUnConfig, total_steps: int, device: str | torch.device = "cuda",
    seed: int = 0,
) -> Tuple[MonoRUn, TrainState, AdamW]:
    """A model with seeded random weights (float32 parameters; the layers
    compute in ``cfg.compute_dtype``), its train state and optimizer. The
    weights follow the JAX package's training init (flax's traced init:
    ``lecun_normal``, a truncated normal)."""
    from .apis.inference import resolve_device

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(config) if isinstance(config, str) else config
    model = init_random_weights(MonoRUn(cfg), torch.Generator().manual_seed(seed),
                                truncated=True).to(device)
    state = TrainState(step=0, loss_ema=torch.ones((), device=device))
    return model, state, make_optimizer(cfg, model, total_steps)


def _module_of(name: str) -> str:
    """The JAX package's top-level module of a parameter: its params
    tree's first key."""
    head, _, rest = name.partition(".")
    if head == "roi_head":
        sub = rest.partition(".")[0]
        return "cov_calib_logscale" if sub == "pose_head" else sub
    return head


def grad_stats(names: Sequence[str], grads: Sequence[Tensor]) -> Dict[str, Tensor]:
    """Gradient norms per top-level module and in total."""
    by_module: Dict[str, list] = {}
    for n, g in zip(names, grads):
        by_module.setdefault(_module_of(n), []).append(g)
    out = {f"gnorm/{k}": global_norm(v) for k, v in by_module.items()}
    out["gnorm/total"] = global_norm(grads)
    return out


def param_grad_stats(names: Sequence[str], grads: Sequence[Tensor],
                     params: Sequence[Tensor]) -> Dict[str, Tensor]:
    """rms and mean of every parameter's gradient (before the clip) and
    weight, keyed by parameter name."""
    out: Dict[str, Tensor] = {}
    for prefix, leaves in (("grad", grads), ("weight", params)):
        for n, leaf in zip(names, leaves):
            leaf = leaf.float()
            out[f"{prefix}/{n}/rms"] = torch.sqrt(torch.mean(leaf * leaf))
            out[f"{prefix}/{n}/mean"] = torch.mean(leaf)
    return out


def train_step(
    model: MonoRUn,
    optimizer: AdamW,
    state: TrainState,
    batch: Dict[str, Tensor],
    draws: TrainDraws = TrainDraws(),
    generator: Optional[torch.Generator] = None,
    with_grad_stats: bool = False,
    with_param_stats: bool = False,
) -> Tuple[TrainState, Dict[str, Tensor]]:
    """One optimisation step: the losses at the config the loss schedule
    gives this step, the gradient of every parameter, the optimizer's
    update. Returns the new state and the metrics (the losses, mean_iou,
    total_loss, nonfinite_grad_leaves).

    Data-parallel (a process group of N ranks, ``parallel/``): ``batch``
    and ``draws`` are this rank's rows of the global batch, and each rank's
    losses are its share of the global batch's (``train_forward``). So the
    gradient is summed over the ranks (SUM, not a mean), in one flat
    all-reduce, before the zap, the clip and AdamW: every rank then takes
    JAX's global-batch update, and the parameters, ``loss_ema`` and the
    score BatchNorm's statistics stay equal on every rank. Every gradient
    is reduced, the frozen ones too, so that the statistics taken after it
    are the global batch's. The logged losses and ``mean_iou`` are summed
    over the ranks too."""
    cfg = apply_loss_schedule(model.cfg, state.step)
    params = optimizer.params
    total, (metrics, new_ema) = model.train_forward(batch, state.loss_ema, draws, generator,
                                                    cfg=cfg)
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = all_reduce_sum([torch.zeros_like(p) if g is None else g
                            for p, g in zip(params, grads)])
    stats = {}
    if with_grad_stats:
        stats.update(grad_stats(optimizer.names, grads))
    if with_param_stats:
        stats["param_stats"] = param_grad_stats(optimizer.names, grads,
                                                [p.detach().clone() for p in params])
    optimizer.step(grads)
    metrics = dict(metrics, total_loss=total)
    metrics = dict(zip(metrics, all_reduce_sum([v.detach() for v in metrics.values()])))
    metrics["nonfinite_grad_leaves"] = count_nonfinite_leaves(grads)
    metrics.update(stats)
    return TrainState(step=state.step + 1, loss_ema=new_ema.detach()), metrics
