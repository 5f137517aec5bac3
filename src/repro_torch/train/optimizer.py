"""AdamW + global-norm clipping + cosine schedule.

Counterpart of ``repro/train/optimizer.py``.  Parameters, gradients and the
optimizer's trees are flat dicts keyed by parameter name (a `Transformer`'s
state-dict names); the state holds an fp32 ``master`` copy and the moments
``m`` and ``v`` on the parameters' device.  `apply` updates the state's
tensors and the parameters in place, under ``no_grad``.

The arithmetic is the reference's, op for op, in float32: the schedule
too, on 0-d tensors on the state's device (a Python double would differ
from the reference's float32 by an ulp, and a device tensor keeps the step
free of host synchronisation).

The mesh items: `abstract_init` (the state's shapes as float32 ``meta``
tensors) and `state_specs` (the state's placements mirror the
parameters').
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.launch.mesh import ShardSpec

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor     # () int32, on the parameters' device
    master: Params         # fp32 copy of the parameters
    m: Params
    v: Params


def init(params: Params, cfg: AdamWConfig) -> OptState:
    """Step 0, ``master`` an fp32 copy of ``params`` (never aliasing
    them), zero moments."""
    del cfg
    dev = next(iter(params.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master={k: p.detach().to(torch.float32, copy=True)
                for k, p in params.items()},
        m={k: zeros(p) for k, p in params.items()},
        v={k: zeros(p) for k, p in params.items()})


def abstract_init(abstract_params: Params, cfg: AdamWConfig) -> OptState:
    """`init`'s state as ``meta`` tensors (a () int32 step; float32
    master, m and v of the parameters' shapes); allocates nothing."""
    del cfg
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    tree = lambda: {k: f32(p) for k, p in abstract_params.items()}
    return OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                    master=tree(), m=tree(), v=tree())


def state_specs(param_specs: Dict[str, ShardSpec]) -> OptState:
    """Placements of the optimizer state: the step replicated, master, m
    and v as the parameters (``param_specs``: name -> ShardSpec)."""
    return OptState(step=ShardSpec.of(), master=dict(param_specs),
                    m=dict(param_specs), v=dict(param_specs))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` x lr at
    ``total_steps``; a float32 0-d tensor on ``step``'s device (an int
    step: the CPU)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sums = [g.float().square().sum() for g in tree.values()]
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def apply(grads: Params, state: OptState, cfg: AdamWConfig, *,
          params: Params, param_dtype: Optional[torch.dtype] = None) -> tuple:
    """One AdamW step: clip, cast the grads to fp32, update the moments and
    the master, then copy the master (cast to ``param_dtype`` when given)
    into ``params``.  Returns (params, new state, {"grad_norm", "lr"}); the
    new state shares ``state``'s tensors, updated in place."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        # a true division (a Python number over a tensor is a reciprocal
        # times the number in PyTorch)
        scale = torch.clamp(gnorm.new_tensor(cfg.clip_norm) / (gnorm + 1e-9),
                            max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.beta1 ** stepf
    b2c = 1 - cfg.beta2 ** stepf
    for name, g in grads.items():
        g = g.float() * scale if scale is not None else g.float()
        m, v, p = state.m[name], state.v[name], state.master[name]
        m.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
        v.mul_(cfg.beta2).add_((1 - cfg.beta2) * g * g)
        mh = m / b1c
        vh = v / b2c
        p.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps)
                     + cfg.weight_decay * p))
        params[name].copy_(p if param_dtype is None else p.to(param_dtype))
    return params, OptState(step, state.master, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "OptState", "init", "abstract_init", "state_specs",
           "schedule", "global_norm", "apply"]
