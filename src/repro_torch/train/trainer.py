"""Training step builders + the driver loop.

Counterpart of ``repro/train/trainer.py``.  `make_train_step(loss_fn,
opt_cfg, ...)` returns a function (params, opt_state, batch) -> (params,
opt_state, metrics).  ``params`` is a dict of the tensors the loss reads
(a module's own parameters, with ``requires_grad`` on); the step takes
their gradients with ``torch.autograd.grad`` and `optimizer.apply`
updates them in place.  Gradient accumulation over microbatches follows
the reference's scan: each microbatch's gradients are summed into fp32
zeros and divided by the count, and the loss reported is the last
microbatch's.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.train import optimizer as opt_lib


def value_and_grad(loss_fn: Callable, params: dict, batch) -> tuple:
    """(loss, {name: gradient}) of ``loss_fn(params, *batch)``; a
    parameter the loss does not read gets zeros, as ``jax.grad`` gives."""
    loss = loss_fn(params, *batch)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(params[n]) if g is None else g
        for n, g in zip(names, grads)}


def make_train_step(loss_fn: Callable, opt_cfg: opt_lib.AdamWConfig, *,
                    microbatches: int = 1,
                    param_dtype: Optional[torch.dtype] = None,
                    grad_transform: Optional[Callable] = None):
    """loss_fn(params, *batch_leaves) -> scalar tensor.

    ``grad_transform(grads) -> grads`` hooks in gradient compression.  With
    one microbatch the gradients reach `optimizer.apply` in the
    parameters' dtype; with more, every batch leaf's leading axis is split
    into ``microbatches`` equal parts."""

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            for x in batch:
                if x.shape[0] % microbatches:
                    raise ValueError(f"batch axis {x.shape[0]} does not "
                                     f"split into {microbatches} microbatches")
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            for i in range(microbatches):
                mb = tuple(x[i * (x.shape[0] // microbatches):
                             (i + 1) * (x.shape[0] // microbatches)]
                           for x in batch)
                loss, g = value_and_grad(loss_fn, params, mb)
                for n, acc in grads.items():
                    acc.add_(g[n])
                del g
            for acc in grads.values():
                acc.div_(microbatches)
        if grad_transform is not None:
            grads = grad_transform(grads)
        new_params, new_state, stats = opt_lib.apply(
            grads, opt_state, opt_cfg, params=params, param_dtype=param_dtype)
        return new_params, new_state, {"loss": loss, **stats}

    return train_step


def fit(train_step, params, opt_state, batches, *, hooks=(),
        checkpoint_fn=None, checkpoint_every: int = 0,
        deadline_per_step: Optional[float] = None):
    """Host driver: iterates batches, runs hooks, optional checkpointing and
    straggler deadline accounting (see train/fault.py).  Reading each
    step's metrics as floats waits for the device, so ``step_time_s`` is
    the step's own."""
    history = []
    for step, batch in enumerate(batches):
        t0 = time.monotonic()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.monotonic() - t0
        metrics["step_time_s"] = dt
        metrics["straggler"] = bool(deadline_per_step and dt > deadline_per_step)
        history.append(metrics)
        for h in hooks:
            h(step, params, opt_state, metrics)
        if checkpoint_fn and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            checkpoint_fn(step, params, opt_state)
    return params, opt_state, history


__all__ = ["value_and_grad", "make_train_step", "fit"]
