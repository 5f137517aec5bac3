"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Counterpart of ``repro/launch/train.py``: a real training loop (synthetic
deterministic data) with checkpointing, restart and straggler monitoring,
on ``cuda`` unless given ``--device cpu``.  ``--reduced`` (the default)
trains the smoke-scale config, ``--full`` the published one.  It prints
one JSON line: ``arch``, ``steps_run``, ``wall_s``, ``loss_first``,
``loss_last``, ``stragglers``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import LmSyntheticTask
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import Transformer, TransformerConfig
from repro_torch.train import fault
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer


def make_lm_run(cfg: TransformerConfig, *, batch: int, seq: int, lr: float,
                steps: int, microbatches: int = 1, device: DeviceLike = None,
                model: Optional[Transformer] = None, seed: int = 0) -> tuple:
    """(step_fn, batches_fn, state) for `fault.ResumableRun`.

    ``model``: the `Transformer` to train, with its weights as they are;
    by default one drawn on ``device`` from ``torch.Generator(device)
    .manual_seed(seed)``.  The state is (params, opt_state) with params the
    model's own parameters by state-dict name (``requires_grad`` turned
    on); ``step_fn(state, (tokens, targets))`` trains them in place and
    returns (state, metrics as floats: ``loss``, ``grad_norm``, ``lr``),
    so a step ends when the device has finished it."""
    dev = resolve_device(device) if model is None else model.device
    if model is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = Transformer(cfg, generator=gen, device=dev)
    model.requires_grad_(True)
    task = LmSyntheticTask(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    opt_cfg = opt_lib.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 1),
                                  total_steps=steps)
    model_params = dict(model.named_parameters())

    def loss(params, tokens, targets):
        # ``params`` are the model's own parameters (checked in step_fn)
        return model.loss(tokens, targets)

    step = trainer.make_train_step(loss, opt_cfg,
                                   param_dtype=cfg.torch_dtype,
                                   microbatches=microbatches)

    def step_fn(state, batch_np):
        params, opt_state = state
        if params.keys() != model_params.keys() or any(
                params[k] is not p for k, p in model_params.items()):
            raise ValueError("the state's params are not the model's "
                             "parameters")
        tokens, targets = (torch.from_numpy(b).to(dev) for b in batch_np)
        params, opt_state, metrics = step(params, opt_state,
                                          (tokens, targets))
        return (params, opt_state), {k: float(v) for k, v in metrics.items()}

    def batches_fn(i):
        return task.batch(i)

    opt_state = opt_lib.init(model_params, opt_cfg)
    return step_fn, batches_fn, (model_params, opt_state)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Train an LM on synthetic data.")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="runs/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (drill)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    entry = registry.get(args.arch)
    if entry.family != "lm":
        raise SystemExit(f"train.py drives LM archs; {args.arch} is "
                         f"{entry.family!r}")
    cfg = entry.reduced if args.reduced else entry.config

    step_fn, batches_fn, state = make_lm_run(
        cfg, batch=args.batch, seq=args.seq, lr=args.lr, steps=args.steps,
        device=args.device)
    run = fault.ResumableRun(args.ckpt_dir, checkpoint_every=args.ckpt_every)
    injector = (fault.FailureInjector(fail_at_steps=(args.fail_at,))
                if args.fail_at >= 0 else None)
    monitor = fault.StragglerMonitor()

    t0 = time.monotonic()
    state, done, history = run.run(step_fn, state, batches_fn, args.steps,
                                   injector=injector, monitor=monitor)
    dt = time.monotonic() - t0
    losses = [h["loss"] for h in history]
    out = {
        "arch": cfg.name, "steps_run": done, "wall_s": round(dt, 2),
        "loss_first": round(float(losses[0]), 4) if losses else None,
        "loss_last": round(float(losses[-1]), 4) if losses else None,
        "stragglers": len(monitor.straggler_steps),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
