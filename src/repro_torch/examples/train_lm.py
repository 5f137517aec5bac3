"""End-to-end training driver: ~100M-param LM for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

Counterpart of ``examples/train_lm.py``: trains a ~100M llama-style model
(the same code path as the full llama3-8b config) on the deterministic
synthetic LM task with checkpointing, a mid-run injected failure and an
automatic restart, and straggler monitoring; the fault-tolerance drill is
part of the example.  Runs on ``cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import shutil

from repro_torch.configs import registry  # noqa: F401 (registry self-check)
from repro_torch.device import DeviceLike
from repro_torch.launch.train import make_lm_run
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train import fault


def config_100m() -> TransformerConfig:
    # ~100M params: 12L x d512 x ff2048, vocab 32768
    return TransformerConfig(
        name="llama-100m", n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
        d_ff=2048, vocab=32768, d_head=64, dtype="float32", remat=False,
        kv_chunk=256)


def drill(cfg: TransformerConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: str, ckpt_every: int, fail_at: int,
          device: DeviceLike = None, lr: float = 3e-3) -> tuple:
    """Train ``steps`` steps into ``ckpt_dir``, die at step ``fail_at``,
    then restart from the newest checkpoint.  A restart builds the run
    anew (model, step function, state) as a new process would, and the
    checkpoint is restored into it.  Returns (the resumed run's state,
    steps it ran, its history, the straggler monitor)."""
    step_fn, batches_fn, state = make_lm_run(
        cfg, batch=batch, seq=seq, lr=lr, steps=steps, device=device)
    run = fault.ResumableRun(ckpt_dir, checkpoint_every=ckpt_every)
    monitor = fault.StragglerMonitor()
    injector = fault.FailureInjector(fail_at_steps=(fail_at,))
    try:
        run.run(step_fn, state, batches_fn, steps, injector=injector,
                monitor=monitor)
    except fault.InjectedFailure as e:
        print(f"[drill] {e} — restarting from checkpoint "
              f"step {run.latest()}")
    step_fn, batches_fn, state = make_lm_run(
        cfg, batch=batch, seq=seq, lr=lr, steps=steps, device=device)
    state, done, history = run.run(step_fn, state, batches_fn, steps,
                                   injector=injector, monitor=monitor)
    return state, done, history, monitor


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="runs/train_lm_100m")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = config_100m()
    n_params = cfg.param_count()
    print(f"training {cfg.name}: {n_params/1e6:.0f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    # drill: die a third of the way in, then resume from checkpoint
    _, done, history, monitor = drill(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=50, fail_at=args.steps // 3,
        device=args.device)

    losses = [h["loss"] for h in history]
    print(f"resumed and ran {done} steps")
    print(f"loss: first={losses[0]:.3f}  last={losses[-1]:.3f}")
    print(f"stragglers flagged: {len(monitor.straggler_steps)}")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss must decrease over the run")
    return history


if __name__ == "__main__":
    main()
