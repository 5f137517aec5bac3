"""Arithmetic the LM generator's metric readers share (the generator's
spans and records: ``repro_torch.serve.generate``)."""

from __future__ import annotations

from typing import Optional


def per_decode_step_ms(run, name: str) -> Optional[float]:
    """Milliseconds of ``name``'s spans over the traced window, per decode
    step (``decode_device`` span) in it."""
    t = run.tracer
    steps = t.count.get("decode_device", 0) if t is not None else 0
    if not steps or not t.count.get(name):
        return None
    return 1e3 * t.seconds[name] / steps


def decode_context(run) -> float:
    """A decode step's mean attended positions, its own included: the
    prompt plus half the answer (step j of a batch attends prompt + j,
    j = 1 .. answer - 1)."""
    return run.shapes["prompt_len"] + run.shapes["answer_len"] / 2


def experts_per_layer(run) -> Optional[float]:
    """The mean, over the ``experts_touched`` records left in the
    tracer's ring, of their ``count`` (summed over a step's MoE layers)
    over the number of MoE layers."""
    t = run.tracer
    if t is None:
        return None
    counts = [s.attrs["count"] for s in t.spans()
              if s.name == "experts_touched"]
    if not counts:
        return None
    return sum(counts) / len(counts) / run.shapes["moe_layers"]
