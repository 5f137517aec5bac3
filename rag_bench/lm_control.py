"""The control of the LM generator's ``correct``: the cell run through
``harness.run_cell`` with the served model's weights at a precision
below the configuration's bfloat16, float8 e4m3 with a per-tensor scale
(`fp8_roundtrip`, put in place after the warm-up through the harness's
``fault`` hook), still computing in bfloat16.  The run's own comparison
reads it; a limit holds only if this run comes out not ``correct``.

    python3 rag_bench/lm_control.py --workload dsv2lite-rag8k --seeds s1,s2,... [--seconds 12]

For each seed, one JSON line: ``correct``, each checked number with its
limit, the requests attempted and the device's peak memory.  Not part of
a benchmark run."""

from __future__ import annotations

import argparse
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

E4M3_MAX = 448.0


def fp8_roundtrip(model) -> None:
    """Round every matrix of ``model`` to float8 e4m3 with a per-tensor
    scale (its largest magnitude over 448) and back to its dtype, in
    place (a captured decode graph reads the new values)."""
    import torch

    with torch.no_grad():
        for p in model.parameters():
            if p.dim() < 2:
                continue
            w = p.float()
            scale = w.abs().amax().clamp(min=1e-30) / E4M3_MAX
            p.copy_((w / scale).to(torch.float8_e4m3fn).float() * scale)
            del w


def readings(cell_name: str, seed: int, *, seconds: float = 12.0,
             device="cuda", config_overrides: dict = None) -> dict:
    from rag_bench import harness

    out = harness.run_cell(
        cell_name, seed=seed, seconds=seconds, trace=False, device=device,
        config_overrides=config_overrides,
        fault=lambda program: fp8_roundtrip(program.gen.model),
        log=io.StringIO())
    return dict(cell=cell_name, seed=seed, correct=out["correct"],
                attempted=out["attempted"],
                checks={n: c["value"] for n, c in out["checks"].items()},
                limits={n: c["limit"] for n, c in out["checks"].items()},
                peak_gb=out["device"]["memory_peak_bytes"] / 1e9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the LM generator's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s),
                                  seconds=args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
