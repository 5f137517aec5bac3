"""The control at a size a test run holds: the reference in the program's
place in bfloat16 fails the cell's first-stage limit on every seed, and
in float32 passes it."""

import pytest
import torch

from rag_bench import control, manifest


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
def test_the_bfloat16_control_fails_and_float32_passes(seed):
    torch.set_num_threads(2)
    limits = manifest.load_json("cells", "rag768-sat")["limits"]
    out = control.readings("rag768-sat", seed, device="cpu", sample=128,
                           config_overrides={"num_docs": 20_000,
                                             "queries": {"pool": 512,
                                                         "jitter": 0.15}})
    assert out["cand_gap.bfloat16"] > limits["cand_gap"]
    assert out["cand_gap.float32"] <= limits["cand_gap"]
    assert out["topk_gap.float32"] <= limits["topk_gap"]
