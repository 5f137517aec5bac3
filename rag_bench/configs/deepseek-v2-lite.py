"""DeepSeek-V2-Lite as the RAG generator: the program of the configuration
``deepseek-v2-lite`` (the harness's contract: ``harness.py``).

The port's model (`repro_torch.configs.deepseek_v2_lite.from_hf` of this
configuration's keys) is built with its weights drawn on the device from
the seed, tensor by tensor (`repro_torch.models.transformer.init_by_name`,
the served dtype); a pool of prompts of uniform token ids is drawn on the
device too.  Requests are served by `repro_torch.serve.generate.Generator`
(static batches of ``max_batch``: one prefill, then greedy decode steps
through the latent cache), warmed up on the cell's ``warmup`` batches.

``check`` (after ``close``) compares a sample of the finished requests
with the plain reference (``reference/deepseek_v2.py``), in float32 with
TF32 off, on the same weights redrawn one layer at a time, teacher-forced
on the served tokens: ``token_gap`` (the widest gap of a served token's
reference logit below the reference's best there), ``logit_err`` (the
largest |served logit − the reference's logit of that token|),
``missing`` (requests due with no ok result) and ``wire_errors`` (results
whose answer or transcript is not the configuration's size)."""

from __future__ import annotations

import math

import numpy as np
import torch

from rag_bench.reference import check as refcheck
from rag_bench.reference import deepseek_v2 as ref
from rag_bench.schedule import sub_seed

CHECKS = ("missing", "wire_errors", "token_gap", "logit_err")
POOL_TAG, WEIGHT_TAG, SAMPLE_TAG, WARMUP_TAG = 30, 31, 3, 4
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TOKEN_BYTES = 4


def prompts(cfg: dict, seed: int, device) -> torch.Tensor:
    """The pool: (pool, prompt_len) int32 ids, uniform over the
    vocabulary, drawn on ``device`` from the seed."""
    s = cfg["serving"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, POOL_TAG))
    return torch.randint(0, cfg["vocab_size"], (s["pool"], s["prompt_len"]),
                         generator=g, device=device, dtype=torch.int32)


def weight_seed(seed: int) -> int:
    return sub_seed(seed, WEIGHT_TAG)


class LmGenerator:
    """Built and warmed up on construction (see the module docstring)."""

    def __init__(self, cfg: dict, cell: dict, seed: int, device, tracer):
        from repro_torch.configs.deepseek_v2_lite import from_hf
        from repro_torch.models.transformer import Transformer, init_by_name
        from repro_torch.serve.generate import Generator

        mcfg = from_hf(cfg, dtype=cfg["precision"])
        serving = cfg["serving"]
        model = init_by_name(Transformer(mcfg, device="meta"),
                             weight_seed(seed), device)
        gen = Generator(model, max_batch=serving["max_batch"],
                        answer_len=serving["answer_len"], tracer=tracer)
        pool = prompts(cfg, seed, device)
        wkeys = np.random.default_rng(sub_seed(seed, WARMUP_TAG))
        for size in cell["warmup"]:
            for _ in range(size):
                gen.submit("warmup", pool[int(wkeys.integers(len(pool)))])
            gen.drain()
        self.cfg, self.cell, self.device = cfg, cell, device
        self.gen = gen
        self.pool = list(pool)
        self.tenants = ["user"]
        self.shapes = dict(model=cfg, prompt_len=serving["prompt_len"],
                           answer_len=serving["answer_len"],
                           moe_layers=(cfg["num_hidden_layers"]
                                       - cfg["first_k_dense_replace"]))

    # the generator's own methods, read when the harness binds them
    submit = property(lambda self: self.gen.submit)
    step = property(lambda self: self.gen.step)
    drain = property(lambda self: self.gen.drain)
    pending = property(lambda self: self.gen.pending)

    def close(self) -> None:
        self.gen.close()
        self.gen = self.pool = None

    def check(self, run, served, sched, seed: int) -> dict:
        cfg = self.cfg
        s, a = cfg["serving"]["prompt_len"], cfg["serving"]["answer_len"]
        rows = sorted(served.items())
        nums = dict(missing=len(run.due) - len(served),
                    wire_errors=sum(
                        1 for _, r in rows
                        if r.transcript.total_bytes != TOKEN_BYTES * (s + a)
                        or r.tokens.shape != (a,) or r.logits.shape != (a,)))
        rng = np.random.default_rng(sub_seed(seed, SAMPLE_TAG))
        take = min(self.cell["check_sample"], len(rows))
        sample = [rows[j] for j in sorted(rng.choice(len(rows), take,
                                                     replace=False))]
        if not sample:
            nums.update(token_gap=math.inf, logit_err=math.inf)
            return {name: nums[name] for name in CHECKS}
        dev = self.device
        with torch.no_grad(), refcheck._fp32_exact():
            pool = prompts(cfg, seed, dev)
            picked = pool[torch.tensor([int(sched.query[i]) for i, _ in sample],
                                       device=dev)]
            del pool
            tokens = torch.from_numpy(np.stack([r.tokens for _, r in sample]))
            logits = torch.from_numpy(np.stack([r.logits for _, r in sample]))
            weights = ref.Weights(cfg, weight_seed(seed), dev,
                                  served=DTYPES[cfg["precision"]],
                                  compute=torch.float32)
            nums.update(ref.compare(cfg, weights, picked, tokens.to(dev),
                                    logits.to(dev)))
        return {name: nums[name] for name in CHECKS}


def make_program(cfg: dict, cell: dict, seed: int, device, tracer):
    return LmGenerator(cfg, cell, seed, device, tracer)
