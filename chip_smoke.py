#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py [--n-docs N] [--seed S]

At the paper's service config (``repro_torch/configs/remoterag.py``, the
counterpart of ``repro/configs/remoterag.py``: 10^6 documents of dimension
768, k = 5, the k' = 160 planner knob, the default RLWE ring) it

  1. builds every CUDA kernel from ``src/repro_torch/csrc`` (one
     extension, ``torch.utils.cpp_extension.load``);
  2. builds the index and its dense NTT-domain candidate cache on the card;
  3. holds each kernel against its plain PyTorch version on the card at the
     path's shapes (integer kernels bit-identical on every prime; score-top-k
     values within 1e-5 relative and ids equal up to scores tied within that
     tolerance), checks the staged re-rank kernel followed by the inverse
     NTT against the fused-iNTT kernel (the staged witness), and times
     kernel (in bursts of back-to-back calls), plain version and, where one
     exists, the PyTorch library call computing the same function; the NTT
     also at one polynomial, the batch's 8 and one request's 41 rows, the
     pointwise product at 1, 41 and 328 rows with b full and with b one
     row broadcast, the key product (every prime in one launch) at one
     encryption, one request's decryption and the batch's, each beside the
     three standalone kernels chained (bit for bit and timed), the fused
     re-rank at one request,
     score-top-k at one query, at the privacy-ignorant baseline's top 5,
     and over the row counts of a router slice, an IVF cluster and the
     ingested tail (``at_shapes``); the fused re-rank reads gathered rows
     in place, as the serving path hands them over;
  4. serves 8 requests of 4 tenants one at a time through ``run_remoterag``
     and again as one batch (perturb_batch -> topk_batch ->
     encrypted_scores_cached_batch -> decrypt_scores_batch ->
     finish_request), and checks recall@5 = 1.0 against the plaintext
     top-5, decrypted scores against plaintext inner products (2e-3), and
     batched lanes against the one-at-a-time path (ids, docs, wire bytes);
     then splits ``topk_batch``'s wall time (query H2D, kernel, merge, a
     warm repeat) with calls made after the path;
  5. re-views the dense cache as a 16-shard sharded cache (one host-pool
     copy) and checks sharded scores bit-identical to the dense cache's in
     three regimes: stream-only, two pinned shards, async admission;
  6. serves 16 requests of 4 tenants through ``ServeEngine`` three times
     (dense batched, dense sequential, sharded batched with a 4-shard
     device budget) and checks equal ids, documents and wire bytes across
     the runs and recall@5 = 1.0;
  7. serves the same 16 requests through ``ReplicaRouter`` (4 replicas,
     max_batch 8, scatter-gather over 250,000-row slices) on the same index
     and dense cache, and checks every request equal to the dense batched
     engine run (ids, documents, wire bytes, request ids);
  8. the Paillier backend on the same index (512-bit keys, 46 residue
     channels; the phase's line): one batch of 8 lanes through the
     vectorized encrypt, score and decrypt on the card, each stage timed,
     profiled and held bit for bit against the object path under shared
     seeds on its first 4 lanes (decrypted scores within 2e-3 of the
     plaintext inner products); 16 requests of 4 tenants through a
     ``ServeEngine`` (max_batch 8), the first 4 again one at a time,
     equal per request, recall@5 against the
     plaintext top-5, ciphertext bytes equal to the accounting model's at
     each key's own size; one request through ``run_remoterag``; one batch mixing a
     1024-bit tenant (90 channels, the object path) with 512-bit ones, its
     lane counters printed and the object lane equal to a solo run; the
     baselines (privacy-ignorant over the 10^6 rows, privacy-conscious
     RLWE and Paillier over the first 512 rows, OT over those 512 timed
     once, walls extrapolated linearly to 10^6); and the bignum ops (not
     Pallas) timed at the phase's shapes beside their byte bound;
  9. frees that state and builds a clustered corpus of 10^6 x 768 (64
     natural clusters) with IVF (16 clusters aligned to 62,500-doc cache
     shards, so clusters and shards coincide) and the sharded cache only,
     then checks (a) 16 aligned ranges, (b) ``cluster_topk`` with every
     cluster equal to the flat scan bit for bit and the flat scan against
     its plain version, (c) 16 requests through an engine at the planned
     nprobe (not exact; first-stage ids equal the plain version's routed
     scan up to ties; recall@5 and rows scanned printed, not gated), (d) a
     50,000-doc ingest on a thread while an engine pinned at epoch 0
     replays its 16 requests bit for bit, the tail shard equal to the plain
     pack, (e) after ``refresh_corpus`` and ``router.replan()``, 8 queries
     near tail docs served with recall@5 = 1.0 and the 4-replica router
     equal to the single engine at epoch 1;
 10. frees that state and drives the service's text front end at full
     width (the ``text`` phase): 2^17 passages built as
     ``repro_torch/examples/private_rag_serve.py`` builds them (6 topics
     plus 12 random words), tokenized by ``HashTokenizer(32768)`` at 32
     tokens, embedded on the card in batches of 1024 by the encoder of
     ``encoder_config(dim=768)`` (4 layers, 6 heads x 128, d_ff 3072,
     seeded weights, float32 with TF32 off), indexed with its dense
     candidate cache; 16 text queries of 4 tenants (radius 0.05, the
     planned k') through a ``ServeEngine`` (max_batch 8), batched and
     sequential, must agree bit for bit (ids, documents, wire bytes) and
     serve the plaintext top-5 over the port's embeddings up to rows
     within 2^-12 of the 5th score (the RLWE fixed point may swap those);
     whether the true top-5 lay inside each request's k' candidates
     (Theorem 1 assumes a uniform corpus), recall@5, the 5th/6th gaps and
     the embed, tokenise and cache-build seconds are printed, not gated;
     score-top-k is timed at (1 and 8, 2^17) with kk = k';
 11. the Fig. 4 inversion attacks (the ``attack`` phase): at the
     benchmark's full setting (``token_corpus`` 3000 x 768, vocab 1024,
     20 tokens, 15 paraphrases; 50 queries; radii 0 to 4) the exact-
     recovery, NN F1 and linear-decoder curves on the card and through
     the plain CPU path from a copy of the generator: NN decode ids equal
     up to rows within 1e-5, linear curves within 0.02, exact recovery 1.0
     at r = 0 and every curve non-increasing within 0.05; then the same
     attacks over 100,000 aux documents x 768 at vocab 4096 with 256
     queries on the card, walls printed; score-top-k is timed at the two
     decode shapes, (400, 3000) and (2048, 100,000) with kk = 1;
 12. the MoE LM path (the ``lm`` phase), Qwen3-30B-A3B
     (``repro_torch/configs/qwen3_moe_30b_a3b.py``) at every published
     width with tp = 1 (d_model 2048, 32 q / 4 kv heads x 128, qk-norm,
     128 experts, top-8, expert d_ff 768, vocabulary 151,936 padded to
     152,064): (a) 2 layers in float32, drawn from a seeded CPU generator
     and loaded on the card; 2 prompts x 64 tokens through ``prefill`` and
     4 ``decode_step``s on both, fed the CPU's greedy tokens; routing ids
     equal wherever a token's 8th/9th router-logit gap exceeds 1e-4, and
     logits within 1e-3 on the sequences with no token below that gap
     (the number excluded printed; all excluded fails); (b) 8 of the 48
     layers in bfloat16 (5.61 B parameters, drawn on the card), 8 prompts
     x 512 tokens through ``prefill`` twice (bit-identical logits), the
     share of (token, expert) pairs dropped to capacity, then 64 greedy
     decode steps: prefill wall and ms a decode step (median, p90, p99),
     tokens/s and the decode loop's device idle share, each time beside
     its bound;
 13. the training path (the ``train`` phase), Llama-3-8B
     (``repro_torch/configs/llama3_8b.py``) at every published width with
     tp = 1 (d_model 4096, 32 q / 8 kv heads x 128, d_ff 14336,
     vocabulary 128,256 padded to 128,512): (a) 2 layers in float32
     (TF32 off), drawn from a seeded CPU generator and loaded on the card;
     one 1 x 256 ``LmSyntheticTask`` batch through the loss and its
     gradients on both, then two AdamW ``apply``s of them: the loss within
     1e-5 relative, every gradient within 1e-4 and every master within
     1e-5 of the CPU's, normwise; (b) 4 of the 32 layers, bf16 parameters
     with an fp32 master, m and v, remat on, drawn on the card:
     ``make_lm_run`` over 8 x 4096 tokens a step in 8 microbatches, one
     warm-up, 5 timed and one profiled step: ms a step (median, max),
     tokens/s beside the step's FLOP bound, losses and grad norms (all
     finite), launches and idle share a step, the busiest kernels, the
     device peak; (c) ``examples/train_lm.py``'s config_100m for 90 steps
     of 8 x 256 with a checkpoint every 30, straight through and again
     through the example's drill (a failure at step 30, a restart), under
     deterministic algorithms: the resumed history and state equal the
     uninterrupted run's bit for bit and the last loss lies below the
     first;
 14. the multi-device paths (the ``mesh`` phase, `mesh_phase`): (a) a
     world of one ``nccl`` rank, mesh (1,): the 10^6 x 768 corpus built
     with ``FlatIndex.build(mesh=)``, whose ``distributed_topk`` of the
     batch's 8 perturbed queries (k' = 161) must equal step 4's flat scan
     bit for bit; (b) 4 ranks co-located on the card, started with the
     spawn method, ``gloo`` (collectives of CUDA tensors staged through
     host memory and counted), mesh (2, 2) ("data", "model"): the first
     stage over both axes (250,000 rows a rank) equal to (a) bit for bit;
     8 requests of 4 tenants through ``run_remoterag`` and again as one
     batch over a 2^17-doc mesh index (each rank draws its own
     perturbation; the first rank's is searched), equal to one process on
     the same corpus (ids, wire bytes, the batch's candidates and
     decrypted scores); the MoE layer of Qwen3-30B-A3B at its published
     width over 8 x 512 tokens (tokens over "data", 64 experts a rank over
     "model"), float32 within 1e-5 of the einsum layer in one process
     (relative to its largest output; aux within 1e-5 relative), then
     timed in bf16 beside the single-process layer; the walls of the
     first stage's all-gather and the combine's all-reduce; over the
     round's mesh index, 16 requests of 4 tenants through a
     ``ServeEngine`` drained and again stepped with a 2 ms deadline under
     clocks skewed rank by rank, through a 4-replica ``ReplicaRouter``,
     and through an engine over 16 cache shards with 4 pinned and
     row-sharded over the ranks: ids, wire bytes and decrypted scores
     equal to one process (the router: ids and wire bytes), every
     serving kernel launched on every rank, a rank's resident cache
     bytes at most 1/4 of the whole shards' plus a row; GPipe on
     Llama-3-8B at every published width over ("pod", "data"): 2 float32
     layers (one a stage) on 8 x 512 tokens in 4 microbatches, loss
     within 1e-5 and every gradient within 1e-4 normwise of the same
     model in one process on the card, then 4 bf16 layers timed (ms a
     step, bubble share, the ppermutes' walls, bytes and host copies,
     the all-reduces' host copies apart, device peaks); the config_100m re-sharding drill: a checkpoint
     saved on (2, 2) restored on (4,) and in one process, and a run that
     dies on (2, 2) resumed on (4,), bit for bit.  Every rank loads the
     parent's kernel build (its mtime unchanged);
 15. the GNN and recsys models (the ``arch`` phase, `arch_phase`): (a)
     graphcast at every published width (16 bf16 layers, d_hidden 512,
     227 vars, remat): 2 float32 layers card = CPU on a ~2,000-node
     fanout subgraph (loss 1e-5, gradients 1e-4 normwise), then AdamW
     steps on a 1024-seed fanout (15, 10) subgraph of a synthetic
     232,965-node host graph padded to ``minibatch_lg``'s bounds (ms a
     step beside its FLOP bound, idle share, device peak) and one step
     each at ``full_graph_sm`` and ``molecule``; (b) FM, DCN-v2, DIEN and
     two-tower at their published widths and vocabularies: card = CPU on
     a batch of 256, the forward at ``serve_p99`` and AdamW steps at
     ``train_batch`` (two-tower's cut, DIEN's in microbatches); (c) the
     full-width two-tower trained a few steps, score-top-k over 10^6
     item-tower rows of 256 against ``matmul`` + ``topk``, and
     ``examples/recsys_retrieval.py``'s round over the item corpus on the
     RLWE backend: recall@5 = 1.0, decrypted scores within 2e-3, every
     serving kernel launched, each kernel held against its plain version
     at the round's width-256 shapes; (d) every dry-run cell built on
     ``meta`` tensors with its bytes per rank against 80 GB (and the
     non-LM cells' matmul FLOPs).  Cuts: ``ARCH_CUTS``.

Each path (one-at-a-time, batch, each engine and router run, the text
pack and engines, each attack setting on the card, the LM's parity run,
prefill and decode, the training parity run, steps and drill, the mesh
phase's searches, round and MoE layer, on every rank, the GNN and recsys
runs and the two-tower round) runs with
the launch counts set to 0 just before it and read just after, and every
kernel of the path must have launched (the LM, training, mesh MoE, GNN
and recsys paths have none: their counts must stay 0); the RLWE serving paths must
launch no standalone inverse NTT or pointwise product (the key product
replaced them there; the privacy-conscious baseline's staged scoring
still launches both, so every kernel runs on some path); the kernels
line gives each
kernel's launches over the paths, by path and by shape, and launches x
(time - bound) per timed shape.  Every phase prints one JSON line with its
wall time and its device and host memory peaks; the last line is the
device summary.  Any failed check raises, so the script exits non-zero and
prints no result.  It needs a CUDA device and the repository's ``src/``
beside it.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import gc
import math
import os
import resource
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the train phase's fault drill runs under torch.use_deterministic_algorithms,
# whose cuBLAS calls need a fixed workspace set before cuBLAS starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM bytes/s, float32
# outside the tensor cores, and int32 operations (132 SMs x 64 INT32 lanes
# x 1.98 GHz, Hopper white paper).
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
INT32_OPS_S = 132 * 64 * 1.98e9

REQUESTS, TENANTS = 8, 4     # requests served per path, tenants (keys)
REPS, PLAIN_REPS = 20, 5     # timed samples per kernel / per plain version
BURST = 20                   # back-to-back kernel calls in one timed sample
# score-top-k kernel vs plain version (float32, two summation orders)
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
NUM_SHARDS, BUDGET_SHARDS = 16, 4   # sharded cache: shards, engine budget
ROUTER_REPLICAS = 4          # replicas of the router phases
# IVF + ingest phase: corpus rows, clusters (= cache shards of
# IVF_SHARD_DOCS docs), documents ingested
IVF_DOCS, IVF_CLUSTERS, IVF_SHARD_DOCS, INGEST_DOCS = 10**6, 16, 62_500, 50_000
# kernels of the serving path: encryption and decryption make one key
# product each, scoring forward-NTTs the query and runs the fused re-rank;
# the standalone inverse NTT and pointwise product (the staged scoring of
# fresh packing) and the staged re-rank (the witness) must not launch there
PATH_KERNELS = ("ntt_fwd", "key_mul", "fused_rerank_intt", "score_topk")
OFF_PATH_KERNELS = ("ntt_inv", "pointwise_mul", "fused_rerank")
# kernels of the Paillier serving path (the first stage) and of the RLWE
# privacy-conscious baseline (fresh packing: no fused re-rank)
PAILLIER_KERNELS = ("score_topk",)
CONSCIOUS_KERNELS = ("ntt_fwd", "ntt_inv", "pointwise_mul", "key_mul")
PAILLIER_BITS, FALLBACK_BITS = 512, 1024   # tenants' keys; the object tier
# Paillier depth, cut for the script's time: the object path holds the
# batch's first PAILLIER_OBJECT_LANES lanes (of 8), the sequential engine
# serves the first PAILLIER_SEQ_REQUESTS requests (of 8)
PAILLIER_OBJECT_LANES, PAILLIER_SEQ_REQUESTS = 4, 4
CONSCIOUS_ROWS = 512         # rows of the privacy-conscious baselines
# text phase: the service's text front end at full width (the embedder of
# encoder_config(dim=768): 4 layers, 6 heads x 128, d_ff 3072, vocab 32768)
# over 2^17 passages, cut from the config's 10^6 documents for the
# script's time
TEXT_DOCS, TEXT_SEQ, TEXT_QUERIES = 2**17, 32, 16
EMBED_BATCH = 1024           # passages embedded per call
TEXT_TIE = 2.0 ** -12        # plaintext gap the RLWE fixed point may swap
# attack phase: Fig. 4's full setting (benchmarks/fig4_privacy.py) and
# the aux corpus at scale
RADII = (0.0, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 4.0)
FIG4_DOCS, FIG4_QUERIES = 3000, 50
AUX_DOCS, AUX_VOCAB, AUX_QUERIES = 100_000, 4096, 256
ATTACK_KERNELS = ("score_topk",)
# lm phase: the MoE LM at every published width with tp = 1, as the
# reference's serving cells run it (repro_torch/configs/qwen3_moe_30b_a3b.py)
LM_ARCH = "qwen3-moe-30b-a3b"
# (a) parity anchor: 2 layers, float32 (TF32 off), card against the CPU
LM_PARITY_LAYERS, LM_PARITY_PROMPTS, LM_PARITY_LEN, LM_PARITY_STEPS = \
    2, 2, 64, 4
LM_GAP = 1e-4       # k-th/(k+1)-th router-logit gap below which ids may swap
LM_ATOL = 1e-3      # logits, card against CPU, float32
# (b) the serving run: 8 of the 48 layers in bfloat16, every expert and
# the whole vocabulary; 8 prompts x 512 tokens, 64 greedy decode steps
LM_LAYERS, LM_PROMPTS, LM_PROMPT_LEN, LM_MAX_LEN, LM_STEPS = \
    8, 8, 512, 1024, 64
BF16_OPS_S = 989e12   # H100 SXM dense bf16 tensor-core peak (data sheet)
LM_KERNELS = ()       # the LM paths (serving, training) launch none of ours
# train phase: Llama-3-8B at every published width with tp = 1, as the
# reference's single-axis FSDP training variants set it
# (src/repro/configs/families.py), depth cut
TRAIN_ARCH = "llama3-8b"
# (a) parity anchor: 2 layers, float32 (TF32 off), one 1 x 256 batch
TRAIN_PARITY_LAYERS, TRAIN_PARITY_SEQ, TRAIN_PARITY_APPLY = 2, 256, 2
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_MASTER_RTOL = 1e-5, 1e-4, 1e-5
# (b) the training run: 4 layers, bf16 params (fp32 master, m, v), remat;
# a global batch of 8 x 4096 tokens (train_4k's length) in 8 microbatches
# of one sequence (the reference's default); 1 warm-up + 5 timed steps
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = \
    4, 8, 4096, 8, 5
# (c) the fault drill: examples/train_lm.py's config_100m, a checkpoint
# every 30 steps, a failure injected at step 30, a restart
DRILL_STEPS, DRILL_EVERY, DRILL_FAIL, DRILL_BATCH, DRILL_SEQ = \
    90, 30, 30, 8, 256
# mesh phase: (a) one nccl rank; (b) MESH_WORLD ranks co-located on the one
# card (gloo), mesh MESH_SHAPE; the round's corpus is cut from 10^6 to
# 2^17 docs (every rank builds the whole dense cache, as the reference's
# mesh index does, and four 10^6-doc caches of 49 GB cannot share a card);
# the MoE layer at LM_ARCH's width over MESH_MOE_BATCH x MESH_MOE_SEQ tokens
MESH_WORLD, MESH_SHAPE, MESH_AXES = 4, (2, 2), ("data", "model")
MESH_ROUND_DOCS = 2**17
MESH_MOE_BATCH, MESH_MOE_SEQ, MESH_MOE_REPS = 8, 512, 10
# (b) over the round's mesh index: the engine (MESH_REQUESTS requests of
# TENANTS tenants, drained, then stepped under clocks skewed rank by rank
# with deadline MESH_WAIT_S), the router (ROUTER_REPLICAS replicas) and the
# sharded cache of NUM_SHARDS shards with MESH_PIN_SHARDS pinned, each
# row-sharded over the ranks
MESH_REQUESTS, MESH_WAIT_S, MESH_PIN_SHARDS = 16, 0.002, 4
# GPipe on TRAIN_ARCH at every published width over MESH_SHAPE ("pod",
# "data"), depth and tokens cut (four ranks share the card): parity in
# float32 at GPIPE_PARITY_LAYERS layers, timed in bf16 at GPIPE_LAYERS
# (GPIPE_STEPS timed steps after GPIPE_WARMUP untimed ones); GPIPE_BATCH x
# GPIPE_SEQ tokens in GPIPE_MICRO microbatches; the training tolerances of
# PERF.md section 2
GPIPE_AXES = ("pod", "data")
GPIPE_PARITY_LAYERS, GPIPE_LAYERS, GPIPE_STEPS, GPIPE_WARMUP = 2, 4, 3, 2
GPIPE_BATCH, GPIPE_SEQ, GPIPE_MICRO = 8, 512, 4
# the re-sharding drill at config_100m: RESHARD_STEPS steps of
# DRILL_BATCH x RESHARD_SEQ, a checkpoint every RESHARD_EVERY, a failure
# at RESHARD_FAIL on MESH_SHAPE, resumed on (MESH_WORLD,) ("data",)
RESHARD_STEPS, RESHARD_EVERY, RESHARD_FAIL, RESHARD_SEQ = 4, 2, 2, 128


# arch phase: the GNN and recsys models at their published widths
# (repro_torch/configs/{graphcast,fm,dcn_v2,dien,two_tower_retrieval}.py).
# (a) graphcast on a synthetic host graph of Reddit's 232,965 nodes with
# GNN_IN_DEG in-edges each (cut from Reddit's ~492: only the sampled
# subgraph reaches the card); minibatch_lg's 1024 seeds, fanout (15, 10),
# padded to the shape's static bounds, GNN_STEPS timed steps; parity at
# GNN_PARITY_LAYERS float32 layers on GNN_PARITY_SEEDS seeds' fanout
GNN_NODES, GNN_IN_DEG, GNN_SEEDS, GNN_STEPS = 232_965, 50, 1024, 3
GNN_PARITY_LAYERS, GNN_PARITY_SEEDS = 2, 12
# (b) recsys at serve_p99 and train_batch; two-tower's in-batch logits
# (B^2 float32, with their softmax and gradients ~5 such tensors: 86 GB at
# 65,536) cut its batch; DIEN's 2 x 100 GRU steps keep their activations,
# so its 65,536 run in DIEN_MICRO microbatches (the same global batch)
REC_ARCHS = ("fm", "dcn-v2", "dien", "two-tower-retrieval")
REC_SERVE, REC_TRAIN, TWOTOWER_TRAIN, DIEN_MICRO = 512, 65_536, 32_768, 4
REC_PARITY_BATCH = 256
# (c) the private two-tower round: RETRIEVAL_STEPS training steps of
# RETRIEVAL_BATCH co-click pairs; the first stage at retrieval_cand's 10^6
# candidates; the round over RETRIEVAL_ITEMS items (uncut: its dense
# cache, 49 GB, fits beside the rest of the phase)
RETRIEVAL_STEPS, RETRIEVAL_BATCH = 10, 1024
RETRIEVAL_CANDS, RETRIEVAL_ITEMS = 10**6, 10**6
ARCH_CUTS = [
    "graphcast: host graph in-degree 50 (Reddit ~492); only the sampled "
    "subgraph (padded to minibatch_lg) reaches the card",
    "graphcast: ogb_products in the dry run only (one bf16 edge tensor "
    "63 GB)",
    "graphcast parity: 2 of 16 layers in float32 on ~2,000 nodes",
    "two-tower train_batch 65,536 -> 32,768 (in-batch logits)",
    "dien train_batch 65,536 in 4 microbatches of 16,384",
    "recsys parity: batch 256",
    "two-tower round: 10 training steps of 1,024 pairs; synthetic items",
]


def paper():
    """The paper's service config, ``repro_torch/configs/remoterag.py``
    (N_DOCS, DIM, K, KPRIME, RLWE)."""
    from repro_torch.configs import remoterag
    return remoterag


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, ops_rate: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / ops_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


_spin_cycles_per_ms: list = []


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    if not _spin_cycles_per_ms:
        cycles = 10**7
        torch.cuda._sleep(cycles)           # warm-up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        _spin_cycles_per_ms.append(cycles / a.elapsed_time(b))
    return _spin_cycles_per_ms[0]


def time_ms(torch, fn, reps: int, burst: int = 1) -> float:
    """Median device time of one call of ``fn`` over ``reps`` samples.

    A sample is ``burst`` calls back to back between two CUDA events
    enqueued behind a spin kernel longer than the host takes to enqueue
    them, divided by ``burst``: the device runs the launches back to back,
    no host launch gap lies inside the interval, and the events' own
    overhead (~4 us a pair on the H100) is shared by ``burst`` calls.  A
    sample counts only if the device was still spinning when the host had
    enqueued it (its first event not yet reached); one that missed is
    timed again behind a longer spin, and five misses raise, so the result
    is device time or nothing."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(burst):
        fn()
    torch.cuda.synchronize()
    spin_ms = 2 * (time.perf_counter() - t0) * 1e3 + 1
    times, misses = [], 0
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms(torch)))
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        queued = not a.query()
        b.synchronize()
        if queued:
            times.append(a.elapsed_time(b) / burst)
            continue
        misses += 1
        check(misses < 5, "the device reached a timed call before the host "
              "had enqueued it, five times")
        spin_ms *= 4
    return statistics.median(times)


def call_ms(torch, fn, reps: int) -> float:
    """Median time of one call between CUDA events recorded around it:
    device time plus the host's launch gap, what a caller waits."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timed_row(torch, err, kern, plain, nbytes, ops, rate, library=None,
              plain_call=False, **extra) -> dict:
    """One timed row: ``kern``/``plain``/``library`` are zero-argument
    callables; the kernel is timed in bursts of BURST back-to-back calls
    (`time_ms`), the plain version and the library call one call at a time.
    ``plain_call``: the plain version enqueues more launches than the
    device's queue holds behind `time_ms`'s spin, so it is timed between
    events around one call (`call_ms`: device time plus host gaps)."""
    b_ms, b_by = bound(nbytes, ops, rate)
    lib_ms = (time_ms(torch, library, PLAIN_REPS)
              if library is not None else None)
    plain_ms = (call_ms(torch, plain, PLAIN_REPS) if plain_call
                else time_ms(torch, plain, PLAIN_REPS))
    return dict(max_abs_err=err, ms=time_ms(torch, kern, REPS, BURST),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, call_ms=call_ms(torch, kern, REPS),
                **(dict(plain_timer="call") if plain_call else {}), **extra)


def int_err(got, want) -> int:
    """max |got - want| over a kernel's integer outputs (tensor or tuple)."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return max(int((g.long() - w.long()).abs().max()) for g, w in pairs)


def kernel_phase(torch, np, args, index, params, plan, queries) -> list:
    """Each kernel against its plain version at the main path's shapes; the
    inputs each kernel is timed on are the ones its error is read from.
    Kernels are timed in bursts of BURST back-to-back calls (`time_ms`),
    plain versions and library calls one call at a time."""
    from repro_torch.crypto import modring
    from repro_torch.kernels.ntt import fused as kfused
    from repro_torch.kernels.ntt import ntt as kntt
    from repro_torch.kernels.ntt import ref as nref

    dev = torch.device("cuda")
    gen = np.random.default_rng(args.seed + 7)
    bsz = len(queries)
    n = params.n_poly
    chunks = params.num_chunks(index.dim)
    cpt = params.cands_per_ct(index.dim)
    num_ct = -(-plan.kprime // cpt)
    rows = cpt * chunks
    ctx = params.ctxs[0]
    logn = int(math.log2(n))
    out = []

    def residues(shape, q):
        return torch.from_numpy(gen.integers(0, q, size=shape).astype(
            np.int32)).to(dev)

    def measure(*a, **kw) -> dict:
        return timed_row(torch, *a, **kw)

    def entry(name, source, replaces, measured, *others):
        """One kernel's line: ``measured`` at its main-path shape, then the
        same measurement at the path's other shapes (``at_shapes``)."""
        out.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, launches=0, **measured,
                        **(dict(at_shapes=list(others)) if others else {})))

    def compare(name, kern, plain):
        """Run kernel and plain version once; both must agree bit for bit."""
        err = int_err(kern(), plain())
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        return err

    # NTT forward / inverse at the batched decryption shape (B*num_ct rows),
    # the largest per-request batch, and timed also at one request's
    # decryption (num_ct rows), at the batch's query rows (B, the forward
    # NTT's scoring launches) and at one polynomial (encryption, scoring:
    # most launches); every prime is checked
    batch_rows = bsz * num_ct
    for inverse, name, rep in ((False, "ntt_fwd",
                                "src/repro/kernels/ntt/ntt.py:94"),
                               (True, "ntt_inv",
                                "src/repro/kernels/ntt/ntt.py:94")):
        ref_fn = nref.ntt_inv_ref if inverse else nref.ntt_fwd_ref
        for c in params.ctxs[1:]:
            for shape in ((batch_rows, n), (1, n), (num_ct, n), (4096, n)):
                x = residues(shape, c.q)
                compare(name, lambda: kntt.ntt_cuda(x, c, inverse=inverse),
                        lambda: ref_fn(x, c))
        timed = []
        for polys_n in (1, bsz, num_ct, batch_rows):
            x = residues((polys_n, n), ctx.q)
            err = compare(name, lambda: kntt.ntt_cuda(x, ctx,
                                                      inverse=inverse),
                          lambda: ref_fn(x, ctx))
            # the polynomials in and out and one twiddle table; 3 modular
            # ops a butterfly, and the inverse's N^-1 scaling
            timed.append(measure(
                err, lambda: kntt.ntt_cuda(x, ctx, inverse=inverse),
                lambda: ref_fn(x, ctx), 2 * polys_n * n * 4 + n * 4,
                polys_n * (n // 2) * logn * 3 + (polys_n * n if inverse
                                                 else 0),
                INT32_OPS_S, shape=[polys_n, n]))
        entry(name, "src/repro_torch/csrc/ntt.cu", rep, timed[-1], *timed[:-1])

    # pointwise product at the batched decryption shape, at one request's
    # (num_ct rows) and at one polynomial, with b full and with b one row
    # broadcast over a (expanded, read in place: the shape of a key or a
    # query row over a batch); every prime checked.  Bound: the bytes read
    # (b's rows once) and written
    timed = []
    for polys_n in (1, num_ct, batch_rows):
        for kind in ("full", "row"):
            def operands(c):
                b_rows = polys_n if kind == "full" else 1
                return (residues((polys_n, n), c.q),
                        residues((b_rows, n), c.q).expand(polys_n, n))
            for c in params.ctxs[1:]:
                aa, bb = operands(c)
                compare("pointwise_mul",
                        lambda: kntt.pointwise_mul_cuda(aa, bb, c),
                        lambda: nref.pointwise_mul_ref(aa, bb, c))
            a, b = operands(ctx)
            err = compare("pointwise_mul",
                          lambda: kntt.pointwise_mul_cuda(a, b, ctx),
                          lambda: nref.pointwise_mul_ref(a, b, ctx))
            b_rows = polys_n if kind == "full" else 1
            timed.append(measure(
                err, lambda: kntt.pointwise_mul_cuda(a, b, ctx),
                lambda: nref.pointwise_mul_ref(a, b, ctx),
                4 * (2 * polys_n + b_rows) * n, polys_n * n, INT32_OPS_S,
                shape=[polys_n, n], b=kind))
    entry("pointwise_mul", "src/repro_torch/csrc/ntt.cu",
          "src/repro/kernels/ntt/ntt.py:120", timed[-1], *timed[:-1])

    # the key product iNTT(NTT(a) * s) over every prime in one launch: one
    # encryption (1, P, N), one request's decryption (num_ct, P, N) under
    # one key, and the batch's (B, num_ct, P, N) under per-lane keys,
    # recorded as (rows, P, N); every prime held bit for bit to the plain
    # version and to the three standalone kernels chained prime by prime
    # (the path before the key product), which is timed beside it
    nprimes = params.num_primes
    timed = []
    for lead, keys in (((1,), 1), ((num_ct,), 1), ((bsz, num_ct), bsz)):
        a = torch.stack([residues(lead + (n,), c.q) for c in params.ctxs],
                        dim=-2)
        key_lead = (keys,) + (1,) * (len(lead) - 1) if keys > 1 else ()
        s_hat = torch.stack([residues(key_lead + (n,), c.q)
                             for c in params.ctxs], dim=-2)
        krows = math.prod(lead)
        a3 = a.reshape(krows, nprimes, n)
        s3 = s_hat.reshape(-1, nprimes, n)
        slices = [(a3[:, i].contiguous(),
                   s3[:, i].repeat_interleave(krows // keys, dim=0)
                   if keys > 1 else s3[0, i].expand(krows, n), c)
                  for i, c in enumerate(params.ctxs)]

        def kern(a3=a3, s3=s3):
            return kntt.key_mul_cuda(a3, s3, params.ctxs)

        def chain(slices=slices):
            return [kntt.ntt_cuda(kntt.pointwise_mul_cuda(
                kntt.ntt_cuda(x, c), k, c), c, inverse=True)
                for x, k, c in slices]

        def plain(a3=a3, s3=s3, keys=keys, krows=krows):
            return nref.key_mul_ref(
                a3.view(keys, krows // keys, nprimes, n), s3[:, None],
                params.ctxs).view(krows, nprimes, n)

        err = compare("key_mul", kern, plain)
        chain_err = int_err(kern(), torch.stack(chain(), dim=1))
        check(chain_err == 0, f"key_mul differs from the chained standalone "
                              f"kernels by {chain_err}")
        # the polynomials in and out, the keys and the forward and inverse
        # twiddle tables; two networks (3 ops a butterfly), the product and
        # the inverse's N^-1 scaling.  The plain version's ~600 launches a
        # call are timed by `call_ms`
        polys = krows * nprimes
        timed.append(measure(
            err, kern, plain,
            4 * (2 * polys * n + keys * nprimes * n + 2 * nprimes * n),
            polys * (2 * (n // 2) * logn * 3 + 2 * n), INT32_OPS_S,
            plain_call=True, shape=[krows, nprimes, n], keys=keys,
            chain_ms=time_ms(torch, chain, REPS, BURST),
            chain_max_abs_err=chain_err))
    entry("key_mul", "src/repro_torch/csrc/ntt.cu",
          "src/repro/kernels/ntt/ntt.py:120", timed[-1], *timed[:-1])
    out[-1]["fuses"] = ["src/repro/kernels/ntt/ntt.py:94 (forward)",
                        "src/repro/kernels/ntt/ntt.py:120",
                        "src/repro/kernels/ntt/ntt.py:94 (inverse)"]

    # fused rotate / Hadamard / accumulate / inverse NTT reading the
    # gathered rows (B, k', chunks, P, N) in place, as the path calls it,
    # for the batch and for one request: every prime checked bit for bit,
    # the timed calls cycling through the primes as the path does (the
    # batch's rows, 63 MB, then exceed the L2)
    kprime = plan.kprime
    timed, witness_inputs = [], None
    for b in (1, bsz):
        g = torch.empty((b, kprime, chunks, nprimes, n), dtype=torch.int32,
                        device=dev)
        ins = []
        for i, c in enumerate(params.ctxs):
            g[..., i, :] = residues((b, kprime, chunks, n), c.q)
            tw = residues((cpt, n), c.q)
            ins.append((tw, modring.shoup_quotients(tw, c.q),
                        residues((b, chunks, n), c.q),
                        residues((b, chunks, n), c.q)))
        cycle = itertools.cycle(range(nprimes))

        def kern(i=None, g=g, ins=ins, cycle=cycle):
            i = next(cycle) if i is None else i
            return kfused.fused_rerank_intt_gathered_cuda(
                g, i, kprime, *ins[i], params.ctxs[i])

        def plain(i=0, g=g, ins=ins):
            tw, _, f0, f1 = ins[i]
            return nref.fused_rotate_hadamard_intt_gathered_ref(
                g, i, kprime, tw, f0, f1, params.ctxs[i])

        err = max(compare("fused_rerank_intt", lambda: kern(i),
                          lambda: plain(i)) for i in range(nprimes))
        # the function's inputs (the reference's fused_rerank_intt_pallas
        # reads polys, tw, f0, f1 and ipsi) and its two outputs
        cells = b * num_ct
        nbytes = 4 * (b * kprime * chunks * n + cpt * n
                      + 2 * b * chunks * n + n + 2 * cells * n)
        ops = cells * n * (rows * 5 + 2) + 2 * cells * ((n // 2) * logn * 3
                                                        + n)
        timed.append(measure(
            err, kern, plain, nbytes, ops, INT32_OPS_S,
            shape=[b, num_ct, rows, n]))
        witness_inputs = (g, ins, kern)
    entry("fused_rerank_intt", "src/repro_torch/csrc/fused.cu",
          "src/repro/kernels/ntt/fused.py:132", timed[-1], *timed[:-1])

    # staged re-rank (NTT-domain accumulators out) on the batch's padded
    # rows: bit identical to its plain version, and staged + standalone
    # inverse NTT bit identical to the fused-iNTT kernel (the staged
    # witness), on every prime
    g, ins, kern = witness_inputs
    witness = 0
    for i, c in enumerate(params.ctxs):
        polys = nref.gathered_polys(g, i, kprime, cpt)
        tw, tws, f0, f1 = ins[i]
        err = compare("fused_rerank",
                      lambda: kfused.fused_rerank_cuda(polys, tw, tws, f0,
                                                       f1, c),
                      lambda: nref.fused_rotate_hadamard_ref(polys, tw, f0,
                                                             f1, c))
        staged = kfused.fused_rerank_cuda(polys, tw, tws, f0, f1, c)
        witness = max(witness, int_err(
            tuple(kntt.ntt_cuda(a.reshape(-1, n), c, inverse=True)
                  .reshape(a.shape) for a in staged), kern(i)))
        check(witness == 0, f"staged + inverse NTT differs from the fused "
              f"kernel by {witness}")
    polys = nref.gathered_polys(g, 0, kprime, cpt)
    tw, tws, f0, f1 = ins[0]
    cells = bsz * num_ct
    nbytes = 4 * (polys.numel() + tw.numel() + f0.numel() + f1.numel()
                  + 2 * cells * n)
    entry("fused_rerank", "src/repro_torch/csrc/fused.cu",
          "src/repro/kernels/ntt/fused.py:99", measure(
              err, lambda: kfused.fused_rerank_cuda(polys, tw, tws, f0, f1,
                                                    ctx),
              lambda: nref.fused_rotate_hadamard_ref(polys, tw, f0, f1, ctx),
              nbytes, cells * n * (rows * 5 + 2), INT32_OPS_S,
              shape=[bsz, num_ct, rows, n],
              staged_witness_max_abs_err=witness, on_serving_path=False))

    # score + per-tile top-k over the whole corpus with the batch's queries,
    # and with one query (one request at a time and the sequential engine:
    # most launches); over the row counts of a router slice (250,000), an
    # IVF cluster / cache shard (62,500) and the ingested tail (50,000),
    # the same work as those scans whatever rows they hold; and the
    # privacy-ignorant baseline's scan (one query, top k = 5 per tile)
    full_rows = index.num_rows
    timed = []
    for b, sub, k_sel in ((1, IVF_SHARD_DOCS, plan.kprime),
                          (bsz, IVF_SHARD_DOCS, plan.kprime),
                          (1, INGEST_DOCS, plan.kprime),
                          (bsz, INGEST_DOCS, plan.kprime),
                          (bsz, full_rows // ROUTER_REPLICAS, plan.kprime),
                          (1, full_rows, plan.k), (1, full_rows, plan.kprime),
                          (bsz, full_rows, plan.kprime)):
        q = torch.from_numpy(np.asarray(queries[:b], np.float32)).to(dev)
        timed.append(score_topk_row(torch, q,
                                    index.embeddings[:min(sub, full_rows)],
                                    k_sel))
    entry("score_topk", "src/repro_torch/csrc/scoretopk.cu",
          "src/repro/kernels/scoretopk/scoretopk.py:61", timed[-1],
          *timed[:-1])
    return out


def score_topk_row(torch, q, emb, k_sel: int) -> dict:
    """Score + per-tile top-k of queries ``q`` over rows ``emb`` (tile 2048,
    kk = min(k_sel, tile), as the first stage launches it): the kernel held
    to its plain version (values within SCORE_RTOL of the value plus
    SCORE_ATOL; ids equal up to score ties), then timed beside its bound,
    the plain version and ``matmul`` + ``topk``.  A plain version of more
    than 100 row blocks is timed by `call_ms` (see `timed_row`)."""
    from repro_torch.kernels.scoretopk import ref as sref
    from repro_torch.kernels.scoretopk import scoretopk as kscore

    b = q.shape[0]
    n_rows, dim = emb.shape
    tile, kk = min(2048, n_rows), min(k_sel, 2048, n_rows)
    num_tiles = -(-n_rows // tile)
    pad = num_tiles * tile - n_rows
    kv, ki = kscore.score_topk_cuda(q, emb, kk=kk, tile=tile)
    pv, pi = sref.tile_topk_ref(q, emb, kk, tile)
    fin = torch.isfinite(pv)
    check(torch.equal(fin, torch.isfinite(kv)), "score_topk -inf pattern")
    # float32 sums of `dim` products in two orders: within SCORE_RTOL of
    # the value plus SCORE_ATOL (a tile shorter than kk, as a router
    # slice's last one, lists scores near 0, where only an absolute bound
    # means anything; the `cuda` tests' tolerance)
    err = (kv[fin] - pv[fin]).abs()
    check(bool((err <= SCORE_RTOL * pv[fin].abs() + SCORE_ATOL).all()),
          f"score_topk values off by {float(err.max())} at "
          f"{[b, n_rows, dim, kk]}")
    mism = (ki != pi) & fin
    if bool(mism.any()):
        # a swapped id must score, under the plain version, within the
        # tolerance of the plain value at that position (a tie)
        t_idx, b_idx, _ = torch.nonzero(mism, as_tuple=True)
        got_ids = ki[mism].long()
        rescored = (q[b_idx].double() * emb[got_ids].double()).sum(-1)
        ok = ((rescored - pv[mism].double()).abs()
              <= SCORE_RTOL * pv[mism].abs() + SCORE_ATOL)
        check(bool(ok.all()), f"score_topk ids differ beyond score ties "
                              f"at {[b, n_rows, dim, kk]}")

    def library():
        s = torch.nn.functional.pad(torch.matmul(q, emb.T), (0, pad),
                                    value=-torch.inf)
        return torch.topk(s.view(b, num_tiles, tile), kk, dim=-1)

    # the function's work, whatever computes it: each corpus and query
    # byte read once, the lists written once; 2*B*N*n flops and one
    # compare per score
    nbytes = 4 * (n_rows * dim + b * dim + 2 * num_tiles * b * kk)
    ops = 2 * b * n_rows * dim + b * n_rows
    blocks = -(-n_rows // max(1, sref._BLOCK_ELEMS // (b * dim)))
    return timed_row(
        torch, float(err.max()),
        lambda: kscore.score_topk_cuda(q, emb, kk=kk, tile=tile),
        lambda: sref.tile_topk_ref(q, emb, kk, tile),
        nbytes, ops, FP32_OPS_S, library=library, plain_call=blocks > 100,
        id_mismatches=int(mism.sum()), shape=[b, n_rows, dim, kk])


def device_busy(torch, prof) -> tuple:
    """({activity name: device ms}, total device ms) from a CUDA-only
    profile; an empty trace gives ({}, None) — the busy and idle numbers
    are then unmeasured (null), never read as an idle device."""
    busy = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = e.name[:60]
            busy[key] = busy.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return busy, (sum(busy.values()) if busy else None)


def serve_phase(torch, np, args, index, cloud, params, plan,
                queries) -> dict:
    from repro_torch.core import protocol
    from repro_torch.kernels import ext
    from repro_torch.serve import batching

    def users():
        return [protocol.RemoteRagUser(
            n=index.dim, N=index.num_rows, k=plan.k, plan=plan,
            rlwe_params=params, rng=np.random.default_rng(args.seed + 100 + t))
            for t in range(TENANTS)]

    def gens():
        return [torch.Generator(device="cuda").manual_seed(args.seed * 1000 + j)
                for j in range(len(queries))]

    nq = len(queries)
    # -- one request at a time through run_remoterag --------------------
    seq_users = users()
    torch.cuda.synchronize()
    ext.reset_launches()
    seq, seq_ms = [], []
    for j, g in enumerate(gens()):
        t0 = time.perf_counter()
        seq.append(protocol.run_remoterag(seq_users[j % TENANTS], cloud,
                                          queries[j], g))
        seq_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    seq_launches = ext.launch_counts()
    seq_shapes = shape_counts(ext.launch_shapes())

    # -- the same requests as one batch ----------------------------------
    b_users = users()
    lane_users = [b_users[j % TENANTS] for j in range(nq)]
    stages = {}
    torch.cuda.synchronize()
    ext.reset_launches()

    def stage(name, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return r

    # the batch runs under torch.profiler (CUDA activity only) to split its
    # wall time into device-busy time per kernel and idle time
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    t_batch = time.perf_counter()
    pert = stage("perturb_batch", lambda: batching.perturb_batch(
        gens(), queries, [plan.eps] * nq))
    res = stage("topk_batch", lambda: batching.topk_batch(
        index, pert, plan.kprime))
    enc = stage("encrypt", lambda: [u.encrypt_query(e)
                                    for u, e in zip(lane_users, queries)])
    sc = stage("encrypted_scores_cached_batch",
               lambda: batching.encrypted_scores_cached_batch(
                   params, enc, cloud.candidate_cache, res.indices))
    scores = stage("decrypt_scores_batch", lambda: batching.decrypt_scores_batch(
        [u.sk for u in lane_users], sc))
    cand = res.indices.cpu().numpy()

    def finish():
        outs = []
        for j, u in enumerate(lane_users):
            req = protocol.Request(perturbed=pert[j], kprime=plan.kprime,
                                   enc_query=enc[j], backend="rlwe")
            reply = protocol.Reply(candidate_ids=cand[j],
                                   enc_scores=sc.lane(j))
            outs.append(protocol.finish_request(
                u, cloud, req, reply,
                u.positions_from_scores(scores[j], plan.kprime)))
        return outs

    batch = stage("finish_request", finish)
    batch_wall_ms = (time.perf_counter() - t_batch) * 1e3
    prof.__exit__(None, None, None)
    batch_launches = ext.launch_counts()
    batch_shapes = shape_counts(ext.launch_shapes())
    busy, busy_ms = device_busy(torch, prof)
    topk_split = topk_batch_split(torch, index, pert, plan.kprime)
    topk_split["first_ms"] = stages["topk_batch"]

    # -- checks -------------------------------------------------------
    q = torch.from_numpy(np.asarray(queries, np.float32)).cuda()
    plain = torch.matmul(q, index.embeddings.T)           # TF32 is off
    top, order = torch.sort(-plain, dim=1, stable=True)
    want = order[:, :plan.k].cpu().numpy()
    # plaintext gap between the k-th and (k+1)-th best rows: a gap below
    # the scheme's 2^-13 fixed-point error can swap them (in the JAX
    # reference too, whose ciphertexts are bit-identical)
    gaps = (top[:, plan.k] - top[:, plan.k - 1]).cpu().tolist()
    recalls, max_err = [], 0.0
    for j in range(nq):
        docs_s, ids_s, tr_s = seq[j]
        docs_b, ids_b, tr_b = batch[j]
        check(np.array_equal(ids_s, ids_b) and docs_s == docs_b
              and tr_s.total_bytes == tr_b.total_bytes,
              f"request {j}: batched lane differs from one-at-a-time path")
        check(docs_s == [f"passage-{int(i)}".encode() for i in ids_s],
              f"request {j}: documents do not match ids")
        recalls.append(len(set(ids_s.tolist()) & set(want[j].tolist()))
                       / plan.k)
        truth = (index.rows(cand[j]).double() @ q[j].double()).cpu().numpy()
        max_err = max(max_err, float(np.abs(scores[j] - truth).max()))
    check(all(r == 1.0 for r in recalls),
          f"recall@{plan.k} {recalls}; k-th/(k+1)-th plaintext gaps {gaps}")
    check(max_err <= 2e-3, f"decrypted scores off by {max_err}")
    shared = dict(cand=cand, enc=enc, want=want, gaps=gaps,
                  first=dict(pert=pert.cpu(), values=res.values.cpu(),
                             indices=res.indices.cpu(), kprime=plan.kprime))
    return shared, dict(requests=nq, tenants=TENANTS, recall_at_k=recalls,
                kth_gap=gaps,
                max_score_err=max_err, seq_request_ms=seq_ms,
                batch_stage_ms=stages,
                batch_total_ms=sum(stages.values()),
                batch_wall_ms=batch_wall_ms, batch_device_busy_ms=busy_ms,
                batch_device_idle_share=(None if busy_ms is None
                                         else 1.0 - busy_ms / batch_wall_ms),
                batch_device_ms_by_kernel=dict(sorted(
                    busy.items(), key=lambda kv: -kv[1])[:12]),
                topk_batch_split=topk_split,
                total_bytes=[b[2].total_bytes for b in batch],
                launches_seq=seq_launches, launches_batch=batch_launches,
                shapes_seq=seq_shapes, shapes_batch=batch_shapes)


def topk_batch_split(torch, index, pert, kprime: int) -> dict:
    """Wall ms of ``topk_batch``'s parts, each called again after the
    batch's run (so their launches are not the path's): the queries' H2D
    copy, the kernel, the cross-tile merge (a stable sort of the
    (B, num_tiles * kk) candidates), then the whole stage again, warm."""
    from repro_torch.kernels.scoretopk import ref as sref
    from repro_torch.kernels.scoretopk import scoretopk as kscore
    from repro_torch.serve import batching

    emb = index.embeddings
    tile = min(2048, emb.shape[0])
    kk = min(kprime, tile)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    q, h2d = wall(lambda: torch.as_tensor(pert, dtype=torch.float32,
                                          device=emb.device))
    (vals, ids), kern = wall(lambda: kscore.score_topk_cuda(q, emb, kk=kk,
                                                            tile=tile))
    _, merge = wall(lambda: sref.merge_tiles_ref(vals, ids, kprime))
    _, warm = wall(lambda: batching.topk_batch(index, pert, kprime))
    return dict(h2d_ms=h2d, kernel_ms=kern, merge_ms=merge, warm_ms=warm)


def shape_counts(counts: dict) -> list:
    """`ext.launch_shapes()` as JSON: [[kernel, shape, launches], ...]."""
    return [[k[0], list(k[1]), v] for k, v in sorted(counts.items())]


def shape_key(shape) -> str:
    return "x".join(str(d) for d in shape)


def launch_tally(kernels: list, paths: list) -> None:
    """Each kernel's launches over the paths' runs (``paths``: [(name,
    launches, shapes)]), in all, by path and by shape; each timed row's
    launches at its own shape and launches x (time - bound)
    (``excess_ms``), the rule-2 ranking of the kernels."""
    for kern in kernels:
        by_path = {name: counts.get(kern["name"], 0)
                   for name, counts, _ in paths}
        kern["launches"] = sum(by_path.values())
        kern["launches_by_path"] = by_path
        by_shape = collections.Counter()
        for _, _, shapes in paths:
            for name, shape, count in shapes:
                if name == kern["name"]:
                    by_shape[shape_key(shape)] += count
        kern["launches_by_shape"] = dict(by_shape)
        for row in [kern] + kern.get("at_shapes", []):
            row["launches_at_shape"] = by_shape.get(shape_key(row["shape"]),
                                                    0)
            row["excess_ms"] = row["launches_at_shape"] * (
                row["ms"] - row["bound_ms"])


def path_launches(name: str, counts: dict,
                  kernels: tuple = PATH_KERNELS) -> dict:
    """Fail unless every kernel of the path (``kernels``: the RLWE serving
    path's by default) launched in ``counts`` (one path's run, counts set
    to 0 just before it); on the RLWE serving path, fail if a kernel of
    `OFF_PATH_KERNELS` launched."""
    for kern in kernels:
        check(counts.get(kern, 0) > 0, f"{name}: kernel {kern} not launched")
    if kernels == PATH_KERNELS:
        for kern in OFF_PATH_KERNELS:
            check(counts.get(kern, 0) == 0,
                  f"{name}: {kern} launched {counts.get(kern)} times on "
                  f"the serving path")
    return counts


def cache_phase(torch, np, args, cache, params, plan, shared) -> dict:
    """The dense cache re-viewed as a 16-shard sharded cache (one copy of
    the pool to the host); sharded scores must equal the dense cache's bit
    for bit in three regimes."""
    from repro_torch.crypto import rlwe

    cand, enc = shared["cand"].astype(np.int64), shared["enc"]
    gen = np.random.default_rng(args.seed + 11)
    t0 = time.perf_counter()
    pool = cache.host_pool()
    host_copy_s = time.perf_counter() - t0
    out = dict(host_pool_copy_s=host_copy_s, host_pool_gb=pool.nbytes / 1e9,
               host_pool_gb_s=pool.nbytes / 1e9 / host_copy_s)

    def same_as_dense(sh, ids, label):
        want = rlwe.encrypted_scores_cached_batch(params, enc, cache, ids)
        got = rlwe.encrypted_scores_cached_batch(params, enc, sh, ids)
        check(torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1),
              f"cache phase ({label}): sharded scores differ from dense")

    def gather_ms(sh, ids):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sh.gather(ids)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def config(**kw):
        return rlwe.CandidateCacheConfig(num_shards=NUM_SHARDS, **kw)

    # (a) stream-only, on the 8 requests' top-k' ids: host row gathers
    sh = rlwe.shard_candidate_cache(cache, config(max_resident_bytes=0))
    check(sh.num_shards == NUM_SHARDS, f"{sh.num_shards} shards")
    same_as_dense(sh, cand, "stream-only")
    out["stream_only"] = dict(
        gather_ms=[gather_ms(sh, cand) for _ in range(3)],
        gather_mb=cand.size * pool[0].nbytes / 1e6, stats=sh.stats())
    sh.close()
    shard_docs = sh.shard_docs

    # (b) two pinned shards, ids confined to them: device-side gathers
    sh = rlwe.shard_candidate_cache(cache, config(pin_on_access=False))
    t0 = time.perf_counter()
    sh.pin(0)
    sh.pin(1)
    pin_s = time.perf_counter() - t0
    ids = gen.integers(0, 2 * shard_docs, size=cand.shape)
    same_as_dense(sh, ids, "pinned")
    check(sh.resident_shards == (0, 1) and sh.misses == 0,
          f"pinned: resident {sh.resident_shards}, misses {sh.misses}")
    out["pinned"] = dict(pin_two_shards_s=pin_s,
                         gather_ms=[gather_ms(sh, ids) for _ in range(3)],
                         stats=sh.stats())
    sh.close()
    del sh

    # (c) async admission on first touch: stream, admit on the admitter's
    # stream, then gather device-side; the bits never change
    sh = rlwe.shard_candidate_cache(cache, config(admit_threshold=1))
    ids = gen.integers(5 * shard_docs, 6 * shard_docs, size=cand.shape)
    first_ms = gather_ms(sh, ids)          # miss: streams, enqueues shard 5
    same_as_dense(sh, ids, "async, admission in flight or done")
    t0 = time.perf_counter()
    sh.flush()
    flush_s = time.perf_counter() - t0
    check(sh.resident_shards == (5,) and sh.async_admissions == 1,
          f"async: resident {sh.resident_shards}, "
          f"admissions {sh.async_admissions}")
    same_as_dense(sh, ids, "async, resident")
    out["async"] = dict(first_gather_ms=first_ms, flush_s=flush_s,
                        gather_ms=[gather_ms(sh, ids) for _ in range(3)],
                        stats=sh.stats())
    sh.close()
    del sh
    torch.cuda.synchronize()
    return out


def engine_phase(torch, np, args, index, params, plan, queries,
                 shared) -> dict:
    """16 requests of 4 tenants (the 8 queries, twice) through ServeEngine:
    dense batched, dense sequential, sharded batched.  Every request must
    return the same ids, documents and wire bytes in all three runs, with
    recall@5 = 1.0."""
    from repro_torch.crypto import rlwe
    from repro_torch.serve import EngineConfig, ServeEngine, SessionManager

    shard_bytes = -(-index.num_rows // NUM_SHARDS) * params.num_chunks(
        index.dim) * params.num_primes * params.n_poly * 4
    runs = {
        "dense_batched": EngineConfig(max_batch=8, trace=True),
        "dense_sequential": EngineConfig(max_batch=1, sequential=True,
                                         trace=True),
        "sharded_batched": EngineConfig(
            max_batch=8, trace=True, cache_config=rlwe.CandidateCacheConfig(
                num_shards=NUM_SHARDS,
                max_resident_bytes=BUDGET_SHARDS * shard_bytes)),
    }
    want = shared["want"]
    n = 2 * len(queries)
    reqs = [queries[j % len(queries)] for j in range(n)]
    keys = [args.seed * 1000 + j for j in range(n)]
    out, results = {}, {}
    for name, cfg in runs.items():
        engine = ServeEngine(index, config=cfg, sessions=SessionManager(
            rlwe_params=params, deterministic_seeds=True))
        for t in range(TENANTS):
            engine.open_session(f"tenant-{t}", n=index.dim, N=index.num_rows,
                                k=plan.k, plan_kwargs={"kprime": paper().KPRIME})
        # batched runs under torch.profiler for the device's busy and idle
        # share of the run's wall time
        res, run = serve_run(torch, np, engine, reqs, keys,
                             lambda j: f"tenant-{j % TENANTS}",
                             f"engine {name}", profiled=not cfg.sequential)
        engine.close()
        recalls = [len(set(r.ids.tolist()) & set(
            want[r.request_id % len(queries)].tolist())) / plan.k
            for r in res]
        check(all(x == 1.0 for x in recalls),
              f"engine {name}: recall@{plan.k} {recalls}")
        results[name] = res
        summary = engine.metrics.summary()
        agg = summary["aggregate"]
        out[name] = dict(
            run, num_batches=summary["num_batches"],
            p50_latency_s=agg["p50_latency_s"],
            p99_latency_s=agg["p99_latency_s"],
            mean_latency_s=agg["mean_latency_s"],
            stages=engine.trace_summary()["stages"],
            cache_stats=engine.cache_stats())
    base = results["dense_batched"]
    for name, res in results.items():
        for a, b in zip(base, res):
            check(same_result(a, b), f"engine {name}: request "
                                     f"{b.request_id} differs from the "
                                     f"dense batched run")
    return out, base


class Peaks:
    """Peak device memory (PyTorch's allocator, reset on entry) and peak
    host RSS (``/proc/self/statm`` sampled every 20 ms) over one phase."""

    def __init__(self, torch):
        self.torch = torch
        self.result: dict = {}

    @staticmethod
    def rss_gb() -> float:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e9

    def _sample(self) -> None:
        while not self._stop.wait(0.02):
            self._host = max(self._host, self.rss_gb())

    def __enter__(self) -> "Peaks":
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()
        self._host = self.rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.torch.cuda.synchronize()
        self._stop.set()
        self._thread.join()
        self.result = dict(
            device_peak_gb=self.torch.cuda.max_memory_allocated() / 1e9,
            device_now_gb=self.torch.cuda.memory_allocated() / 1e9,
            host_peak_gb=max(self._host, self.rss_gb()),
            host_now_gb=self.rss_gb())


def same_result(a, b) -> bool:
    """Two ServeResults agree: request id, tenant, ids, documents, bytes."""
    return (a.request_id == b.request_id and a.tenant == b.tenant
            and a.ids.tolist() == b.ids.tolist() and a.docs == b.docs
            and all(getattr(a.transcript, f) == getattr(b.transcript, f)
                    for f in ("total_bytes", "request_bytes",
                              "reply_bytes")))


def close(got, want) -> bool:
    """Score-top-k values of kernel and plain version agree."""
    return bool(((got - want).abs()
                 <= SCORE_RTOL * want.abs() + SCORE_ATOL).all())


def ids_up_to_ties(torch, q, emb, got, want, want_vals, what) -> int:
    """``got``/``want``: (B, k) ids over rows ``emb`` for queries ``q``;
    where they differ, the id ``got`` holds must score (float64) within
    the tolerance of the value ``want`` has there: kernel and plain version
    sum in other orders, so rows tied that closely may swap.  Returns the number
    of swapped positions."""
    mism = got != want
    if bool(mism.any()):
        b_idx, _ = torch.nonzero(mism, as_tuple=True)
        rescored = (q[b_idx].double() * emb[got[mism].long()].double()).sum(-1)
        ok = ((rescored - want_vals[mism].double()).abs()
              <= SCORE_RTOL * want_vals[mism].abs() + SCORE_ATOL)
        check(bool(ok.all()), f"{what}: ids differ beyond score ties")
    return int(mism.sum())


def serve_run(torch, np, srv, queries, keys, tenant, name,
              profiled=False, join=None, kernels=PATH_KERNELS) -> tuple:
    """Submit ``queries[j]`` with ``keys[j]`` for ``tenant(j)`` and drain,
    the launch counts set to 0 just before and read just after (with
    ``profiled``, under torch.profiler, CUDA activity only; ``join`` is
    called after the drain, before the counts are read, for work that runs
    beside the requests).  Every kernel of the serving path must have
    launched (``kernels``) and every request succeeded."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ext

    torch.cuda.synchronize()
    ext.reset_launches()
    prof = profile(activities=[ProfilerActivity.CUDA]) if profiled else None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    for j, (q, key) in enumerate(zip(queries, keys)):
        srv.submit(tenant(j), q, key=key)
    res = srv.drain()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if join is not None:
        join()
    busy_ms = None
    if prof is not None:
        prof.__exit__(None, None, None)
        _, busy_ms = device_busy(torch, prof)
    launches = path_launches(name, ext.launch_counts(), kernels)
    check(len(res) == len(queries) and all(r.ok for r in res),
          f"{name}: {[r.error for r in res if not r.ok]}")
    return res, dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                     device_idle_share=(None if busy_ms is None
                                        else 1.0 - busy_ms / wall_ms),
                     launches=launches,
                     shapes=shape_counts(ext.launch_shapes()))


def router_phase(torch, np, args, index, params, plan, queries,
                 want) -> dict:
    """The engine phase's 16 requests through ReplicaRouter(4 replicas,
    max_batch 8) over the same index and dense cache: per request equal to
    the dense batched engine run (ids, documents, wire bytes, request
    ids)."""
    from repro_torch.serve import (EngineConfig, ReplicaRouter, RouterConfig,
                                   SessionManager)

    rt = ReplicaRouter(index, config=RouterConfig(
        num_replicas=ROUTER_REPLICAS,
        engine=EngineConfig(max_batch=8, trace=True)),
        sessions=SessionManager(rlwe_params=params, deterministic_seeds=True))
    for t in range(TENANTS):
        rt.open_session(f"tenant-{t}", n=index.dim, N=index.num_rows,
                        k=plan.k, plan_kwargs={"kprime": paper().KPRIME})
    n = 2 * len(queries)
    res, run = serve_run(
        torch, np, rt, [queries[j % len(queries)] for j in range(n)],
        [args.seed * 1000 + j for j in range(n)],
        lambda j: f"tenant-{j % TENANTS}", "router", profiled=True)
    summary = rt.summary()
    stages = {str(h.replica_id): h.engine.trace_summary()["stages"]
              for h in rt.replicas}
    rt.close()
    by_rid = {r.request_id: r for r in want}
    check(sorted(by_rid) == [r.request_id for r in res],
          "router: request ids differ from the engine run's")
    for r in res:
        check(same_result(by_rid[r.request_id], r),
              f"router: request {r.request_id} differs from the dense "
              f"batched engine run")
    fleet = summary["router"]
    check(fleet["fallback_scans"] == 0 and not fleet["quarantines"],
          f"router: {fleet}")
    return dict(replicas=ROUTER_REPLICAS, slices=summary["slices"],
                scatter_calls=fleet["scatter_calls"],
                slice_scans=fleet["slice_scans"],
                merged_candidates=fleet["merged_candidates"],
                merge_wall_s=fleet["merge_wall_s"],
                merge_wall_ms_per_scatter=(
                    fleet["merge_wall_s"] * 1e3 / fleet["scatter_calls"]),
                submitted=fleet["submitted"], stages_by_replica=stages,
                **run)


def device_profile(torch, prof, wall_ms: float) -> dict:
    """Device-side events of a CUDA-only profile: busy ms, kernel launches
    and copies (memcpy, memset), and the idle share of ``wall_ms`` (the
    same work's wall without the profiler); an empty trace gives nulls,
    never an idle device."""
    busy, kernels, copies = 0.0, 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.time_range.elapsed_us() / 1e3
            if e.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
    if kernels + copies == 0:
        return dict(device_busy_ms=None, launches=None, copies=None,
                    device_idle_share=None)
    return dict(device_busy_ms=busy, launches=kernels, copies=copies,
                device_idle_share=1.0 - busy / wall_ms)


def walled(torch, fn) -> tuple:
    """(fn(), wall ms, Montgomery multiplies) between synchronizations."""
    from repro_torch.kernels.bignum import ops as bops

    torch.cuda.synchronize()
    bops.reset_mont_mul_counts()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3, bops.mont_mul_counts()


def profiled(torch, fn, wall_ms: float, top: int = 0) -> tuple:
    """(fn(), device profile) for a repeat of work whose unprofiled wall
    was ``wall_ms`` (torch.profiler, CUDA activity only); with ``top``,
    the profile also lists the ``top`` device kernels by summed time
    (``top_kernels``: [name cut to 90 characters, ms, launches])."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = fn()
        torch.cuda.synchronize()
    out = device_profile(torch, prof, wall_ms)
    if top:
        by_name: dict = collections.defaultdict(lambda: [0.0, 0])
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                row = by_name[e.name[:90]]
                row[0] += e.time_range.elapsed_us() / 1e3
                row[1] += 1
        out["top_kernels"] = sorted(([k, ms, n] for k, (ms, n) in
                                     by_name.items()),
                                    key=lambda r: -r[1])[:top]
    return r, out


def check_wire(accounting, res, key_bits: int, dim: int, kprime: int,
               what: str) -> None:
    """The ciphertext part of a Paillier transcript equals the accounting
    model's at the key's own bit length."""
    tr = res.transcript if hasattr(res, "transcript") else res
    check(tr.request_bytes - (dim * 4 + 4)
          == accounting.paillier_query_bytes(dim, key_bits)
          and tr.reply_bytes - kprime * 4
          == accounting.paillier_scores_bytes(kprime, key_bits),
          f"{what}: wire bytes {tr.request_bytes}/{tr.reply_bytes} differ "
          f"from the model at {key_bits}-bit keys")


def bignum_table(torch, np, sks, kprime, dim, dev, seed) -> list:
    """The bignum ops (float64 tensor ops, not Pallas) at the score stage's
    shapes (8 lanes, k' = 161, 768 dims, 93 channels of 512-bit keys):
    each one's wall per call (CUDA events around it: what a caller waits),
    device time where a call's launches fit behind the timing spin, its
    launches (profiled over ``reps`` calls in one session: a session of a
    few launches can come back short) and the time its bytes take at the
    HBM rate (each input read once, the output written once)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.crypto import paillier_vec as pvec
    from repro_torch.kernels.bignum import ops as bops
    from repro_torch.kernels.bignum import ref as bref

    L, K, D = len(sks), kprime, dim
    ctxs = [pvec._ctx(sk.pub.n_sq) for sk in sks]
    C2 = bops.make_consts(ctxs[0].system, ctxs, 2, device=dev)
    C3 = bops.make_consts(ctxs[0].system, ctxs, 3, device=dev)
    gen = np.random.default_rng(seed)

    def values(count):
        return torch.from_numpy(np.stack([bref.to_rns(c, [
            int(gen.integers(1, 2**62)) ** 9 % c.modulus
            for _ in range(count)]) for c in ctxs])).to(dev)

    acc, qv = values(K), values(D)                  # [L, K, C], [L, D, C]
    nch = acc.shape[-1]
    table = bops.pow_table(qv, C2, pvec.SCORE_WINDOW)
    idx = torch.from_numpy(gen.integers(0, table.shape[0], size=(L, K, D))
                           ).to(dev)
    lane = torch.arange(L, device=dev)[:, None, None]
    dim = torch.arange(D, device=dev)[None, None, :]
    g = table[idx, lane, dim]                       # [L, K, D, C]
    half = g[:, :, :D // 2].contiguous()
    ndig = torch.from_numpy(bops.to_digits([sk.pub.n for sk in sks],
                                           pvec.EXP_WINDOW)).to(dev)
    digits = ndig[:, None, :].expand(-1, K, -1)
    ntable = bops.pow_table(acc, C2, pvec.EXP_WINDOW)
    f64 = 8
    rows = [   # name, shape, call, bytes, device-timed, profiled calls
        ("mont_mul", [L, K, nch], lambda: bops.mont_mul(acc, acc, C2),
         3 * acc.numel() * f64, True, 20),
        ("mont_mul", [L, K, D // 2, nch],
         lambda: bops.mont_mul(half, half, C3), 3 * half.numel() * f64,
         True, 3),
        ("gather", [L, K, D, nch], lambda: table[idx, lane, dim],
         (table.numel() + g.numel()) * f64 + idx.numel() * 8, True, 20),
        ("product_reduce", [L, K, D, nch],
         lambda: bops.product_reduce(g, C3), (g.numel() + acc.numel()) * f64,
         False, 3),
        ("pow_table_w5", [L, D, nch],
         lambda: bops.pow_table(qv, C2, pvec.SCORE_WINDOW),
         (qv.numel() + table.numel()) * f64, False, 2),
        ("exp_n_w4", [L, K, nch],
         lambda: bops.mont_exp_digits(ntable, digits, C2, pvec.EXP_WINDOW),
         (ntable.numel() + acc.numel()) * f64 + digits.numel() * 8, False, 1),
    ]
    out = []
    for name, shape, fn, nbytes, device_timed, reps in rows:
        torch.cuda.synchronize()
        bops.reset_mont_mul_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launches = sum(1 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        out.append(dict(
            name=name, shape=shape,
            mont_muls=bops.mont_mul_counts()["calls"] // reps,
            launches=(launches / reps if launches else None),
            call_ms=call_ms(torch, fn, 5),
            device_ms=(time_ms(torch, fn, 5) if device_timed else None),
            bound_ms=nbytes / HBM_BYTES_S * 1e3, bound_by="bytes"))
    del g, half, table, ntable
    return out


def paillier_phase(torch, np, args, index, plan, queries, shared) -> tuple:
    """The Paillier backend over the paper-config index (10^6 x 768, k' =
    161, 512-bit keys: 46 residue channels).  Returns (phase dict, [(path,
    launches, shapes)])."""
    from repro_torch.core import accounting, baselines, protocol
    from repro_torch.crypto import ot as ot_mod
    from repro_torch.crypto import paillier as pai
    from repro_torch.crypto import paillier_vec as pvec
    from repro_torch.kernels import ext
    from repro_torch.kernels.bignum import ref as bref
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.serve import EngineConfig, ServeEngine, SessionManager

    dev = index.device
    nq, dim, kprime, k = len(queries), index.dim, plan.kprime, plan.k
    want = shared["want"]
    out, paths = {}, []

    # -- (a) one batch of 8 lanes, stage by stage, against the object path -
    t0 = time.perf_counter()
    keys = [pai.keygen(PAILLIER_BITS,
                       rng=np.random.default_rng(args.seed + 200 + t))
            for t in range(TENANTS)]
    out["keygen_s"] = time.perf_counter() - t0
    sks = [keys[j % TENANTS] for j in range(nq)]
    channels = bref.num_channels(keys[0].pub.n_sq)
    check(channels == 46 and all(pvec.fits(s.pub) for s in keys),
          f"paillier: {channels} channels at {PAILLIER_BITS}-bit keys")
    cand = shared["cand"]
    rows = index.rows(cand)                              # (8, k', 768)
    rows_np = rows.cpu().numpy()
    enc_seed, blind_seed = args.seed + 300, args.seed + 400
    pvec.reset_counters()

    def encrypt(j):
        return pvec.encrypt_vector(
            sks[j].pub, queries[j], rng=np.random.default_rng(enc_seed + j),
            device=dev)

    def score():
        return pvec.encrypted_scores_batch(
            [s.pub for s in sks], enc, list(rows),
            rngs=[np.random.default_rng(blind_seed + j) for j in range(nq)],
            device=dev)

    stages = {}
    enc, wall, mm = walled(torch, lambda: [encrypt(j) for j in range(nq)])
    lane0_wall = walled(torch, lambda: encrypt(0))[1]
    enc0, prof = profiled(torch, lambda: encrypt(0), lane0_wall)
    check(enc0 == enc[0], "paillier: encryption is not reproducible")
    stages["encrypt"] = dict(wall_ms=wall, lanes=nq, mont_muls=mm,
                             lane_wall_ms=lane0_wall, lane_profile=prof)
    cts, wall, mm = walled(torch, score)
    again, prof = profiled(torch, score, wall)
    check(again == cts, "paillier: scores are not reproducible")
    stages["score"] = dict(wall_ms=wall, mont_muls=mm, **prof)
    dec, wall, mm = walled(torch, lambda: pvec.decrypt_scores_batch(
        sks, cts, device=dev))
    _, prof = profiled(torch, lambda: pvec.decrypt_scores_batch(
        sks, cts, device=dev), wall)
    stages["decrypt"] = dict(wall_ms=wall, mont_muls=mm, **prof)
    check(pvec.counters["object"] == 0,
          f"paillier: 512-bit lanes took the object path {pvec.counters}")

    # the object path on the batch's first lanes, same seeds: the same
    # integers
    lanes = PAILLIER_OBJECT_LANES
    obj = dict(lanes=lanes)
    t0 = time.perf_counter()
    obj_enc = [pai.encrypt_vector(sks[j].pub, queries[j],
                                  rng=np.random.default_rng(enc_seed + j))
               for j in range(lanes)]
    obj["encrypt_ms"] = (time.perf_counter() - t0) * 1e3
    check(obj_enc == enc[:lanes], "paillier: vectorized encryption differs "
                                  "from the object path")
    t0 = time.perf_counter()
    obj_cts = [pai.encrypted_scores(sks[j].pub, enc[j], rows_np[j],
                                    rng=np.random.default_rng(blind_seed + j))
               for j in range(lanes)]
    obj["score_ms"] = (time.perf_counter() - t0) * 1e3
    check(obj_cts == cts[:lanes], "paillier: vectorized scores differ from "
                                  "the object path")
    t0 = time.perf_counter()
    obj_dec = [pai.decrypt_scores(sks[j], cts[j]) for j in range(lanes)]
    obj["decrypt_ms"] = (time.perf_counter() - t0) * 1e3
    check(all(np.array_equal(a, b) for a, b in zip(obj_dec, dec)),
          "paillier: vectorized decryption differs from the object path")
    q = torch.from_numpy(np.asarray(queries, np.float64)).to(dev)
    truth = torch.einsum("bkd,bd->bk", rows.double(), q).cpu().numpy()
    max_err = float(np.abs(np.stack(dec) - truth).max())
    check(max_err <= 2e-3, f"paillier: decrypted scores off by {max_err}")
    out.update(batch_lanes=nq, channels=channels, stages=stages,
               object_path=obj, max_score_err=max_err,
               # wall a lane, vectorized over the object path's
               vectorized_vs_object=dict(
                   (s, stages[s]["wall_ms"] / nq / (obj[f"{s}_ms"] / lanes))
                   for s in ("encrypt", "score", "decrypt")))

    # -- (b) 16 requests of 4 tenants through the engine, batched and one
    # at a time; (d) a batch mixing a 1024-bit tenant -----------------------
    def engine(cfg, bits):
        eng = ServeEngine(index, config=cfg, sessions=SessionManager(
            deterministic_seeds=True, device=dev))
        for t, b in bits.items():
            eng.open_session(t, n=dim, N=index.num_rows, k=k,
                             backend="paillier", paillier_bits=b,
                             plan_kwargs={"kprime": paper().KPRIME})
        return eng

    tenants = {f"tenant-{t}": PAILLIER_BITS for t in range(TENANTS)}
    n = 2 * nq
    reqs = [queries[j % nq] for j in range(n)]
    rkeys = [args.seed * 1000 + j for j in range(n)]
    runs, results = {}, {}
    for name, cfg in (("batched", EngineConfig(max_batch=8, trace=True)),
                      ("sequential", EngineConfig(max_batch=1,
                                                  sequential=True))):
        # one at a time, the first PAILLIER_SEQ_REQUESTS requests: seconds
        # of bignum launches a request
        count = n if name == "batched" else PAILLIER_SEQ_REQUESTS
        eng = engine(cfg, tenants)
        res, run = serve_run(torch, np, eng, reqs[:count], rkeys[:count],
                             lambda j: f"tenant-{j % TENANTS}",
                             f"paillier engine {name}",
                             kernels=PAILLIER_KERNELS)
        for r in res:
            check_wire(accounting, r, eng.sessions.get(
                r.tenant).user.sk.pub.key_bits, dim, kprime,
                f"paillier engine {name}")
        summary = eng.metrics.summary()
        run.update(num_batches=summary["num_batches"],
                   p50_latency_s=summary["aggregate"]["p50_latency_s"])
        if cfg.trace:
            run["stages"] = eng.trace_summary()["stages"]
        eng.close()
        results[name], runs[name] = res, run
        paths.append((f"paillier_engine_{name}", run["launches"],
                      run.pop("shapes")))
    for a, b in zip(results["batched"], results["sequential"]):
        check(same_result(a, b), f"paillier engine: request {a.request_id} "
                                 f"batched differs from sequential")
    recalls = [len(set(r.ids.tolist()) & set(want[r.request_id % nq].tolist()))
               / k for r in results["batched"]]
    check(all(x == 1.0 for x in recalls),
          f"paillier engine: recall@{k} {recalls}; k-th/(k+1)-th plaintext "
          f"gaps {shared['gaps']}")
    out.update(engine=runs, recall_at_k=recalls, kth_gap=shared["gaps"])

    # -- (c) one request through run_remoterag ----------------------------
    user = protocol.RemoteRagUser(
        n=dim, N=index.num_rows, k=k, plan=plan, backend="paillier",
        paillier_bits=PAILLIER_BITS, rng=np.random.default_rng(args.seed + 500),
        device=dev)
    cloud = protocol.RemoteRagCloud(index)
    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    docs, ids, tr = protocol.run_remoterag(
        user, cloud, queries[0],
        torch.Generator(device=dev).manual_seed(args.seed * 1000))
    one_ms = (time.perf_counter() - t0) * 1e3
    paths.append(("paillier_run_remoterag", path_launches(
        "paillier run_remoterag", ext.launch_counts(), PAILLIER_KERNELS),
        shape_counts(ext.launch_shapes())))
    first = results["batched"][0]
    check(ids.tolist() == first.ids.tolist() and docs == first.docs,
          "paillier run_remoterag differs from the engine's request 0")
    check_wire(accounting, tr, user.sk.pub.key_bits, dim, kprime,
               "paillier run_remoterag")
    out["run_remoterag_ms"] = one_ms

    # (d) the fallback boundary: one batch, a 1024-bit tenant (90 channels,
    # the object path) beside three 512-bit ones
    mixed = {"tenant-big": FALLBACK_BITS,
             **{f"tenant-{t}": PAILLIER_BITS for t in range(1, TENANTS)}}
    names = list(mixed)
    pvec.reset_counters()
    eng = engine(EngineConfig(max_batch=8), mixed)
    big = eng.sessions.get("tenant-big").user.sk.pub
    check(not pvec.fits(big) and bref.num_channels(big.n_sq) == 90,
          f"paillier: {bref.num_channels(big.n_sq)} channels at "
          f"{FALLBACK_BITS} bits")
    res, run = serve_run(torch, np, eng, reqs[:TENANTS], rkeys[:TENANTS],
                         lambda j: names[j], "paillier fallback batch",
                         kernels=PAILLIER_KERNELS)
    eng.close()
    lanes = dict(pvec.counters)
    check(lanes == {"vectorized": 3 * (TENANTS - 1), "object": 3}
          and res[0].batch_size == TENANTS,
          f"paillier fallback: lane counters {lanes}")
    solo_eng = engine(EngineConfig(max_batch=1), {"tenant-big": FALLBACK_BITS})
    solo, _ = serve_run(torch, np, solo_eng, reqs[:1], rkeys[:1],
                        lambda j: "tenant-big", "paillier fallback solo",
                        kernels=PAILLIER_KERNELS)
    solo_eng.close()
    check(solo[0].ids.tolist() == res[0].ids.tolist()
          and solo[0].docs == res[0].docs,
          "paillier fallback: the object lane differs from its solo run")
    check_wire(accounting, res[0], big.key_bits, dim, kprime,
               "paillier fallback lane")
    paths.append(("paillier_fallback", run["launches"], run.pop("shapes")))
    out["fallback"] = dict(lane_counters=lanes, batch_size=res[0].batch_size,
                           wall_ms=run["wall_ms"],
                           object_lane_ids=res[0].ids.tolist())

    # -- (e) the paper's baselines -----------------------------------------
    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    ign = [baselines.privacy_ignorant_service(index, queries[j], k)
           for j in range(nq)]
    ign_ms = (time.perf_counter() - t0) * 1e3
    paths.append(("baseline_ignorant", path_launches(
        "privacy-ignorant baseline", ext.launch_counts(), PAILLIER_KERNELS),
        shape_counts(ext.launch_shapes())))
    q32 = q.float()
    got_ids = torch.from_numpy(np.stack([b.ids for b in ign]).astype(
        np.int64)).to(dev)
    want_t = torch.from_numpy(want.astype(np.int64)).to(dev)
    want_vals = torch.gather(q32 @ index.embeddings.T, 1, want_t)
    swaps = ids_up_to_ties(torch, q32, index.embeddings, got_ids, want_t,
                           want_vals, "privacy-ignorant")
    small_n = CONSCIOUS_ROWS
    small_docs = [f"passage-{i}".encode() for i in range(small_n)]
    small = FlatIndex.build(index.embeddings[:small_n].cpu().numpy(),
                            documents=small_docs, normalize=False)
    s_want = torch.sort(-(small.embeddings.double() @ q[0]),
                        stable=True)[1][:k].cpu().numpy()
    conscious = {}
    for backend in ("rlwe", "paillier"):
        torch.cuda.synchronize()
        ext.reset_launches()
        t0 = time.perf_counter()
        r = baselines.privacy_conscious_service(
            small, queries[0], k, backend=backend,
            rng=np.random.default_rng(args.seed + 600), run_ot=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        check(r.ids.tolist() == s_want.tolist(),
              f"privacy-conscious {backend}: ids {r.ids.tolist()}, "
              f"plaintext top-{k} {s_want.tolist()}")
        conscious[backend] = dict(phe_s=wall_s, wire_bytes=r.wire_bytes)
        if backend == "rlwe":
            paths.append(("baseline_conscious_rlwe", path_launches(
                "privacy-conscious rlwe", ext.launch_counts(),
                CONSCIOUS_KERNELS), shape_counts(ext.launch_shapes())))
    # the k-of-N OT over the same rows, once (the same for both schemes)
    width = max(len(d) for d in small_docs)
    t0 = time.perf_counter()
    got, ot_wire = ot_mod.run_ot([d.ljust(width, b"\x00") for d in small_docs],
                                 [int(i) for i in s_want])
    ot_s = time.perf_counter() - t0
    check([d.rstrip(b"\x00") for d in got] == [small_docs[i] for i in s_want],
          "privacy-conscious OT: wrong documents")
    for backend, c in conscious.items():
        c["extrapolated_linear_s_at_1e6"] = (c["phe_s"] + ot_s) * 1e6 / small_n
    out["baselines"] = dict(
        ignorant=dict(requests=nq, wall_ms=ign_ms, id_swaps_at_ties=swaps,
                      wire_bytes=ign[0].wire_bytes),
        conscious=dict(rows=small_n, ot_s=ot_s, ot_wire_bytes=ot_wire,
                       **conscious))

    # -- (f) the bignum ops at the score stage's shapes ---------------------
    out["bignum_ops"] = bignum_table(torch, np, sks, kprime, dim, dev,
                                     args.seed + 700)
    return out, paths


def plain_routed_topk(torch, np, view, q, k, nprobe) -> tuple:
    """The IVF first stage through the plain version on the card: each
    query's routed clusters' rows gathered and scanned by
    `tile_topk_ref`'s scoring (`topk_ref`), global ids."""
    from repro_torch.kernels.scoretopk import ref as sref

    cm = view.cluster_map
    routed = cm.route(q.cpu().numpy(), nprobe)
    vals, ids = [], []
    for b in range(q.shape[0]):
        rows = torch.cat([torch.arange(int(cm.starts[c]), int(cm.stops[c]),
                                       device=q.device)
                          for c in sorted(int(c) for c in routed[b])])
        v, pos = sref.topk_ref(q[b:b + 1], view.embeddings[rows], k)
        vals.append(v[0])
        ids.append(rows[pos[0].long()].to(torch.int32))
    return torch.stack(vals), torch.stack(ids), routed


def ivf_phase(torch, np, args, params) -> tuple:
    """The epoch-versioned corpus at 10^6 x 768: a clustered corpus (64
    natural clusters) built with IVF (16 clusters aligned to 62,500-doc
    cache shards), the sharded cache only; the flat and routed first
    stages, an engine at the planned nprobe, a 50,000-doc ingest on a
    thread under an epoch-0 replay, then refresh and replan over the grown
    corpus.  Returns (phase dict, [(path, launches, shapes)])."""
    from repro_torch.core import planner
    from repro_torch.crypto import rlwe
    from repro_torch.data import synth
    from repro_torch.kernels import ext
    from repro_torch.kernels.ntt import ref as nref
    from repro_torch.kernels.scoretopk import ref as sref
    from repro_torch.retrieval import index as index_mod
    from repro_torch.retrieval.index import FlatIndex, IvfConfig
    from repro_torch.retrieval.topk import (cluster_topk, distributed_topk,
                                            plan_nprobe)
    from repro_torch.serve import (EngineConfig, ReplicaRouter, RouterConfig,
                                   ServeEngine, SessionManager, batching)

    dim, n_docs = paper().DIM, IVF_DOCS
    out, paths = {}, []
    t0 = time.perf_counter()
    corpus = synth.clustered_corpus(np.random.default_rng(args.seed), n_docs,
                                    dim, n_clusters=64)
    queries = synth.queries_near_corpus(np.random.default_rng(args.seed + 1),
                                        corpus, REQUESTS)
    docs = [f"passage-{i}".encode() for i in range(n_docs)]
    out["data_s"] = time.perf_counter() - t0

    # the k-means inside FlatIndex.build, timed on its own
    kmeans, timing = index_mod._kmeans_cluster_map, {}

    def timed_kmeans(emb, cfg):
        t = time.perf_counter()
        r = kmeans(emb, cfg)
        timing["kmeans_s"] = time.perf_counter() - t
        return r

    index_mod._kmeans_cluster_map = timed_kmeans
    try:
        t0 = time.perf_counter()
        index = FlatIndex.build(corpus, documents=docs, ivf=IvfConfig(
            num_clusters=IVF_CLUSTERS, align=IVF_SHARD_DOCS))
        torch.cuda.synchronize()
        out["index_build_s"] = time.perf_counter() - t0
    finally:
        index_mod._kmeans_cluster_map = kmeans
    out["kmeans_s"] = timing["kmeans_s"]
    del corpus, docs
    cm = index.cluster_map
    # (a) 16 aligned, contiguous ranges
    check(cm.num_clusters == IVF_CLUSTERS
          and all(int(a) % IVF_SHARD_DOCS == 0 for a in cm.starts)
          and np.array_equal(cm.starts[1:], cm.stops[:-1])
          and int(cm.stops[-1]) == n_docs,
          f"ivf: cluster map {cm.starts.tolist()} {cm.stops.tolist()}")
    plan = planner.plan(n=dim, N=n_docs, k=paper().K, kprime=paper().KPRIME)
    nprobe = plan_nprobe(cm, plan.kprime)
    shard_bytes = IVF_SHARD_DOCS * params.num_chunks(dim) * \
        params.num_primes * params.n_poly * 4
    cfg = rlwe.CandidateCacheConfig(
        shard_docs=IVF_SHARD_DOCS,
        max_resident_bytes=BUDGET_SHARDS * shard_bytes)
    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    cache = index.candidate_cache(params, cfg)
    torch.cuda.synchronize()
    out["pack_s"] = time.perf_counter() - t0
    paths.append(("ivf_pack", ext.launch_counts(),
                  shape_counts(ext.launch_shapes())))
    check(cache.num_shards == IVF_CLUSTERS
          and cache._starts.tolist() == cm.starts.tolist(),
          "ivf: cache shards and clusters do not coincide")

    # (b) every cluster scanned == the flat scan, bit for bit
    q = torch.from_numpy(queries).cuda()
    view = index.corpus_view()
    flat = distributed_topk(index, q, plan.kprime)
    routed = cluster_topk(view, q, plan.kprime)
    check(torch.equal(routed.indices, flat.indices)
          and torch.equal(routed.values.view(torch.int32),
                          flat.values.view(torch.int32))
          and routed.exact and flat.exact,
          "ivf: cluster_topk(nprobe=None) differs from the flat scan")
    pv, pi = sref.topk_ref(q, index.embeddings, plan.kprime)
    err = float((flat.values - pv).abs().max())
    check(close(flat.values, pv), f"ivf: flat scan values off the plain "
                                  f"version by {err}")
    out["flat_vs_plain"] = dict(max_abs_err=err, id_swaps=ids_up_to_ties(
        torch, q, index.embeddings, flat.indices, pi.to(flat.indices.dtype),
        pv, "ivf flat scan"))

    def sessions():
        return SessionManager(rlwe_params=params, deterministic_seeds=True)

    def engine(nprobe_=None):
        eng = ServeEngine(index, config=EngineConfig(
            max_batch=8, trace=True, cache_config=cfg, nprobe=nprobe_),
            sessions=sessions())
        for t in range(TENANTS):
            eng.open_session(f"tenant-{t}", n=dim, N=n_docs, k=plan.k,
                             plan_kwargs={"kprime": paper().KPRIME})
        return eng

    n_req = 2 * len(queries)
    reqs = [queries[j % len(queries)] for j in range(n_req)]
    keys = [args.seed * 1000 + j for j in range(n_req)]

    def tenant(j):
        return f"tenant-{j % TENANTS}"

    # truth for recall: the plaintext top-5 over the corpus
    scores = torch.matmul(q, index.embeddings.T)        # TF32 is off
    top5 = torch.sort(-scores, dim=1, stable=True)[1][:, :plan.k].cpu()

    def recall(res):
        return [len(set(r.ids.tolist()) & set(top5[r.request_id % len(
            queries)].tolist())) / plan.k for r in res]

    # (c) routed engine at the planned nprobe
    routed_eng = engine(nprobe)
    res_c, run = serve_run(torch, np, routed_eng, reqs, keys, tenant,
                           "ivf_routed_engine", profiled=True)
    paths.append(("ivf_routed_engine", run["launches"], run["shapes"]))
    out["routed_engine"] = dict(run, nprobe=nprobe, recall_at_k=recall(res_c),
                                stages=routed_eng.trace_summary()["stages"],
                                cache_stats=routed_eng.cache_stats())
    routed_eng.close()
    # its first stage again, on the engine's own perturbations (a lane is
    # perturb(generator(key)) whatever the batch): not exact, and the ids
    # the plain version's routed scan gives
    pert = batching.perturb_batch(
        [torch.Generator(device="cuda").manual_seed(k) for k in keys],
        np.stack(reqs), [plan.eps] * n_req)
    first = cluster_topk(view, pert, plan.kprime, nprobe=nprobe)
    check(not first.exact, "ivf: a routed scan at nprobe < C reported exact")
    rv, ri, lanes = plain_routed_topk(torch, np, view, pert, plan.kprime,
                                      nprobe)
    err = float((first.values - rv).abs().max())
    check(close(first.values, rv), f"ivf: routed values off the plain "
                                   f"version by {err}")
    swaps = ids_up_to_ties(torch, pert, index.embeddings, first.indices,
                           ri, rv, "ivf routed scan")
    cand = first.indices.cpu().numpy()
    for r in res_c:
        check(set(r.ids.tolist()) <= set(cand[r.request_id].tolist()),
              f"ivf: request {r.request_id} served ids outside its "
              f"routed candidates")
    out["routed_engine"].update(
        first_stage_max_abs_err=err, first_stage_id_swaps=swaps,
        rows_scanned_per_query=cm.sizes[lanes].sum(axis=1).tolist())

    # (d) the flat engine's results at epoch 0, then the same requests
    # through a fresh engine pinned at epoch 0 while 50,000 docs are
    # ingested on a thread; a router over the same index, made now, is
    # replanned after the ingest
    flat_eng = engine()
    res_d0, run = serve_run(torch, np, flat_eng, reqs, keys, tenant,
                            "ivf_flat_engine", profiled=True)
    paths.append(("ivf_flat_engine", run["launches"], run["shapes"]))
    out["flat_engine"] = dict(run, recall_at_k=recall(res_d0),
                              stages=flat_eng.trace_summary()["stages"])
    flat_eng.close()
    # every cluster, routed: bit-identical to the flat engine at epoch 0,
    # and after the refresh it scans the tail cluster too
    pinned = engine(IVF_CLUSTERS + 1)
    rt = ReplicaRouter(index, config=RouterConfig(
        num_replicas=ROUTER_REPLICAS,
        engine=EngineConfig(max_batch=8, cache_config=cfg)),
        sessions=sessions())
    tail = synth.clustered_corpus(np.random.default_rng(args.seed + 2),
                                  INGEST_DOCS, dim, n_clusters=64)
    tail_docs = [f"ingested-{i}".encode() for i in range(INGEST_DOCS)]
    box = {}

    def writer():
        try:
            box["t0"] = time.perf_counter()
            box["view"] = index.ingest(tail, documents=tail_docs)
            torch.cuda.synchronize()
            box["t1"] = time.perf_counter()
        except BaseException as e:      # noqa: BLE001 — re-raised below
            box["error"] = e

    torch.cuda.synchronize()
    ext.reset_launches()
    t_replay = time.perf_counter()
    th = threading.Thread(target=writer, name="ingest")
    th.start()
    t_serve = time.perf_counter()
    res_d, run = serve_run(torch, np, pinned, reqs, keys, tenant,
                           "ivf_replay_under_ingest", join=th.join)
    if "error" in box:
        raise box["error"]
    paths.append(("ivf_replay_under_ingest", run["launches"],
                  run["shapes"]))
    for a, b in zip(res_d0, res_d):
        check(same_result(a, b), f"ivf: epoch-0 replay of request "
                                 f"{b.request_id} differs under ingest")
    # the ingest packs its docs in blocks (`_pack_corpus_ntt`): forward NTTs
    # of block * chunks rows and of the remainder's, shapes no request has
    chunks = params.num_chunks(dim)
    block = max(1, (1 << 24) // (chunks * params.n_poly))
    pack_rows = {min(block, INGEST_DOCS) * chunks,
                 (INGEST_DOCS % block or block) * chunks}
    ingest_ntt = sum(c for name, shape, c in run["shapes"]
                     if name == "ntt_fwd" and shape[0] in pack_rows)
    check(ingest_ntt == params.num_primes * -(-INGEST_DOCS // block),
          f"ivf: the ingest's pack launched {ingest_ntt} forward NTTs")
    view1 = box["view"]
    check(view1.epoch == 1 and view1.num_rows == n_docs + INGEST_DOCS
          and cache.num_shards == IVF_CLUSTERS + 1 and cache.epoch == 1,
          "ivf: ingest did not publish epoch 1 and its tail shard")
    new_rows = index.embeddings[n_docs:]
    plain_tail = rlwe._pack_corpus_ntt(params, new_rows, host=True,
                                       ntt_fwd=nref.ntt_fwd_ref)
    check(np.array_equal(cache.shards[-1], plain_tail),
          "ivf: the tail shard differs from the plain pack")
    del plain_tail
    out["ingest"] = dict(
        docs=INGEST_DOCS, ingest_s=box["t1"] - box["t0"],
        ingest_start_s=box["t0"] - t_replay, ingest_end_s=box["t1"] - t_replay,
        replay_end_s=t_serve - t_replay + run["wall_ms"] / 1e3, replay=run,
        ingest_ntt_fwd_launches=ingest_ntt,
        cache_stats=cache.stats())

    # (e) refresh and replan; 8 queries near tail docs
    pinned.refresh_corpus()
    spans = rt.replan()
    grown = n_docs + INGEST_DOCS
    q_tail = synth.queries_near_corpus(np.random.default_rng(args.seed + 3),
                                       new_rows.cpu().numpy(), REQUESTS,
                                       jitter=0.02)
    qt = torch.from_numpy(q_tail).cuda()
    sc = torch.matmul(qt, index.embeddings.T)
    order = torch.sort(-sc, dim=1, stable=True)
    want5 = order[1][:, :plan.k].cpu()
    gaps = (order[0][:, plan.k] - order[0][:, plan.k - 1]).cpu().tolist()
    check(bool((want5[:, 0] >= n_docs).all()),
          "ivf: a query near a tail doc has a best match outside the tail")
    grown_runs = {}
    for name, srv in (("ivf_grown_engine", pinned), ("ivf_grown_router", rt)):
        for t in range(TENANTS):
            srv.open_session(f"tenant-{t}@e1", n=dim, N=grown, k=plan.k,
                             plan_kwargs={"kprime": paper().KPRIME})
        res, run = serve_run(torch, np, srv, list(q_tail),
                             [args.seed * 1000 + 500 + j
                              for j in range(REQUESTS)],
                             lambda j: f"tenant-{j % TENANTS}@e1", name)
        paths.append((name, run["launches"], run["shapes"]))
        rec = [len(set(r.ids.tolist()) & set(want5[r.request_id - res[0]
               .request_id].tolist())) / plan.k for r in res]
        check(all(x == 1.0 for x in rec),
              f"{name}: recall@{plan.k} {rec}; k-th/(k+1)-th gaps {gaps}")
        grown_runs[name] = (res, dict(run, recall_at_k=rec))
    pinned.close()
    rsum = rt.summary()["router"]
    rt.close()
    (res_e, run_e), (res_r, run_r) = grown_runs["ivf_grown_engine"], \
        grown_runs["ivf_grown_router"]
    for a, b in zip(res_e, res_r):
        check(a.tenant == b.tenant and a.ids.tolist() == b.ids.tolist()
              and a.docs == b.docs
              and a.transcript.total_bytes == b.transcript.total_bytes,
              f"ivf: router request {b.request_id} differs from the single "
              f"engine at epoch 1")
    out["grown"] = dict(spans=spans, kth_gap=gaps, engine=run_e,
                        router=dict(run_r, merge_wall_s=rsum["merge_wall_s"],
                                    scatter_calls=rsum["scatter_calls"]))
    del index, cache, view, view1, new_rows
    return out, paths


def served_ids_ok(scores, ids, k: int, tie: float) -> bool:
    """``ids`` are a plaintext top-``k`` of ``scores`` (one query's float
    scores over the corpus) up to ``tie``: every row scoring above the
    k-th best by more than ``tie`` is served, and no served row scores
    below it by more than ``tie``."""
    kth = float(scores.sort(descending=True).values[k - 1])
    served = set(int(i) for i in ids)
    clear = set((scores > kth + tie).nonzero()[:, 0].tolist())
    return (len(served) == k and clear <= served
            and all(float(scores[i]) >= kth - tie for i in served))


def text_phase(torch, np, args, params) -> tuple:
    """The service's text front end at full width: 2^17 passages built as
    `repro_torch.examples.private_rag_serve` builds them, tokenized
    (HashTokenizer(32768), 32 tokens), embedded on the card by the
    768-wide, 4-layer encoder (seeded weights), indexed with its dense
    candidate cache; 16 text queries of 4 tenants through a ServeEngine
    (max_batch 8), batched then sequential.  Returns (phase dict, [(path,
    launches, shapes)], timed score-top-k rows)."""
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.examples.private_rag_serve import TOPICS, make_passages
    from repro_torch.kernels import ext
    from repro_torch.models.embedder import Embedder, encoder_config
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.retrieval.topk import distributed_topk
    from repro_torch.serve import (EngineConfig, ServeEngine, SessionManager,
                                   batching)

    out, paths = {}, []
    dev = torch.device("cuda")
    cfg = encoder_config(dim=paper().DIM)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    passages = make_passages(rng, TEXT_DOCS)
    out["passages_s"] = time.perf_counter() - t0
    tok = HashTokenizer(cfg.vocab)
    t0 = time.perf_counter()
    ids = tok.encode_batch(passages, TEXT_SEQ)
    out["tokenise_s"] = time.perf_counter() - t0
    model = Embedder(cfg, generator=torch.Generator().manual_seed(args.seed),
                     device=dev)
    model.embed(ids[:EMBED_BATCH])                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = torch.cat([model.embed(ids[i:i + EMBED_BATCH])
                      for i in range(0, TEXT_DOCS, EMBED_BATCH)])
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    # the encoder's float32 work: per token and layer the q/k/v/o and
    # SwiGLU products (2 flops a multiply-add) and the attention's scores
    # and weighted values over the sequence
    spec = cfg.attn_spec
    hd = spec.padded_heads * spec.d_head
    per_token = cfg.n_layers * 2 * (
        cfg.d_model * hd + 2 * cfg.d_model * spec.padded_kv_heads * spec.d_head
        + hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff + 2 * TEXT_SEQ * hd)
    flops = per_token * TEXT_DOCS * TEXT_SEQ
    out.update(embed_s=embed_s, embed_batch=EMBED_BATCH,
               embed_tflop=flops / 1e12,
               embed_bound_s=flops / FP32_OPS_S,
               embed_tflop_s=flops / embed_s / 1e12)
    t0 = time.perf_counter()
    index = FlatIndex.build(embs.cpu().numpy(),
                            documents=[p.encode() for p in passages])
    torch.cuda.synchronize()
    out["index_s"] = time.perf_counter() - t0
    del embs
    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    cache = index.candidate_cache(params)
    torch.cuda.synchronize()
    out["cache_build_s"] = time.perf_counter() - t0
    out["cache_gb"] = cache.nbytes / 1e9
    paths.append(("text_pack", ext.launch_counts(),
                  shape_counts(ext.launch_shapes())))

    # 16 text queries (topic words and passage words), each embedded alone
    # as the example embeds its queries
    qrng = np.random.default_rng(args.seed + 1)
    qtexts = [" ".join(TOPICS[j % len(TOPICS)].split()[j % 3:j % 3 + 2]
                       + [f"w{qrng.integers(0, 500)}" for _ in range(2)])
              for j in range(TEXT_QUERIES)]
    q_embs = np.concatenate([model.embed(tok.encode_batch([t], TEXT_SEQ))
                             .cpu().numpy() for t in qtexts])
    q = torch.from_numpy(q_embs).to(index.device)
    scores = torch.matmul(q, index.embeddings.T)          # TF32 is off
    top = torch.sort(scores, dim=1, descending=True, stable=True)
    k = paper().K
    want = top.indices[:, :k].cpu()
    gaps = (top.values[:, k - 1] - top.values[:, k]).cpu().tolist()

    keys = [args.seed * 1000 + j for j in range(TEXT_QUERIES)]
    runs = {"batched": EngineConfig(max_batch=8, trace=True),
            "sequential": EngineConfig(max_batch=1, sequential=True,
                                       trace=True)}
    results = {}
    for name, ecfg in runs.items():
        eng = ServeEngine(index, config=ecfg, sessions=SessionManager(
            rlwe_params=params, deterministic_seeds=True))
        for t in range(TENANTS):
            eng.open_session(f"tenant-{t}", n=cfg.d_model, N=TEXT_DOCS, k=k,
                             radius=0.05, backend="rlwe")
        plan = eng.sessions.get("tenant-0").plan
        res, run = serve_run(torch, np, eng, list(q_embs), keys,
                             lambda j: f"tenant-{j % TENANTS}",
                             f"text engine {name}",
                             profiled=not ecfg.sequential)
        eng.close()
        paths.append((f"text_engine_{name}", run["launches"], run["shapes"]))
        agg = eng.metrics.summary()["aggregate"]
        out[name] = dict(run, p50_latency_s=agg["p50_latency_s"],
                         p99_latency_s=agg["p99_latency_s"],
                         mean_latency_s=agg["mean_latency_s"],
                         stages=eng.trace_summary()["stages"])
        out[name].pop("shapes")
        results[name] = res
    for a, b in zip(results["batched"], results["sequential"]):
        check(same_result(a, b), f"text: request {b.request_id} batched "
                                 f"differs from sequential")
    recalls = []
    for r in results["batched"]:
        j = r.request_id
        check(r.docs == [passages[int(i)].encode() for i in r.ids],
              f"text: request {j}: documents do not match ids")
        check(served_ids_ok(scores[j], r.ids, k, TEXT_TIE),
              f"text: request {j} served {r.ids.tolist()}, plaintext top-"
              f"{k} {want[j].tolist()} (k-th/(k+1)-th gap {gaps[j]})")
        recalls.append(len(set(r.ids.tolist()) & set(want[j].tolist())) / k)
    # Theorem 1's planned k' assumes a uniform corpus: did the true top-k
    # lie inside each request's first-stage candidates?  (printed)
    pert = batching.perturb_batch(
        [torch.Generator(device="cuda").manual_seed(key) for key in keys],
        q_embs, [plan.eps] * TEXT_QUERIES)
    cand = distributed_topk(index, pert, plan.kprime).indices.cpu()
    inside = [set(want[j].tolist()) <= set(cand[j].tolist())
              for j in range(TEXT_QUERIES)]
    rows = [score_topk_row(torch, q[:b], index.embeddings, plan.kprime)
            for b in (1, 8)]
    out.update(docs=TEXT_DOCS, seq=TEXT_SEQ, queries=qtexts,
               kprime=plan.kprime, eps=plan.eps, path=plan.path,
               recall_at_k=recalls, kth_gap=gaps, tie=TEXT_TIE,
               top_k_inside_kprime=inside,
               total_bytes=[r.transcript.total_bytes
                            for r in results["batched"]])
    del index, cache, model
    return out, paths, rows


def attack_phase(torch, np, args) -> tuple:
    """The Fig. 4 inversion attacks: (a) the benchmark's full setting
    (3000 token documents x 768, vocab 1024, 15 paraphrases, 50 queries,
    one generator for the corpus and, in order, the exact-recovery, NN F1
    and linear-decoder curves) on the card and through the plain CPU path
    from a copy of the generator; (b) the same attacks over 100,000 aux
    documents x 768 at vocab 4096 with 256 queries, on the card.  Returns
    (phase dict, [(path, launches, shapes)], timed score-top-k rows)."""
    import copy

    from repro_torch.core import attacks
    from repro_torch.data import synth
    from repro_torch.kernels import ext

    dim = paper().DIM
    out, paths = {}, []

    def curves(corpus, n_q, device, gen) -> tuple:
        walls = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t
            return r

        nn = timed("nn_build_s", lambda: attacks.NearestNeighborAttack(
            aux=corpus, device=device))
        exact = timed("exact_curve_s", lambda: attacks.exact_recovery_curve(
            nn, corpus, range(n_q), RADII, gen))
        f1 = timed("f1_curve_s", lambda: attacks.attack_curve(
            nn, corpus, range(n_q), RADII, gen))
        lin = timed("linear_build_s", lambda: attacks.LinearDecoderAttack(
            aux=corpus, top_m=20, device=device))
        lin_c = timed("linear_curve_s", lambda: attacks.attack_curve(
            lin, corpus, range(n_q), RADII, gen))
        return dict(exact=exact.tolist(), nn_f1=f1.tolist(),
                    linear_f1=lin_c.tolist(), walls=walls), nn

    def counted(name, fn):
        torch.cuda.synchronize()
        ext.reset_launches()
        r = fn()
        torch.cuda.synchronize()
        paths.append((name, path_launches(name, ext.launch_counts(),
                                          ATTACK_KERNELS),
                      shape_counts(ext.launch_shapes())))
        return r

    # -- (a) Fig. 4's full setting, card and CPU --------------------------
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    corpus = synth.token_corpus(rng, FIG4_DOCS, dim, vocab=1024, doc_len=20,
                                paraphrases=15)
    corpus_s = time.perf_counter() - t0
    rng_cpu = copy.deepcopy(rng)
    card, nn = counted("attack_fig4", lambda: curves(
        corpus, FIG4_QUERIES, torch.device("cuda"), rng))
    cpu, nn_cpu = curves(corpus, FIG4_QUERIES, "cpu", rng_cpu)
    for name in ("exact", "nn_f1", "linear_f1"):
        c = card[name]
        check(all(c[i + 1] <= c[i] + 0.05 for i in range(len(c) - 1)),
              f"attack: {name} curve {c} rises with the radius")
    check(card["exact"][0] == 1.0,
          f"attack: exact recovery {card['exact'][0]} at r = 0")
    lin_err = max(abs(a - b) for a, b in zip(card["linear_f1"],
                                             cpu["linear_f1"]))
    check(lin_err <= 0.02, f"attack: linear-decoder curve on the card off "
                           f"the CPU's by {lin_err}")
    # the NN decode, card (kernel) against CPU (plain version): equal ids
    # up to rows scoring within 1e-5 (float64) of each other
    obs = attacks.perturbed_queries(corpus, range(FIG4_QUERIES), RADII,
                                    np.random.default_rng(args.seed + 5))
    got, want = nn.decode_indices(obs), nn_cpu.decode_indices(obs)
    e64 = corpus.embeddings.astype(np.float64)
    u = synth.unit(obs)
    sc_got = (e64[got] * u).sum(-1)
    sc_want = (e64[want] * u).sum(-1)
    check(bool((np.abs(sc_got - sc_want) <= 1e-5).all()),
          "attack: NN decode ids on the card differ beyond score ties")
    out["fig4"] = dict(
        docs=FIG4_DOCS, queries=FIG4_QUERIES, radii=list(RADII),
        corpus_s=corpus_s, card=card, cpu=cpu,
        decode_id_swaps=int((got != want).sum()),
        nn_curve_max_diff=max(abs(a - b) for name in ("exact", "nn_f1")
                              for a, b in zip(card[name], cpu[name])),
        linear_curve_max_diff=lin_err)
    q_fig4 = torch.from_numpy(u.astype(np.float32)).cuda()
    timed_rows = [score_topk_row(torch, q_fig4, nn.embeddings, 1)]

    # -- (b) at scale, on the card ----------------------------------------
    rng = np.random.default_rng(args.seed + 1)
    t0 = time.perf_counter()
    aux = synth.token_corpus(rng, AUX_DOCS, dim, vocab=AUX_VOCAB,
                             doc_len=20, paraphrases=15)
    corpus_s = time.perf_counter() - t0
    scale, nn = counted("attack_at_scale", lambda: curves(
        aux, AUX_QUERIES, torch.device("cuda"), rng))
    obs = attacks.perturbed_queries(aux, range(AUX_QUERIES), RADII,
                                    np.random.default_rng(args.seed + 6))
    q_aux = torch.from_numpy(synth.unit(obs).astype(np.float32)).cuda()
    timed_rows.append(score_topk_row(torch, q_aux, nn.embeddings, 1))
    out["at_scale"] = dict(docs=AUX_DOCS, vocab=AUX_VOCAB,
                           queries=AUX_QUERIES, corpus_s=corpus_s,
                           ridge_y_gb=AUX_DOCS * AUX_VOCAB * 4 / 1e9, **scale)
    return out, paths, timed_rows


def lm_path(name: str, counts: dict) -> dict:
    """The LM paths, serving and training, run none of our kernels
    (``LM_KERNELS`` is empty): fail if any launched in ``counts`` (one
    run, counts set to 0 just before it)."""
    path_launches(name, counts, LM_KERNELS)
    check(not any(counts.values()),
          f"{name}: kernels launched on the LM path: {counts}")
    return counts


def routing_hooks(model, record: list) -> list:
    """Forward hooks on every layer's MoE: each call appends (top-k expert
    ids (B, S, K), k-th/(k+1)-th router-logit gap (B, S)), on the host.
    Returns the hook handles."""
    from repro_torch.models import moe as moe_lib

    def hook(mod, inputs, _out):
        _, values, ids = moe_lib.route(mod, inputs[0], mod.spec)
        k = mod.spec.top_k
        record.append((ids[..., :k].cpu(),
                       (values[..., k - 1] - values[..., k]).cpu()))

    return [blk.moe.register_forward_hook(hook) for blk in model.layers]


def greedy(logits, vocab: int):
    """Argmax over the real vocabulary (padded columns cut off)."""
    return logits[..., :vocab].argmax(dim=-1)


def lm_parity(torch, np, args, cfg) -> tuple:
    """(a) ``cfg`` at LM_PARITY_LAYERS layers in float32: one copy drawn
    from a seeded CPU generator, its state dict loaded on the card;
    LM_PARITY_PROMPTS prompts through ``prefill``, then LM_PARITY_STEPS
    ``decode_step``s on both, each fed the CPU's greedy tokens.  Routing
    ids must agree wherever a token's k-th/(k+1)-th router-logit gap
    exceeds LM_GAP on both devices; logits within LM_ATOL on sequences
    with no token below that gap.  Returns (dict, [(path, launches,
    shapes)])."""
    import dataclasses

    from repro_torch.kernels import ext
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(cfg, n_layers=LM_PARITY_LAYERS,
                              dtype="float32")
    t0 = time.perf_counter()
    cpu = Transformer(cfg, generator=torch.Generator().manual_seed(args.seed),
                      device="cpu")
    init_s = time.perf_counter() - t0
    card = Transformer(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = np.random.default_rng(args.seed + 7).integers(
        0, cfg.vocab, size=(LM_PARITY_PROMPTS, LM_PARITY_LEN))
    max_len = LM_PARITY_LEN + LM_PARITY_STEPS

    def run(model, feed):
        """[logits (B, S, V) of prefill, then (B, 1, V) a step], the
        routing record, and the greedy tokens (taken from the logits when
        ``feed`` is None, else ``feed``)."""
        record: list = []
        hooks = routing_hooks(model, record)
        try:
            logits, cache = model.prefill(tokens, max_len=max_len)
            outs, fed = [logits.cpu()], []
            for step in range(LM_PARITY_STEPS):
                nxt = (greedy(outs[-1][:, -1], cfg.vocab) if feed is None
                       else feed[step])
                fed.append(nxt)
                lg, cache = model.decode_step(nxt[:, None], cache)
                outs.append(lg[:, None].cpu())
        finally:
            for h in hooks:
                h.remove()
        return outs, record, fed

    t0 = time.perf_counter()
    want, rec_cpu, fed = run(cpu, None)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    got, rec_card, _ = run(card, fed)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    paths = [("lm_parity", lm_path("lm_parity", ext.launch_counts()),
              shape_counts(ext.launch_shapes()))]
    check(len(rec_cpu) == len(rec_card) == cfg.n_layers * (
        1 + LM_PARITY_STEPS), "lm parity: MoE calls differ")
    excluded = torch.zeros(LM_PARITY_PROMPTS, dtype=torch.bool)
    id_mismatch = near = 0
    for (ids_a, gap_a), (ids_b, gap_b) in zip(rec_cpu, rec_card):
        clear = torch.minimum(gap_a, gap_b) > LM_GAP           # (B, S)
        near += int((~clear).sum())
        excluded |= (~clear).any(dim=1)
        id_mismatch += int(((ids_a != ids_b).any(-1) & clear).sum())
    check(id_mismatch == 0, f"lm parity: {id_mismatch} tokens routed to "
                            f"other experts on the card, gaps > {LM_GAP}")
    kept = ~excluded
    check(bool(kept.any()), f"lm parity: every sequence holds a router gap "
                            f"below {LM_GAP}; nothing left to compare")
    errs = [float((g - w).abs().amax(dim=(1, 2))[kept].max())
            for g, w in zip(got, want)]
    err_all = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(max(errs) <= LM_ATOL, f"lm parity: logits off the CPU's by "
                                f"{max(errs)} > {LM_ATOL}")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "lm parity: non-finite logits on the card")
    out = dict(layers=cfg.n_layers, dtype=cfg.dtype,
               prompts=LM_PARITY_PROMPTS, prompt_len=LM_PARITY_LEN,
               decode_steps=LM_PARITY_STEPS, init_cpu_s=init_s,
               cpu_s=cpu_s, card_s=card_s, gap=LM_GAP,
               near_tie_tokens=near,
               sequences_excluded=int(excluded.sum()),
               max_abs_err=max(errs), max_abs_err_all_sequences=err_all,
               atol=LM_ATOL)
    del cpu, card
    return out, paths


def lm_flops(cfg, b: int, s: int) -> tuple:
    """(bf16 FLOP, float32 FLOP) of a prefill of (b, s) tokens as the
    reference computes it: the q/k/v/o projections, the router, the
    experts over their capacity-padded slots (b x E x C, three products
    each), the unembedding (bf16); the full s x s attention scores and
    weighted values (float32 in the port's online softmax)."""
    spec, moe = cfg.attn_spec, cfg.moe_spec
    hq = spec.padded_heads * spec.d_head
    hkv = spec.padded_kv_heads * spec.d_head
    t = b * s
    slots = b * moe.padded_experts * moe.capacity(s)
    per_layer = (2 * t * cfg.d_model * (2 * hq + 2 * hkv)
                 + 2 * t * cfg.d_model * moe.padded_experts
                 + slots * 3 * 2 * cfg.d_model * moe.d_ff)
    bf16 = cfg.n_layers * per_layer + 2 * t * cfg.d_model * cfg.padded_vocab
    f32 = cfg.n_layers * 2 * 2 * b * s * s * hq
    return bf16, f32


def lm_serve(torch, np, args, cfg) -> tuple:
    """(b) ``cfg`` at LM_LAYERS layers in bfloat16 drawn on the card from a
    seeded CUDA generator; LM_PROMPTS x LM_PROMPT_LEN seeded prompts
    through ``prefill`` twice (bit-identical logits) and once more with
    routing hooks (the share of (token, expert) pairs dropped to
    capacity); then LM_STEPS greedy ``decode_step``s, once timed step by
    step and once profiled, from copies of the prefill's cache.  Returns
    (dict, [(path, launches, shapes)])."""
    import dataclasses

    from repro_torch.kernels import ext
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(cfg, n_layers=LM_LAYERS)
    b, s = LM_PROMPTS, LM_PROMPT_LEN
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Transformer(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = sum(p.numel() for p in model.parameters())
    tokens = torch.from_numpy(np.random.default_rng(args.seed + 8).integers(
        0, cfg.vocab, size=(b, s))).to(model.device)
    paths = []

    def prefill():
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = model.prefill(tokens, max_len=LM_MAX_LEN)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    ext.reset_launches()
    (logits, cache), cold_ms = prefill()
    (again, _), prefill_ms = prefill()
    paths.append(("lm_prefill", lm_path("lm_prefill", ext.launch_counts()),
                  shape_counts(ext.launch_shapes())))
    check(bool(torch.isfinite(logits).all()), "lm: non-finite prefill logits")
    check(torch.equal(logits, again), "lm: two identical prefills differ")
    last = logits[:, -1].clone()
    del logits, again
    record: list = []
    hooks = routing_hooks(model, record)
    try:
        model.prefill(tokens, max_len=LM_MAX_LEN)
    finally:
        for h in hooks:
            h.remove()
    moe = cfg.moe_spec
    cap = moe.capacity(s)
    # per layer (one MoE call each): pairs past their expert's capacity in
    # their row, and the experts a row routes to at all
    by_layer, used = [], []
    for ids, _ in record:
        counts = torch.nn.functional.one_hot(
            ids.reshape(b, -1), moe.padded_experts).sum(dim=1)
        by_layer.append(int(torch.clamp(counts - cap, min=0).sum()))
        used.append(float((counts > 0).sum(dim=1).float().mean()))
    dropped = sum(by_layer)
    pairs = cfg.n_layers * b * s * moe.top_k

    def decode():
        """(greedy ids (B, LM_STEPS), ms a step): each step waits for its
        token, as a server streaming it would."""
        c = {"k": cache["k"].clone(), "v": cache["v"].clone(),
             "len": cache["len"]}
        nxt = greedy(last, cfg.vocab)
        ids, finite, step_ms = [], [], []
        torch.cuda.synchronize()
        for _ in range(LM_STEPS):
            t = time.perf_counter()
            lg, c = model.decode_step(nxt[:, None], c)
            nxt = greedy(lg, cfg.vocab)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            ids.append(nxt)
            finite.append(torch.isfinite(lg).all())
        check(bool(torch.stack(finite).all()), "lm: non-finite decode logits")
        return torch.stack(ids, dim=1), step_ms

    ext.reset_launches()
    decoded, step_ms = decode()
    paths.append(("lm_decode", lm_path("lm_decode", ext.launch_counts()),
                  shape_counts(ext.launch_shapes())))
    wall_ms = sum(step_ms)
    (decoded_again, _), prof = profiled(torch, decode, wall_ms)
    check(bool((decoded < cfg.vocab).all()), "lm: decoded id past the vocab")
    check(torch.equal(decoded, decoded_again),
          "lm: two identical decode runs differ")

    bf16, f32 = lm_flops(cfg, b, s)
    nbytes = params * 2
    prefill_bound = max(nbytes / HBM_BYTES_S,
                        bf16 / BF16_OPS_S + f32 / FP32_OPS_S) * 1e3
    # a decode step reads every weight but the embedding table (the
    # einsum formulation runs every expert) and the KV cache up to its
    # length, and writes one position of it
    spec = cfg.attn_spec
    kv_row = 2 * cfg.n_layers * b * spec.padded_kv_heads * spec.d_head * 2
    mean_len = s + (LM_STEPS + 1) / 2
    step_bytes = (params - cfg.padded_vocab * cfg.d_model) * 2 + \
        kv_row * (mean_len + 1)
    q = statistics.quantiles(step_ms, n=100)
    out = dict(
        arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, tp=cfg.tp,
        experts=moe.padded_experts, top_k=moe.top_k, vocab=cfg.vocab,
        padded_vocab=cfg.padded_vocab, params=params,
        weights_gb=nbytes / 1e9, init_s=init_s, prompts=b, prompt_len=s,
        max_len=LM_MAX_LEN, prefill_cold_ms=cold_ms, prefill_ms=prefill_ms,
        prefill_tflop_bf16=bf16 / 1e12, prefill_tflop_f32=f32 / 1e12,
        prefill_bound_ms=prefill_bound,
        prefill_bound_all_bf16_ms=(bf16 + f32) / BF16_OPS_S * 1e3,
        prefill_bit_identical=True, capacity=cap,
        dropped_pairs=dropped, pairs=pairs, dropped_share=dropped / pairs,
        dropped_share_by_layer=[d / (pairs / cfg.n_layers)
                                for d in by_layer],
        experts_used_per_row_by_layer=used,
        decode_steps=LM_STEPS, decode_ms_median=statistics.median(step_ms),
        decode_ms_p90=q[89], decode_ms_p99=q[98],
        decode_ms_first=step_ms[0], decode_wall_ms=wall_ms,
        decode_tokens_s=b * LM_STEPS / (wall_ms / 1e3),
        decode_step_gb=step_bytes / 1e9,
        decode_bound_ms=step_bytes / HBM_BYTES_S * 1e3,
        decode_profile=prof)
    del model, cache
    return out, paths


def lm_phase(torch, np, args) -> tuple:
    """The MoE LM path (``LM_ARCH`` at every published width, tp = 1):
    (a) `lm_parity`, (b) `lm_serve`.  Returns (phase dict, [(path,
    launches, shapes)])."""
    import dataclasses

    from repro_torch.configs import registry

    cfg = dataclasses.replace(registry.get(LM_ARCH).config, tp=1)
    parity, paths = lm_parity(torch, np, args, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    serve, serve_paths = lm_serve(torch, np, args, cfg)
    return dict(parity=parity, serve=serve), paths + serve_paths


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| in float64, on ``got``'s device."""
    want = want.to(got.device).double()
    den = float(want.norm())
    return float((got.double() - want).norm()) / den if den else \
        float(got.double().norm())


def train_parity(torch, np, args, cfg) -> tuple:
    """(a) ``cfg`` at TRAIN_PARITY_LAYERS layers in float32 (TF32 off): one
    set of weights drawn from a seeded CPU generator and loaded on the
    card; one 1 x TRAIN_PARITY_SEQ `LmSyntheticTask` batch through the loss
    and its gradients on both, then TRAIN_PARITY_APPLY AdamW ``apply``s of
    those gradients on each.  Loss within TRAIN_LOSS_RTOL relative, every
    gradient within TRAIN_GRAD_RTOL and every master within
    TRAIN_MASTER_RTOL of the CPU's, normwise.  Returns (dict, [(path,
    launches, shapes)])."""
    import dataclasses

    from repro_torch.data.pipeline import LmSyntheticTask
    from repro_torch.kernels import ext
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer

    cfg = dataclasses.replace(cfg, n_layers=TRAIN_PARITY_LAYERS,
                              dtype="float32")
    t0 = time.perf_counter()
    cpu = Transformer(cfg, generator=torch.Generator().manual_seed(args.seed),
                      device="cpu")
    init_s = time.perf_counter() - t0
    card = Transformer(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    card.load_state_dict(cpu.state_dict())
    batch = LmSyntheticTask(vocab=cfg.vocab, seq_len=TRAIN_PARITY_SEQ,
                            global_batch=1, seed=args.seed).batch(0)
    ocfg = opt_lib.AdamWConfig()

    def run(model):
        """(loss, grads, state after the applies, seconds)."""
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        tokens, targets = (torch.from_numpy(b).to(model.device)
                           for b in batch)
        t = time.perf_counter()
        loss, grads = trainer.value_and_grad(
            lambda p, x, y: model.loss(x, y), params, (tokens, targets))
        state = opt_lib.init(params, ocfg)
        for _ in range(TRAIN_PARITY_APPLY):
            _, state, _ = opt_lib.apply(grads, state, ocfg, params=params)
        float(loss)                                   # waits for the device
        return loss, grads, state, time.perf_counter() - t

    want_loss, want_grads, want_state, cpu_s = run(cpu)
    torch.cuda.synchronize()
    ext.reset_launches()
    loss, grads, state, card_s = run(card)
    torch.cuda.synchronize()
    paths = [("train_parity", lm_path("train_parity", ext.launch_counts()),
              shape_counts(ext.launch_shapes()))]
    loss_err = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    check(loss_err <= TRAIN_LOSS_RTOL, f"train parity: loss off the CPU's by "
                                       f"{loss_err} > {TRAIN_LOSS_RTOL}")
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "train parity: non-finite gradients on the card")
    grad_errs = {k: rel_err(g, want_grads[k]) for k, g in grads.items()}
    worst = max(grad_errs, key=grad_errs.get)
    check(grad_errs[worst] <= TRAIN_GRAD_RTOL,
          f"train parity: gradient {worst} off the CPU's by "
          f"{grad_errs[worst]} > {TRAIN_GRAD_RTOL}")
    master_errs = {k: rel_err(m, want_state.master[k])
                   for k, m in state.master.items()}
    worst_m = max(master_errs, key=master_errs.get)
    check(master_errs[worst_m] <= TRAIN_MASTER_RTOL,
          f"train parity: master {worst_m} off the CPU's by "
          f"{master_errs[worst_m]} > {TRAIN_MASTER_RTOL}")
    check(int(state.step) == TRAIN_PARITY_APPLY, "train parity: step count")
    out = dict(layers=cfg.n_layers, dtype=cfg.dtype, batch=1,
               seq=TRAIN_PARITY_SEQ,
               params=sum(p.numel() for p in card.parameters()),
               init_cpu_s=init_s, cpu_s=cpu_s, card_s=card_s,
               loss=float(loss), loss_cpu=float(want_loss),
               loss_rel_err=loss_err, grad_max_rel_err=grad_errs[worst],
               grad_worst=worst, applies=TRAIN_PARITY_APPLY,
               master_max_rel_err=master_errs[worst_m],
               master_worst=worst_m, loss_rtol=TRAIN_LOSS_RTOL,
               grad_rtol=TRAIN_GRAD_RTOL, master_rtol=TRAIN_MASTER_RTOL)
    del cpu, card, grads, want_grads, state, want_state
    return out, paths


def train_flops(cfg, b: int, s: int) -> tuple:
    """(bf16 FLOP, float32 FLOP) of one training step over b sequences of
    s tokens, forward and backward, as the work needs it: 6·N·T for the
    matrix products (N: the q/k/v/o and SwiGLU weights of every layer and
    the unembedding over the real vocabulary; the embedding is a lookup),
    and 3x the causal attention's forward (scores and weighted values over
    the s·(s+1)/2 query-key pairs, float32 in the port's online softmax).
    Remat's recomputed forward is not counted."""
    spec = cfg.attn_spec
    hq = spec.padded_heads * spec.d_head
    hkv = spec.padded_kv_heads * spec.d_head
    n = cfg.n_layers * (cfg.d_model * (2 * hq + 2 * hkv)
                        + 3 * cfg.d_model * cfg.d_ff) + cfg.d_model * cfg.vocab
    bf16 = 6 * n * b * s
    f32 = 3 * cfg.n_layers * b * 2 * 2 * (s * (s + 1) // 2) * hq
    return bf16, f32, n


def train_run(torch, np, args, cfg) -> tuple:
    """(b) ``cfg`` at TRAIN_LAYERS layers, bf16 parameters with fp32
    master, m and v, remat on, drawn on the card from a seeded CUDA
    generator: `make_lm_run` with TRAIN_BATCH x TRAIN_SEQ tokens in
    TRAIN_MICRO microbatches; one warm-up step, TRAIN_STEPS timed steps,
    one profiled step.  Runs with the default (non-deterministic)
    algorithms.  Returns (dict, [(path, launches, shapes)])."""
    import dataclasses

    from repro_torch.kernels import ext
    from repro_torch.launch.train import make_lm_run

    cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.tp == 1,
          f"train run: config {cfg}")
    steps = 1 + TRAIN_STEPS + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_fn, batches_fn, state = make_lm_run(
        cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=3e-4, steps=steps,
        microbatches=TRAIN_MICRO, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = sum(p.numel() for p in state[0].values())
    state_gb = torch.cuda.memory_allocated() / 1e9
    history, step_ms = [], []

    def step(i):
        nonlocal state
        batch = batches_fn(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step_fn(state, batch)       # ends reading the loss
        torch.cuda.synchronize()
        history.append(m)
        return (time.perf_counter() - t) * 1e3

    ext.reset_launches()
    warm_ms = step(0)
    step_ms = [step(1 + i) for i in range(TRAIN_STEPS)]
    paths = [("train_step", lm_path("train_step", ext.launch_counts()),
              shape_counts(ext.launch_shapes()))]
    median = statistics.median(step_ms)
    _, prof = profiled(torch, lambda: step(1 + TRAIN_STEPS), median, top=12)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in history), f"train run: non-finite loss or grad "
                                 f"norm: {history}")
    bf16, f32, n_matmul = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    bound_ms = (bf16 / BF16_OPS_S + f32 / FP32_OPS_S) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = dict(
        arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, tp=cfg.tp,
        remat=cfg.remat, params=params, matmul_params=n_matmul,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=TRAIN_MICRO,
        deterministic=False, init_s=init_s, state_gb=state_gb,
        warmup_ms=warm_ms, step_ms=step_ms, step_ms_median=median,
        step_ms_max=max(step_ms), tokens_s=tokens / (median / 1e3),
        tflop_bf16=bf16 / 1e12, tflop_f32_attention=f32 / 1e12,
        bound_ms=bound_ms, bound_by="operations",
        bound_share=bound_ms / median,
        losses=[h["loss"] for h in history],
        grad_norms=[h["grad_norm"] for h in history],
        lrs=[h["lr"] for h in history], step_profile=prof,
        device_peak_gb=peak_gb)
    del state, step_fn
    return out, paths


def train_drill(torch, np, args) -> tuple:
    """(c) The fault drill on the card: ``examples/train_lm.py``'s
    config_100m, DRILL_STEPS steps of DRILL_BATCH x DRILL_SEQ with a
    checkpoint every DRILL_EVERY, straight through, and again through the
    example's `drill` (a failure injected at DRILL_FAIL, a restart from
    the newest checkpoint), each into its own temporary directory, under
    ``torch.use_deterministic_algorithms``.  The resumed history and
    final state must equal the uninterrupted run's bit for bit, and the
    last loss lie below the first.  Returns (dict, [(path, launches,
    shapes)])."""
    import tempfile

    from repro_torch.examples import train_lm
    from repro_torch.kernels import ext
    from repro_torch.launch.train import make_lm_run
    from repro_torch.train import fault

    cfg = train_lm.config_100m()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            ext.reset_launches()
            t0 = time.perf_counter()
            step_fn, batches_fn, state = make_lm_run(
                cfg, batch=DRILL_BATCH, seq=DRILL_SEQ, lr=3e-3,
                steps=DRILL_STEPS, device="cuda", seed=0)
            run = fault.ResumableRun(os.path.join(tmp, "straight"),
                                     checkpoint_every=DRILL_EVERY)
            straight, done_a, hist_a = run.run(step_fn, state, batches_fn,
                                               DRILL_STEPS)
            torch.cuda.synchronize()
            straight_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            resumed, done_b, hist_b, monitor = train_lm.drill(
                cfg, steps=DRILL_STEPS, batch=DRILL_BATCH, seq=DRILL_SEQ,
                ckpt_dir=os.path.join(tmp, "drill"), ckpt_every=DRILL_EVERY,
                fail_at=DRILL_FAIL, device="cuda")
            torch.cuda.synchronize()
            drill_s = time.perf_counter() - t0
            counts = ext.launch_counts()
            shapes = shape_counts(ext.launch_shapes())
    finally:
        torch.use_deterministic_algorithms(was)
    paths = [("train_drill", lm_path("train_drill", counts), shapes)]
    check(done_a == DRILL_STEPS and done_b == DRILL_STEPS - DRILL_FAIL,
          f"train drill: ran {done_a} and {done_b} steps")
    keys = ("loss", "grad_norm", "lr")
    check([[h[k] for k in keys] for h in hist_b]
          == [[h[k] for k in keys] for h in hist_a[DRILL_FAIL:]],
          "train drill: the resumed history differs from the uninterrupted "
          "run's")
    same = all(torch.equal(a, b) for a, b in zip(
        checkpoint_leaves(straight), checkpoint_leaves(resumed)))
    check(same, "train drill: the resumed state differs from the "
                "uninterrupted run's")
    first, last = hist_a[0]["loss"], hist_b[-1]["loss"]
    check(math.isfinite(last) and last < first,
          f"train drill: loss {first} -> {last} did not decrease")
    out = dict(arch=cfg.name, params=cfg.param_count(), steps=DRILL_STEPS,
               checkpoint_every=DRILL_EVERY, fail_at=DRILL_FAIL,
               batch=DRILL_BATCH, seq=DRILL_SEQ, deterministic=True,
               resumed_steps=done_b, bit_identical=True, loss_first=first,
               loss_last=last, straight_s=straight_s, drill_s=drill_s,
               stragglers=len(monitor.straggler_steps))
    del straight, resumed, step_fn, state
    return out, paths


def checkpoint_leaves(state) -> list:
    """A training state's tensors in checkpoint order."""
    from repro_torch.train import checkpoint

    return [t for _, t in checkpoint._flatten(state)]


def train_phase(torch, np, args) -> tuple:
    """The training path (``TRAIN_ARCH`` at every published width, tp = 1,
    depth cut): (a) `train_parity`, (b) `train_run`, (c) `train_drill`.
    Returns (phase dict, [(path, launches, shapes)])."""
    import dataclasses

    from repro_torch.configs import registry

    cfg = dataclasses.replace(registry.get(TRAIN_ARCH).config, tp=1)
    out, paths = {}, []
    for name, fn in (("parity", lambda: train_parity(torch, np, args, cfg)),
                     ("run", lambda: train_run(torch, np, args, cfg)),
                     ("drill", lambda: train_drill(torch, np, args))):
        t0 = time.perf_counter()
        part, part_paths = fn()
        out[name] = dict(part, part_s=time.perf_counter() - t0)
        paths += part_paths
        gc.collect()
        torch.cuda.empty_cache()
    return out, paths


# -- mesh phase ---------------------------------------------------------------

def mesh_dir() -> Path:
    """Scratch files of the mesh phase (under the checkout's gitignored
    build directory; removed when the phase ends)."""
    return ROOT / "build" / "mesh_phase"


def mesh_users(np, params, plan, dim: int, n_docs: int, seed: int) -> list:
    from repro_torch.core import protocol

    return [protocol.RemoteRagUser(
        n=dim, N=n_docs, k=plan.k, plan=plan, rlwe_params=params,
        rng=np.random.default_rng(seed + 100 + t)) for t in range(TENANTS)]


def mesh_round(torch, np, index, docs, queries, plan, params,
               seed: int, gen_seed: int) -> dict:
    """REQUESTS requests of TENANTS tenants through ``run_remoterag``, then
    the same requests as one batch (perturb_batch -> topk_batch ->
    encrypted_scores_cached_batch -> decrypt_scores_batch); the DistanceDP
    generators (on the card) seeded from ``gen_seed``.  Returns the ids,
    wire bytes, the batch's candidates and decrypted scores (host)."""
    from repro_torch.core import protocol
    from repro_torch.serve import batching

    cloud = protocol.RemoteRagCloud(index, rlwe_params=params)
    gens = lambda: [torch.Generator(device="cuda").manual_seed(gen_seed + j)
                    for j in range(len(queries))]
    out = {}
    users = mesh_users(np, params, plan, index.dim, index.num_rows, seed)
    for j, g in enumerate(gens()):
        got, ids, tr = protocol.run_remoterag(users[j % TENANTS], cloud,
                                              queries[j], g)
        check(got == [docs[int(i)] for i in ids],
              f"mesh round request {j}: documents do not match ids")
        out[f"ids{j}"] = np.asarray(ids)
        out[f"bytes{j}"] = np.array([tr.request_bytes, tr.reply_bytes,
                                     tr.fetch_bytes, tr.docs_bytes,
                                     tr.total_bytes])
    users = mesh_users(np, params, plan, index.dim, index.num_rows, seed)
    lanes = [users[j % TENANTS] for j in range(len(queries))]
    pert = batching.perturb_batch(gens(), queries,
                                  [plan.eps] * len(queries))
    res = batching.topk_batch(index, pert, plan.kprime)
    enc = [u.encrypt_query(e) for u, e in zip(lanes, queries)]
    sc = batching.encrypted_scores_cached_batch(
        params, enc, cloud.candidate_cache, res.indices)
    out["batch_ids"] = res.indices.cpu().numpy()
    out["batch_scores"] = np.stack(batching.decrypt_scores_batch(
        [u.sk for u in lanes], sc))
    torch.cuda.synchronize()
    return out


def moe_layer_spec(mesh=None):
    """The MoE layer of LM_ARCH at its published width, tp = 1; over
    ``mesh``: tokens over "data", experts over "model" (shard_a2a)."""
    import dataclasses

    from repro_torch.configs import registry

    spec = dataclasses.replace(registry.get(LM_ARCH).config, tp=1).moe_spec
    if mesh is None:
        return spec
    return dataclasses.replace(spec, batch_axes=("data",), ep_axis="model",
                               impl="shard_a2a", mesh=mesh)


def moe_inputs(torch, spec, seed: int) -> tuple:
    """(layer, tokens (MESH_MOE_BATCH, MESH_MOE_SEQ, d)) drawn on the card
    from seeded CUDA generators: the same bits in every process."""
    from repro_torch.models import moe as moe_lib

    gen = torch.Generator(device="cuda").manual_seed(seed)
    layer = moe_lib.Moe(spec, gen, gen.device)
    gen.manual_seed(seed + 1)
    x = torch.randn((MESH_MOE_BATCH, MESH_MOE_SEQ, spec.d_model),
                    generator=gen, device=gen.device)
    return layer, x


def walls_ms(torch, fn, reps: int, barrier=None, warmup: int = 1) -> list:
    """Host walls of ``reps`` calls of ``fn`` after ``warmup`` untimed
    ones, each between two synchronizes (after ``barrier``, when given, so
    co-located ranks start together)."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        if barrier is not None:
            barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def mesh_rank(rank: int, workdir: str, cfg: dict) -> None:
    """One of the MESH_WORLD co-located ranks of the mesh phase (b): gloo
    on CUDA tensors of ``cuda:0``, mesh MESH_SHAPE.  Writes its results to
    ``workdir``/rank{rank}.json and .npz."""
    import numpy as np
    import torch

    from repro_torch.kernels import ext
    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wd = Path(workdir)
    info, arrays = {"rank": rank}, {}
    t0 = time.perf_counter()
    ext.extension()                     # the parent's build, loaded
    info["load_s"] = time.perf_counter() - t0
    info["so_mtime"] = so_mtime()
    # this process's own peaks (ru_maxrss would carry the parent's across
    # the spawn's exec)
    with Peaks(torch) as peaks:
        mesh_lib.init_ranks("gloo", store_path=wd / "store4", rank=rank,
                            world_size=MESH_WORLD, timeout_s=600)
        try:
            mesh_rank_paths(torch, np, wd, cfg, rank, info, arrays)
        finally:
            mesh_lib.shutdown()
    info["memory"] = dict(peaks.result, device_peak_gb=max(
        peaks.result["device_peak_gb"], info.get("device_peak_gb", 0.0)))
    np.savez(wd / f"rank{rank}.npz", **arrays)
    (wd / f"rank{rank}.json").write_text(json.dumps(info))


def mesh_rank_paths(torch, np, wd: Path, cfg: dict, rank: int, info: dict,
                    arrays: dict) -> None:
    """A mesh rank's paths (see `mesh_rank`): results into ``info`` (JSON)
    and ``arrays`` (host arrays)."""
    import torch.distributed as dist

    from repro_torch.core import planner
    from repro_torch.data import synth
    from repro_torch.kernels import ext
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.mesh import ShardSpec
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.retrieval.topk import distributed_topk

    mesh = mesh_lib.make_mesh(MESH_SHAPE, MESH_AXES, device="cuda",
                              backend="gloo")
    comms = mesh.repro_comms
    barrier = dist.barrier

    def path(name, fn):
        """Run ``fn`` with the launch counts set to 0 just before it and
        read just after; host copies counted beside."""
        copies = comms.host_copies, comms.host_bytes
        torch.cuda.synchronize()
        barrier()
        ext.reset_launches()
        t_start = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        info[name] = dict(
            wall_ms=(time.perf_counter() - t_start) * 1e3,
            launches=ext.launch_counts(),
            shapes=shape_counts(ext.launch_shapes()),
            host_copies=comms.host_copies - copies[0],
            host_bytes=comms.host_bytes - copies[1])
        # items reset the allocator's peak; the rank's peak is the largest
        info["device_peak_gb"] = max(info.get("device_peak_gb", 0.0),
                                     torch.cuda.max_memory_allocated() / 1e9)
        return r

    # -- first stage: 10^6 x 768 over both axes -----------------------
    emb = np.load(wd / "corpus.npy", mmap_mode="r")
    index = FlatIndex.build(emb, mesh=mesh, normalize=False)
    del emb
    info["first_rows"] = [index.num_rows, index.embeddings.shape[0]]
    q = torch.from_numpy(np.load(wd / "queries.npy")).cuda()
    res = path("first_stage", lambda: distributed_topk(
        index, q, cfg["kprime"]))
    arrays["first_v"] = res.values.cpu().numpy()
    arrays["first_i"] = res.indices.cpu().numpy()
    payload = torch.zeros((q.shape[0], 2 * cfg["kprime"] + 1),
                          device=q.device)
    info["all_gather_ms"] = walls_ms(
        torch, lambda: mesh_lib.all_gather(payload, mesh, MESH_AXES), 10,
        barrier)
    del index
    torch.cuda.empty_cache()

    # -- the round over a 2^17-doc mesh index ---------------------------
    n_docs, dim = cfg["round_docs"], cfg["dim"]
    corpus = synth.uniform_corpus(np.random.default_rng(cfg["seed"] + 7),
                                  n_docs, dim)
    queries = synth.queries_near_corpus(
        np.random.default_rng(cfg["seed"] + 8), corpus, REQUESTS)
    docs = [f"passage-{i}".encode() for i in range(n_docs)]
    index = FlatIndex.build(corpus, documents=docs, mesh=mesh)
    del corpus
    plan = planner.plan(n=dim, N=n_docs, k=cfg["k"], kprime=cfg["knob"])
    params = cfg["rlwe"]
    t0 = time.perf_counter()
    index.candidate_cache(params)   # gathered rows, the whole dense cache
    torch.cuda.synchronize()
    info["round_cache_s"] = time.perf_counter() - t0
    # each rank draws its own perturbation; rank 0's is searched
    got = path("round", lambda: mesh_round(
        torch, np, index, docs, queries, plan, params, cfg["seed"],
        cfg["gen_seed"] + 1000 * rank))
    arrays.update({f"round_{k}": v for k, v in got.items()})
    mesh_serving(torch, np, index, docs, queries, cfg, rank, info, arrays,
                 path)
    del index
    gc.collect()
    torch.cuda.empty_cache()

    # -- the MoE layer at Qwen3-30B-A3B's width --------------------------
    spec = moe_layer_spec(mesh)
    layer, x = moe_inputs(torch, spec, cfg["seed"])
    experts = {"router": ShardSpec.of(None, None),
               **{w: ShardSpec.of("model")
                  for w in ("w_gate", "w_up", "w_down")}}
    transformer.shard_params(layer, mesh, experts)
    b_loc = x.shape[0] // mesh_lib.axes_size(mesh, ("data",))
    pos = mesh_lib.axes_position(mesh, ("data",))
    x = x[pos * b_loc:(pos + 1) * b_loc].contiguous()
    info["moe_experts_local"] = layer.w_gate.shape[0]
    with torch.no_grad():
        o, aux = path("moe_f32", lambda: moe_lib.moe_fwd(layer, x, spec))
        arrays["moe_o"] = o.cpu().numpy()
        arrays["moe_aux"] = aux.cpu().numpy()
        layer.to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        info["moe_bf16_ms"] = walls_ms(
            torch, lambda: moe_lib.moe_fwd(layer, xb, spec),
            MESH_MOE_REPS, barrier)
        part = torch.zeros_like(xb)
        info["all_reduce_ms"] = walls_ms(
            torch, lambda: mesh_lib.all_reduce(part, mesh, ("model",)),
            MESH_MOE_REPS, barrier)
    info["host_copies"] = comms.host_copies
    info["host_bytes"] = comms.host_bytes
    del layer, x, xb, part
    gc.collect()
    torch.cuda.empty_cache()
    mesh_gpipe(torch, np, cfg, rank, info, path, barrier)
    mesh_reshard(torch, np, wd, rank, info, path)


def reset_peak(torch, info: dict) -> None:
    """Fold the allocator's peak so far into ``info["device_peak_gb"]``
    (the rank's peak), then reset it for the next item's own peak."""
    info["device_peak_gb"] = max(info.get("device_peak_gb", 0.0),
                                 torch.cuda.max_memory_allocated() / 1e9)
    torch.cuda.reset_peak_memory_stats()


class ScoreLog:
    """Records the decrypted scores of every finished lane, in finishing
    order (a patch on ``RemoteRagUser.positions_from_scores`` while in
    the ``with`` block)."""

    def __enter__(self) -> "ScoreLog":
        import numpy as np

        from repro_torch.core import protocol

        self.cls = protocol.RemoteRagUser
        self.real = self.cls.positions_from_scores
        self.seen = []
        log = self

        def record(user, scores, n):
            log.seen.append(np.asarray(scores)[:n].copy())
            return log.real(user, scores, n)

        self.cls.positions_from_scores = record
        return self

    def __exit__(self, *exc) -> None:
        self.cls.positions_from_scores = self.real


def open_tenants(srv, dim: int, n_docs: int, k: int, knob: int) -> None:
    for t in range(TENANTS):
        srv.open_session(f"tenant-{t}", n=dim, N=n_docs, k=k,
                         plan_kwargs={"kprime": knob})


def mesh_requests(np, srv, queries, docs, seed: int, *,
                  step: bool = False) -> dict:
    """MESH_REQUESTS requests of TENANTS tenants (keys from ``seed``)
    through ``srv``, drained (with ``step``: one ``step()`` after every
    submit first).  Every request must succeed with the documents of its
    ids.  Returns host arrays: ids, wire bytes (request, reply, fetch,
    docs, total), batch sizes, request ids and, for an engine, the
    decrypted scores in finishing order."""
    res = []
    with ScoreLog() as log:
        for j in range(MESH_REQUESTS):
            srv.submit(f"tenant-{j % TENANTS}", queries[j % len(queries)],
                       key=seed * 1000 + j)
            if step:
                res += srv.step()
        res += srv.drain()
    res.sort(key=lambda r: r.request_id)
    check(len(res) == MESH_REQUESTS and all(r.ok for r in res),
          f"mesh serving: {[r.error for r in res if not r.ok]}")
    for r in res:
        check(r.docs == [docs[int(i)] for i in r.ids],
              f"mesh serving: request {r.request_id}'s documents")
    tr = lambda r: r.transcript
    return dict(ids=np.stack([np.asarray(r.ids) for r in res]),
                bytes=np.array([[tr(r).request_bytes, tr(r).reply_bytes,
                                 tr(r).fetch_bytes, tr(r).docs_bytes,
                                 tr(r).total_bytes] for r in res]),
                sizes=np.array([r.batch_size for r in res]),
                rids=np.array([r.request_id for r in res]),
                scores=np.stack(log.seen))


def mesh_serving(torch, np, index, docs, queries, cfg: dict, rank: int,
                 info: dict, arrays: dict, path) -> None:
    """The engine, the router and the row-sharded cache over the round's
    mesh index (see `mesh_phase`); results into ``info`` and ``arrays``."""
    from repro_torch.crypto import rlwe
    from repro_torch.serve import (EngineConfig, ReplicaRouter, RouterConfig,
                                   ServeEngine, SessionManager)

    params, seed = cfg["rlwe"], cfg["seed"]
    open_all = lambda srv: open_tenants(srv, index.dim, index.num_rows,
                                        cfg["k"], cfg["knob"])
    sessions = lambda: SessionManager(rlwe_params=params,
                                      deterministic_seeds=True)

    def engine(clock=time.monotonic, **kw):
        eng = ServeEngine(index, config=EngineConfig(max_batch=8, **kw),
                          sessions=sessions(), clock=clock)
        open_all(eng)
        return eng

    eng = engine()
    got = path("engine_drain", lambda: mesh_requests(np, eng, queries, docs,
                                                     seed))
    eng.close()
    arrays.update({f"engine_drain_{k}": v for k, v in got.items()})
    # a clock that runs at another rate and offset on every rank: the
    # deadline trigger fires at other steps unless the first rank decides
    t_zero = time.monotonic()
    skewed = lambda: (t_zero + (time.monotonic() - t_zero)
                      * (1.0 + 0.5 * rank) + 100.0 * rank)
    eng = engine(clock=skewed, max_wait_s=MESH_WAIT_S)
    got = path("engine_step", lambda: mesh_requests(
        np, eng, queries, docs, seed, step=True))
    eng.close()
    arrays.update({f"engine_step_{k}": v for k, v in got.items()})
    rt = ReplicaRouter(index, config=RouterConfig(
        num_replicas=ROUTER_REPLICAS, engine=EngineConfig(max_batch=8)),
        sessions=sessions())
    open_all(rt)
    got = path("router", lambda: mesh_requests(np, rt, queries, docs, seed))
    info["router_slices"] = rt.summary()["slices"]
    rt.close()
    arrays.update({f"router_{k}": v for k, v in got.items()
                   if k != "scores"})
    shard_docs = index.num_rows // NUM_SHARDS
    shard_bytes = (shard_docs * params.num_chunks(index.dim)
                   * params.num_primes * params.n_poly * 4)
    ccfg = rlwe.CandidateCacheConfig(
        num_shards=NUM_SHARDS, async_admission=False,
        max_resident_bytes=MESH_PIN_SHARDS * shard_bytes)
    eng = engine(cache_config=ccfg)
    reset_peak(torch, info)
    got = path("engine_sharded", lambda: mesh_requests(np, eng, queries,
                                                       docs, seed))
    cache = index.peek_candidate_cache(params, ccfg)
    st = cache.stats()
    info["cache"] = dict(
        placed=cache.placement is not None, shard_docs=shard_docs,
        shard_bytes=shard_bytes, row_bytes=shard_bytes // shard_docs,
        **{k: st[k] for k in ("resident_bytes", "device_resident_bytes",
                              "peak_resident_bytes", "row_parts", "hits",
                              "misses", "admissions", "evictions")},
        resident_shards=len(st["resident_shards"]),
        device_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    eng.close()
    arrays.update({f"engine_sharded_{k}": v for k, v in got.items()})


def gpipe_model(torch, cfg, seed: int):
    """A `Transformer` of ``cfg`` drawn on the card from a seeded CUDA
    generator (the same bits in every process), trainable."""
    from repro_torch.models.transformer import Transformer

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return Transformer(cfg, generator=gen, device="cuda").requires_grad_(True)


def gpipe_tokens(torch, np, vocab: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    t = rng.integers(0, vocab, size=(GPIPE_BATCH, GPIPE_SEQ + 1))
    t = torch.from_numpy(t).cuda()
    return t[:, :-1].contiguous(), t[:, 1:].contiguous()


def mesh_gpipe(torch, np, cfg: dict, rank: int, info: dict, path,
               barrier) -> None:
    """GPipe on TRAIN_ARCH at every published width over MESH_SHAPE named
    GPIPE_AXES (see `mesh_phase`); results into ``info``."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as tf

    mesh = mesh_lib.make_mesh(MESH_SHAPE, GPIPE_AXES, device="cuda",
                              backend="gloo")
    base = dataclasses.replace(registry.get(TRAIN_ARCH).config, tp=1,
                               batch_axes=("data",))
    # -- parity: float32, one layer a stage, against one process ----------
    pcfg = dataclasses.replace(base, n_layers=GPIPE_PARITY_LAYERS,
                               dtype="float32", remat=False)
    model = gpipe_model(torch, pcfg, cfg["seed"])
    tokens, targets = gpipe_tokens(torch, np, pcfg.vocab, cfg["seed"])
    own = tf._stage_range(pcfg, mesh, "pod")
    mine = lambda name: (not name.startswith("layers.")
                         or int(name.split(".")[1]) in own)
    ref = {}
    t0 = time.perf_counter()
    for r in range(MESH_WORLD):         # one rank at a time holds the graph
        barrier()
        if r == rank:
            loss = model.loss(tokens, targets)
            loss.backward()
            loss_ref = float(loss.detach())
            for name, p in model.named_parameters():
                if mine(name):
                    ref[name] = p.grad.cpu()
                p.grad = None
            del loss
            torch.cuda.empty_cache()
    barrier()
    one_s = time.perf_counter() - t0
    tf.pipeline_stage(model, mesh, "pod")
    reset_peak(torch, info)

    def parity():
        loss = tf.pipeline_loss(model, tokens, targets, mesh=mesh,
                                n_micro=GPIPE_MICRO)
        loss.backward()
        return float(loss.detach())

    loss = path("gpipe_parity", parity)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    errs = {}
    for name, p in model.named_parameters():
        if name.startswith("layers."):
            i, rest = name[len("layers."):].split(".", 1)
            name = f"layers.{own[int(i)]}.{rest}"
        want = ref.pop(name).cuda()
        errs[name] = float((p.grad - want).norm() / want.norm())
        del want
    check(not ref, f"gpipe rank {rank}: no gradient for {sorted(ref)[:3]}")
    info["gpipe"] = dict(parity=dict(
        layers=GPIPE_PARITY_LAYERS, loss=loss, loss_one_process=loss_ref,
        loss_rel_err=abs(loss - loss_ref) / abs(loss_ref),
        grad_rel_err_max=max(errs.values()),
        worst=max(errs, key=errs.get), params=len(errs),
        one_process_s=one_s, device_peak_gb=peak_gb))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # -- timed: bf16, two layers a stage, remat ----------------------------
    bcfg = dataclasses.replace(base, n_layers=GPIPE_LAYERS)
    model = tf.pipeline_stage(gpipe_model(torch, bcfg, cfg["seed"]), mesh,
                              "pod")
    comms = mesh.repro_comms
    hops = dict(calls=0, wall_s=0.0, bytes=0, copies=0, copy_bytes=0)
    real_hop = mesh_lib._send_hop

    def timed_hop(t, *a):
        # a rank issues its collectives from one thread at a time, so the
        # host copies made during this call are the hop's own
        c0, b0 = comms.host_copies, comms.host_bytes
        t0 = time.perf_counter()
        out = real_hop(t, *a)
        hops["calls"] += 1
        hops["wall_s"] += time.perf_counter() - t0
        hops["bytes"] += t.numel() * t.element_size()
        hops["copies"] += comms.host_copies - c0
        hops["copy_bytes"] += comms.host_bytes - b0
        return out

    def step():
        loss = tf.pipeline_loss(model, tokens, targets, mesh=mesh,
                                n_micro=GPIPE_MICRO)
        loss.backward()
        for p in model.parameters():
            p.grad = None
        return float(loss.detach())

    copies = comms.host_copies, comms.host_bytes
    mesh_lib._send_hop = timed_hop
    reset_peak(torch, info)
    try:
        walls = path("gpipe_bf16", lambda: walls_ms(
            torch, step, GPIPE_STEPS, barrier, warmup=GPIPE_WARMUP))
    finally:
        mesh_lib._send_hop = real_hop
    n = len(walls) + GPIPE_WARMUP          # every step's hops are counted
    s = mesh_lib.axes_size(mesh, ("pod",))
    info["gpipe"]["bf16"] = dict(
        layers=GPIPE_LAYERS, stages=s, micro=GPIPE_MICRO,
        tokens=GPIPE_BATCH * GPIPE_SEQ, step_ms=walls,
        bubble_share=(s - 1) / (GPIPE_MICRO + s - 1),
        ppermute_calls_per_step=hops["calls"] / n,
        ppermute_ms_per_step=hops["wall_s"] * 1e3 / n,
        ppermute_bytes_per_step=hops["bytes"] / n,
        ppermute_host_copies_per_step=hops["copies"] / n,
        ppermute_host_bytes_per_step=hops["copy_bytes"] / n,
        # the rest: the closing broadcast, the gradient and the loss
        # all-reduces
        all_reduce_host_copies_per_step=(
            comms.host_copies - copies[0] - hops["copies"]) / n,
        all_reduce_host_bytes_per_step=(
            comms.host_bytes - copies[1] - hops["copy_bytes"]) / n,
        device_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def sharded_step(torch, step_fn, full_state, mesh, specs):
    """``step_fn`` of a one-process run as a step over this rank's slices
    under ``specs``: gather them into ``full_state``, step, keep the new
    state's slices (collective).  The drill's stand-in for a sharded
    trainer: the arithmetic is the one-process step's on every mesh."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import checkpoint as ckpt

    by_path = ckpt._spec_paths(specs)

    def run(local, batch):
        with torch.no_grad():
            for (p, full), (_, loc) in zip(ckpt._flatten(full_state),
                                           ckpt._flatten(local)):
                full.copy_(mesh_lib.gather_full(loc, mesh, by_path[p]))
        new, metrics = step_fn(full_state, batch)
        return ckpt.shard_state(new, mesh, specs), metrics

    return run


def mesh_reshard(torch, np, wd: Path, rank: int, info: dict, path) -> None:
    """The re-sharding drill at config_100m (see `mesh_phase`); results
    into ``info``."""
    from repro_torch.examples.train_lm import config_100m
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.train import make_lm_run
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault
    from repro_torch.train import optimizer as opt_lib

    cfg = config_100m()
    a = mesh_lib.make_mesh(MESH_SHAPE, MESH_AXES, device="cuda",
                           backend="gloo")
    b = mesh_lib.make_mesh((MESH_WORLD,), ("data",), device="cuda",
                           backend="gloo")
    specs = lambda axes: (tf.fsdp_param_specs(cfg, axes),
                          opt_lib.state_specs(tf.fsdp_param_specs(cfg, axes)))
    spec_a, spec_b = specs(MESH_AXES), specs(("data",))
    leaves = lambda st: [t for _, t in ckpt._flatten(st)]
    run = lambda: make_lm_run(cfg, batch=DRILL_BATCH, seq=RESHARD_SEQ,
                              lr=3e-3, steps=RESHARD_STEPS, device="cuda",
                              seed=0)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        # two steps in one process; saved on (2, 2), restored on (4,)
        step_fn, batches_fn, full = run()
        for i in range(2):
            full, _ = step_fn(full, batches_fn(i))

        def save_restore():
            ckpt.save(wd / "reshard_ck", 1, ckpt.shard_state(full, a, spec_a),
                      mesh=a, specs=spec_a)
            example = ckpt.shard_state(full, b, spec_b)
            for t in leaves(example):
                t.zero_()
            return ckpt.restore(wd / "reshard_ck", 1, example, mesh=b,
                                specs=spec_b)

        got = path("reshard_restore", save_restore)
        want = ckpt.shard_state(full, b, spec_b)
        restored = all(torch.equal(x, y)
                       for x, y in zip(leaves(got), leaves(want)))
        del full, got, want, step_fn
        # a run sharded on (2, 2) dies; it resumes on (4,)
        rr = fault.ResumableRun(str(wd / "reshard_run"),
                                checkpoint_every=RESHARD_EVERY)
        injector = fault.FailureInjector(fail_at_steps=(RESHARD_FAIL,))

        def drill():
            step_fn, batches_fn, state = run()
            try:
                rr.run(sharded_step(torch, step_fn, state, a, spec_a),
                       ckpt.shard_state(state, a, spec_a), batches_fn,
                       RESHARD_STEPS, injector=injector, mesh=a,
                       state_specs=spec_a)
                died = False
            except fault.InjectedFailure:
                died = True
            del step_fn, state
            step_fn, batches_fn, state = run()
            out = rr.run(sharded_step(torch, step_fn, state, b, spec_b),
                         ckpt.shard_state(state, b, spec_b), batches_fn,
                         RESHARD_STEPS, injector=injector, mesh=b,
                         state_specs=spec_b)
            return died, out

        t0 = time.perf_counter()
        died, (resumed, done, _) = path("reshard_drill", drill)
        drill_s = time.perf_counter() - t0
        step_fn, batches_fn, state = run()
        for i in range(RESHARD_STEPS):
            state, _ = step_fn(state, batches_fn(i))
        same = all(torch.equal(x, y) for x, y in zip(
            leaves(resumed), leaves(ckpt.shard_state(state, b, spec_b))))
    finally:
        torch.use_deterministic_algorithms(was)
    info["reshard"] = dict(
        arch=cfg.name, restored_bit_identical=restored, died=died,
        resumed_steps=done, resumed_bit_identical=same, drill_s=drill_s,
        leaves=len(leaves(resumed)))
    del resumed, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()


MESH_SERVING_PATHS = ("engine_drain", "engine_step", "router",
                      "engine_sharded")
MESH_TRAINING_PATHS = ("gpipe_parity", "gpipe_bf16", "reshard_restore",
                       "reshard_drill")


def mesh_serving_checks(np, infos: list, arrays: list, single: dict) -> tuple:
    """Every rank's engine (drained and stepped), router and row-sharded
    cache runs against the one-process engine; every kernel of the serving
    path launched on every rank.  Returns the (engine, router, cache)
    lines' dicts."""
    sizes0 = arrays[0]["engine_step_sizes"]
    for r, (info, arr) in enumerate(zip(infos, arrays)):
        for run in MESH_SERVING_PATHS:
            for key in ("ids", "bytes", "rids"):
                check(np.array_equal(arr[f"{run}_{key}"], single[key]),
                      f"mesh rank {r} {run}: {key} differ from one process")
            if run != "router":
                check(np.array_equal(arr[f"{run}_scores"], single["scores"]),
                      f"mesh rank {r} {run}: decrypted scores differ from "
                      f"one process")
            path_launches(f"mesh rank {r} {run}", info[run]["launches"])
        check(np.array_equal(arr["engine_step_sizes"], sizes0),
              f"mesh rank {r}: stepped batches differ from the first "
              f"rank's")
        c = info["cache"]
        check(c["placed"] and c["row_parts"] == MESH_WORLD
              and c["resident_shards"] >= 2,
              f"mesh rank {r}: cache placement {c}")
        check(c["device_resident_bytes"] * MESH_WORLD == c["resident_bytes"]
              and c["device_resident_bytes"] <= c["peak_resident_bytes"]
              / MESH_WORLD + c["row_bytes"],
              f"mesh rank {r}: resident bytes {c}")
    med = lambda xs: statistics.median(xs)
    walls = lambda run: [i[run]["wall_ms"] for i in infos]
    engine = dict(requests=MESH_REQUESTS, tenants=TENANTS,
                  equal_to_one_process=True,
                  drain_ms=walls("engine_drain"), step_ms=walls("engine_step"),
                  step_batch_sizes=sorted(collections.Counter(
                      sizes0.tolist()).items()),
                  max_wait_s=MESH_WAIT_S,
                  launches_rank0=infos[0]["engine_drain"]["launches"],
                  host_copies=[i["engine_drain"]["host_copies"]
                               for i in infos])
    router = dict(replicas=ROUTER_REPLICAS, slices=infos[0]["router_slices"],
                  equal_to_one_process=True, wall_ms=walls("router"),
                  launches_rank0=infos[0]["router"]["launches"])
    cache = dict(num_shards=NUM_SHARDS, pinned_budget_shards=MESH_PIN_SHARDS,
                 scores_equal_dense=True, wall_ms=walls("engine_sharded"),
                 ranks=[i["cache"] for i in infos],
                 median_device_peak_gb=med([i["cache"]["device_peak_gb"]
                                            for i in infos]))
    return engine, router, cache


def mesh_training_checks(infos: list) -> tuple:
    """GPipe parity within the training tolerances and the re-sharding
    drill bit for bit on every rank; no kernel of ours launched.  Returns
    the (gpipe, reshard) lines' dicts."""
    for r, info in enumerate(infos):
        g = info["gpipe"]["parity"]
        check(g["loss_rel_err"] <= TRAIN_LOSS_RTOL,
              f"mesh rank {r}: GPipe loss {g['loss']} vs one process "
              f"{g['loss_one_process']}")
        check(g["grad_rel_err_max"] <= TRAIN_GRAD_RTOL,
              f"mesh rank {r}: GPipe gradient {g['worst']} off by "
              f"{g['grad_rel_err_max']} normwise")
        d = info["reshard"]
        check(d["restored_bit_identical"] and d["died"]
              and d["resumed_bit_identical"]
              and d["resumed_steps"] == RESHARD_STEPS - RESHARD_FAIL,
              f"mesh rank {r}: re-sharding drill {d}")
        for run in MESH_TRAINING_PATHS:
            lm_path(f"mesh rank {r} {run}", info[run]["launches"])
    gpipe = dict(arch=TRAIN_ARCH, axes=list(GPIPE_AXES),
                 shape=list(MESH_SHAPE), batch=GPIPE_BATCH, seq=GPIPE_SEQ,
                 micro=GPIPE_MICRO,
                 parity=[i["gpipe"]["parity"] for i in infos],
                 bf16=[i["gpipe"]["bf16"] for i in infos])
    reshard = dict(saved_on=list(MESH_SHAPE), resumed_on=[MESH_WORLD],
                   steps=RESHARD_STEPS, fail_at=RESHARD_FAIL,
                   checkpoint_every=RESHARD_EVERY, batch=DRILL_BATCH,
                   seq=RESHARD_SEQ, ranks=[i["reshard"] for i in infos],
                   walls_ms={run: [i[run]["wall_ms"] for i in infos]
                             for run in ("reshard_restore",
                                         "reshard_drill")})
    return gpipe, reshard


def reshard_one_process(torch, wd: Path) -> dict:
    """The re-sharding drill's checkpoint (saved on MESH_SHAPE) restored in
    one process must equal the same two steps run here, bit for bit."""
    from repro_torch.examples.train_lm import config_100m
    from repro_torch.launch.train import make_lm_run
    from repro_torch.train import checkpoint as ckpt

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        step_fn, batches_fn, full = make_lm_run(
            config_100m(), batch=DRILL_BATCH, seq=RESHARD_SEQ, lr=3e-3,
            steps=RESHARD_STEPS, device="cuda", seed=0)
        for i in range(2):
            full, _ = step_fn(full, batches_fn(i))
        leaves = [t for _, t in ckpt._flatten(full)]
        example = ckpt._unflatten(full, iter(
            [torch.zeros_like(t) for t in leaves]))
        got = ckpt.restore(wd / "reshard_ck", 1, example)
        same = all(torch.equal(x, y) for x, y in zip(
            [t for _, t in ckpt._flatten(got)], leaves))
    finally:
        torch.use_deterministic_algorithms(was)
    check(same, "mesh re-sharding: the checkpoint restored in one process "
                "differs from the one-process state")
    del step_fn, full, got, example, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return dict(bit_identical=True)


def so_mtime() -> float:
    """Modification time of the built extension (0 if there is none)."""
    from repro_torch.kernels import ext

    found = list(ext.BUILD_DIR.glob("*.so"))
    return max((f.stat().st_mtime for f in found), default=0.0)


def mesh_phase(torch, np, args, first: dict) -> tuple:
    """The multi-device paths on one card (the ``mesh`` phase):
    (a) world 1, ``nccl``, mesh (1,): the paper config's 10^6 x 768 index
    built with ``mesh=``, whose ``distributed_topk`` of the serve phase's
    8 perturbed queries must equal that phase's flat scan bit for bit;
    (b) MESH_WORLD ranks co-located on ``cuda:0`` (``gloo``, collectives of
    CUDA tensors staged through host memory), mesh MESH_SHAPE, started with
    the spawn method: the first stage at 10^6 x 768 over both axes equal to
    (a) bit for bit; the RemoteRAG round (REQUESTS requests through
    ``run_remoterag``, then as one batch) over a 2^17-doc mesh index equal
    to the single-process round on the same corpus (ids, decrypted scores,
    wire bytes); the MoE layer of LM_ARCH at its published width (tokens
    over "data", experts over "model"), float32 within 1e-5 of the einsum
    layer in one process (relative to its largest output), then timed in
    bf16; the engine, the router and the row-sharded cache over the
    round's mesh index against the one-process engine (`mesh_serving`);
    GPipe (`mesh_gpipe`) and the re-sharding drill (`mesh_reshard`).
    Returns (phase dict, [(path, launches, shapes)]); the phase dict's
    ``engine``, ``router``, ``cache``, ``gpipe`` and ``reshard`` entries
    print as lines of their own."""
    import torch.multiprocessing as mp

    from repro_torch.core import planner
    from repro_torch.data import synth
    from repro_torch.kernels import ext
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.retrieval.topk import distributed_topk
    from repro_torch.serve import EngineConfig, ServeEngine, SessionManager

    cfg = paper()
    wd = mesh_dir()                 # holds the flat phases' corpus.npy
    out, paths = {}, []
    try:
        # -- (a) world 1, nccl ------------------------------------------------
        t0 = time.perf_counter()
        mesh_lib.init_ranks("nccl", store_path=wd / "store1", rank=0,
                            world_size=1)
        try:
            mesh = mesh_lib.make_mesh((1,), ("data",), device="cuda",
                                      backend="nccl")
            index = FlatIndex.build(np.load(wd / "corpus.npy", mmap_mode="r"),
                                    mesh=mesh, normalize=False)
            q = first["pert"].cuda()
            torch.cuda.synchronize()
            ext.reset_launches()
            t1 = time.perf_counter()
            res = distributed_topk(index, q, first["kprime"])
            torch.cuda.synchronize()
            a_ms = (time.perf_counter() - t1) * 1e3
            counts = path_launches("mesh_nccl_world1", ext.launch_counts(),
                                   ("score_topk",))
            paths.append(("mesh_nccl_world1", counts,
                          shape_counts(ext.launch_shapes())))
            check(torch.equal(res.values.cpu(), first["values"])
                  and torch.equal(res.indices.cpu(), first["indices"]),
                  "mesh (a): world-1 nccl search differs from the flat scan")
            warm = walls_ms(torch, lambda: distributed_topk(
                index, q, first["kprime"]), 5)
            np.save(wd / "queries.npy", first["pert"].numpy())
            del index
        finally:
            mesh_lib.shutdown()
        out["nccl_world1"] = dict(first_ms=a_ms, warm_ms=warm,
                                  part_s=time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()

        # -- single-process references for (b) ------------------------------
        t0 = time.perf_counter()
        n_docs = MESH_ROUND_DOCS
        corpus = synth.uniform_corpus(np.random.default_rng(args.seed + 7),
                                      n_docs, cfg.DIM)
        queries = synth.queries_near_corpus(
            np.random.default_rng(args.seed + 8), corpus, REQUESTS)
        docs = [f"passage-{i}".encode() for i in range(n_docs)]
        index = FlatIndex.build(corpus, documents=docs)
        del corpus
        plan = planner.plan(n=cfg.DIM, N=n_docs, k=cfg.K, kprime=cfg.KPRIME)
        single = mesh_round(torch, np, index, docs, queries, plan, cfg.RLWE,
                            args.seed, args.seed * 1000 + 17)
        eng = ServeEngine(index, config=EngineConfig(max_batch=8),
                          sessions=SessionManager(rlwe_params=cfg.RLWE,
                                                  deterministic_seeds=True))
        open_tenants(eng, cfg.DIM, n_docs, cfg.K, cfg.KPRIME)
        single_serve = mesh_requests(np, eng, queries, docs, args.seed)
        eng.close()
        del index, eng
        gc.collect()
        torch.cuda.empty_cache()
        spec = moe_layer_spec()
        layer, x = moe_inputs(torch, spec, args.seed)
        half = x.shape[0] // MESH_SHAPE[0]
        with torch.no_grad():
            # one process, one "data" shard at a time: the router's
            # products have the ranks' shapes, so routing is bit-equal
            shards = [moe_lib.moe_fwd_einsum(layer, x[i:i + half], spec)
                      for i in range(0, x.shape[0], half)]
            moe_o = torch.cat([o for o, _ in shards]).cpu()
            moe_aux = float(sum(a for _, a in shards)) / len(shards)
            layer.to(torch.bfloat16)
            xb = x.to(torch.bfloat16)
            single_bf16 = walls_ms(torch, lambda: moe_lib.moe_fwd_einsum(
                layer, xb, spec), MESH_MOE_REPS)
        del layer, x, xb, shards
        gc.collect()
        torch.cuda.empty_cache()
        out["references_s"] = time.perf_counter() - t0

        # -- (b) co-located ranks, gloo -------------------------------------
        rank_cfg = dict(kprime=first["kprime"], seed=args.seed,
                        gen_seed=args.seed * 1000 + 17, round_docs=n_docs,
                        dim=cfg.DIM, k=cfg.K, knob=cfg.KPRIME, rlwe=cfg.RLWE)
        mtime = so_mtime()
        t0 = time.perf_counter()
        mp.spawn(mesh_rank, args=(str(wd), rank_cfg), nprocs=MESH_WORLD,
                 join=True)
        ranks_s = time.perf_counter() - t0
        infos = [json.loads((wd / f"rank{r}.json").read_text())
                 for r in range(MESH_WORLD)]
        arrays = [dict(np.load(wd / f"rank{r}.npz"))
                  for r in range(MESH_WORLD)]
        out["reshard_one_process"] = reshard_one_process(torch, wd)
    finally:
        shutil.rmtree(wd, ignore_errors=True)

    moe_err = 0.0
    scale = float(moe_o.abs().max())
    half = MESH_MOE_BATCH // MESH_SHAPE[0]
    for r, (info, arr) in enumerate(zip(infos, arrays)):
        check(info["so_mtime"] == mtime,
              f"mesh rank {r} rebuilt the kernels")
        check(info["first_rows"] == [args.n_docs,
                                     args.n_docs // MESH_WORLD],
              f"mesh rank {r}: block {info['first_rows']}")
        check(np.array_equal(arr["first_v"], first["values"].numpy())
              and np.array_equal(arr["first_i"], first["indices"].numpy()),
              f"mesh rank {r}: first stage differs from (a)")
        for key, want in single.items():
            check(np.array_equal(arr[f"round_{key}"], want),
                  f"mesh rank {r}: round {key} differs from one process")
        pos = r // MESH_SHAPE[1]          # the rank's "data" position
        want = moe_o[pos * half:(pos + 1) * half].numpy()
        moe_err = max(moe_err, float(np.abs(arr["moe_o"] - want).max()))
        check(abs(float(arr["moe_aux"]) - moe_aux) <= 1e-5 * abs(moe_aux),
              f"mesh rank {r}: aux {float(arr['moe_aux'])} vs {moe_aux}")
        path_launches(f"mesh rank {r} first stage",
                      info["first_stage"]["launches"], ("score_topk",))
        path_launches(f"mesh rank {r} round", info["round"]["launches"])
        lm_path(f"mesh rank {r} moe", info["moe_f32"]["launches"])
    check(moe_err <= 1e-5 * scale,
          f"mesh MoE off by {moe_err} (largest output {scale})")
    serving = mesh_serving_checks(np, infos, arrays, single_serve)
    gpipe, reshard = mesh_training_checks(infos)
    for part in ("first_stage", "round", "moe_f32") + MESH_SERVING_PATHS \
            + MESH_TRAINING_PATHS:
        total = collections.Counter()
        shapes = []
        for info in infos:
            total.update(info[part]["launches"])
            shapes += info[part]["shapes"]
        paths.append((f"mesh_{part}", dict(total), shapes))
    med = lambda xs: statistics.median(xs)
    out.update(
        world=MESH_WORLD, shape=list(MESH_SHAPE), axes=list(MESH_AXES),
        round_docs=MESH_ROUND_DOCS, moe_tokens=[MESH_MOE_BATCH, MESH_MOE_SEQ],
        ranks_s=ranks_s,
        moe_max_abs_err=moe_err, moe_scale=scale, moe_aux=moe_aux,
        moe_single_bf16_ms=med(single_bf16),
        ranks=[dict(
            rank=i["rank"], load_s=i["load_s"],
            round_cache_s=i["round_cache_s"],
            moe_experts_local=i["moe_experts_local"],
            all_gather_ms=med(i["all_gather_ms"]),
            all_reduce_ms=med(i["all_reduce_ms"]),
            moe_bf16_ms=med(i["moe_bf16_ms"]),
            host_copies=i["host_copies"], host_bytes=i["host_bytes"],
            memory=i["memory"],
            **{part: {k: v for k, v in i[part].items() if k != "shapes"}
               for part in ("first_stage", "round", "moe_f32")})
            for i in infos])
    out["engine"], out["router"], out["cache"] = serving
    out["gpipe"], out["reshard"] = gpipe, dict(
        reshard, one_process=out.pop("reshard_one_process"))
    return out, paths


# -- arch phase ---------------------------------------------------------------

def gnn_flops(cfg, v: int, e: int) -> int:
    """Matrix-product FLOPs of one GNN training step over v nodes and e
    edges, as the work needs them: 2·M·K·N a product forward, twice that
    backward, less the encoder's first input gradient (the features need
    none).  Remat's recomputed forward is not counted."""
    d, f = cfg.d_hidden, cfg.d_feat
    fwd = 2 * (v * f * d + v * d * d + e * 2 * d * d
               + cfg.n_layers * (e * 4 * d * d + v * 3 * d * d)
               + v * d * d + v * d * cfg.n_vars)
    return 3 * fwd - 2 * v * f * d


def gnn_graph(np, rng):
    """The synthetic host graph: GNN_NODES nodes (Reddit's count), each
    with GNN_IN_DEG in-edges from uniform sources; its in-neighbour CSR."""
    from repro_torch.models import gnn

    dst = np.repeat(np.arange(GNN_NODES), GNN_IN_DEG)
    src = rng.integers(0, GNN_NODES, dst.shape[0])
    return gnn.build_csr(src, dst, GNN_NODES)


def gnn_batch(torch, np, rng, n_nodes: int, src, dst, d_feat: int,
              n_vars: int, pad_nodes=None, pad_edges=None):
    """A `GraphBatch` on the card: seeded features (``d_feat``) and
    targets (``n_vars``) for ``n_nodes`` nodes and the edges (src, dst),
    padded to ``pad_nodes`` / ``pad_edges`` (the shape's static bounds:
    zero-feature nodes; the pad edges self-loops spread over them)."""
    from repro_torch.models import gnn

    v = pad_nodes or n_nodes
    e = pad_edges or len(src)
    check(v >= n_nodes + (e > len(src)) and e >= len(src),
          f"subgraph of {n_nodes} nodes / {len(src)} edges exceeds its "
          f"bounds {v} / {e}")
    feats = np.zeros((v, d_feat), np.float32)
    feats[:n_nodes] = rng.normal(size=(n_nodes, d_feat))
    loops = n_nodes + np.arange(e - len(src)) % max(v - n_nodes, 1)
    s = np.concatenate([src, loops]).astype(np.int32)
    d = np.concatenate([dst, loops]).astype(np.int32)
    tgt = rng.normal(size=(v, n_vars)).astype(np.float32)
    return gnn.GraphBatch(*(torch.from_numpy(x).cuda()
                            for x in (feats, s, d, tgt)))


def gnn_parity(torch, np, args, csr) -> dict:
    """(a) graphcast at full width, GNN_PARITY_LAYERS float32 layers, one
    set of weights from a seeded CPU generator on the CPU and the card; a
    subgraph of GNN_PARITY_SEEDS seeds' fanout: loss within
    TRAIN_LOSS_RTOL relative and every gradient within TRAIN_GRAD_RTOL
    normwise of the CPU's; whether a repeat on the card is bit-identical
    (printed), and two runs under deterministic algorithms (gated)."""
    import dataclasses

    from repro_torch.configs import graphcast, shapes
    from repro_torch.models import gnn
    from repro_torch.train import trainer

    shape = shapes.GNN_SHAPES["minibatch_lg"]
    cfg = dataclasses.replace(graphcast.CONFIG, n_layers=GNN_PARITY_LAYERS,
                              dtype="float32", d_feat=shape.d_feat)
    rng = np.random.default_rng(args.seed + 31)
    nodes, src, dst = gnn.sample_fanout(
        rng, *csr, rng.choice(GNN_NODES, GNN_PARITY_SEEDS, replace=False),
        shape.fanout)
    batch = gnn_batch(torch, np, rng, len(nodes), src, dst, cfg.d_feat,
                      cfg.n_vars)
    cpu = gnn.Gnn(cfg, generator=torch.Generator().manual_seed(args.seed),
                  device="cpu")
    card = gnn.Gnn(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())

    def run(model, b):
        model.requires_grad_(True)
        return trainer.value_and_grad(
            lambda p, *x: model.loss(gnn.GraphBatch(*x)),
            dict(model.named_parameters()), tuple(b))

    def same(a, b) -> bool:
        return torch.equal(a[0], b[0]) and all(
            torch.equal(a[1][k], b[1][k]) for k in a[1])

    want_loss, want = run(cpu, gnn.GraphBatch(*(t.cpu() for t in batch)))
    loss, grads = run(card, batch)
    loss_err = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    errs = {k: rel_err(g, want[k]) for k, g in grads.items()}
    worst = max(errs, key=errs.get)
    check(loss_err <= TRAIN_LOSS_RTOL, f"gnn parity: loss off by {loss_err}")
    check(errs[worst] <= TRAIN_GRAD_RTOL,
          f"gnn parity: gradient {worst} off by {errs[worst]}")
    # the scatters' float atomics: a repeat on the card, then two under
    # deterministic algorithms, which must agree bit for bit
    default_repeat = same((loss, grads), run(card, batch))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det = run(card, batch)
        det_repeat = same(det, run(card, batch))
    finally:
        torch.use_deterministic_algorithms(was)
    check(det_repeat, "gnn parity: two deterministic runs differ")
    det_err = max(rel_err(g, want[k]) for k, g in det[1].items())
    check(det_err <= TRAIN_GRAD_RTOL,
          f"gnn parity: deterministic gradients off by {det_err}")
    return dict(layers=cfg.n_layers, dtype=cfg.dtype, nodes=len(nodes),
                edges=len(src), loss_rel_err=loss_err,
                grad_max_rel_err=errs[worst], grad_worst=worst,
                default_repeat_bit_equal=default_repeat,
                deterministic_repeat_bit_equal=det_repeat,
                deterministic_grad_max_rel_err=det_err)


def gnn_steps(torch, np, args, shape, batch, steps: int) -> dict:
    """graphcast at every published width (16 bf16 layers, remat, d_feat
    of ``shape``) from a seeded CUDA generator: one warm-up AdamW step,
    ``steps`` timed, one profiled; ms a step beside its FLOP bound, the
    losses, the device peak."""
    import dataclasses

    from repro_torch.configs import graphcast
    from repro_torch.models import gnn
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer

    cfg = dataclasses.replace(graphcast.CONFIG, d_feat=shape.d_feat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = gnn.Gnn(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    params = dict(model.requires_grad_(True).named_parameters())
    ocfg = opt_lib.AdamWConfig()
    state = opt_lib.init(params, ocfg)
    step = trainer.make_train_step(
        lambda p, *x: model.loss(gnn.GraphBatch(*x)), ocfg,
        param_dtype=cfg.torch_dtype)
    losses = []

    def one():
        nonlocal state
        t = time.perf_counter()
        _, state, m = step(params, state, tuple(batch))
        losses.append(float(m["loss"]))          # waits for the device
        return (time.perf_counter() - t) * 1e3

    warm = one()
    ms = [one() for _ in range(steps)]
    median = statistics.median(ms)
    _, prof = profiled(torch, one, median, top=6)
    check(all(math.isfinite(x) for x in losses),
          f"gnn {shape.name}: non-finite loss {losses}")
    v, e = batch.node_feats.shape[0], batch.edge_src.shape[0]
    flops = gnn_flops(cfg, v, e)
    bound_ms = flops / BF16_OPS_S * 1e3
    out = dict(shape=shape.name, nodes=v, edges=e, d_feat=cfg.d_feat,
               layers=cfg.n_layers, d_hidden=cfg.d_hidden,
               dtype=cfg.dtype, remat=cfg.remat, warmup_ms=warm,
               step_ms=ms, step_ms_median=median, tflop=flops / 1e12,
               bound_ms=bound_ms, bound_by="operations",
               bound_share=bound_ms / median, losses=losses,
               step_profile=prof,
               device_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model, params, state
    return out


def gnn_part(torch, np, args) -> dict:
    """(a) The GNN: `gnn_parity`; graphcast's full-width steps on the
    fanout subgraph of GNN_SEEDS seeds padded to ``minibatch_lg``'s static
    bounds (GNN_STEPS timed), one step each at ``full_graph_sm`` and
    ``molecule`` on uniform random graphs of their sizes."""
    from repro_torch.configs import graphcast, shapes
    from repro_torch.models import gnn

    rng = np.random.default_rng(args.seed + 30)
    t0 = time.perf_counter()
    csr = gnn_graph(np, rng)
    graph_s = time.perf_counter() - t0
    out = dict(host_graph=dict(nodes=GNN_NODES, in_degree=GNN_IN_DEG,
                               build_s=graph_s))
    out["parity"] = gnn_parity(torch, np, args, csr)
    shape = shapes.GNN_SHAPES["minibatch_lg"]
    t0 = time.perf_counter()
    nodes, src, dst = gnn.sample_fanout(
        rng, *csr, rng.choice(GNN_NODES, GNN_SEEDS, replace=False),
        shape.fanout)
    sample_s = time.perf_counter() - t0
    n_vars = graphcast.CONFIG.n_vars
    batch = gnn_batch(torch, np, rng, len(nodes), src, dst, shape.d_feat,
                      n_vars, shape.n_nodes, shape.n_edges)
    out["minibatch_lg"] = dict(gnn_steps(torch, np, args, shape, batch,
                                         GNN_STEPS),
                               sampled_nodes=len(nodes),
                               sampled_edges=len(src), sample_s=sample_s)
    for name in ("full_graph_sm", "molecule"):
        shp = shapes.GNN_SHAPES[name]
        src = rng.integers(0, shp.n_nodes, shp.n_edges).astype(np.int32)
        dst = rng.integers(0, shp.n_nodes, shp.n_edges).astype(np.int32)
        batch = gnn_batch(torch, np, rng, shp.n_nodes, src, dst, shp.d_feat,
                          n_vars)
        out[name] = gnn_steps(torch, np, args, shp, batch, 1)
    ogb = shapes.GNN_SHAPES["ogb_products"]
    out["ogb_products"] = (
        f"dry run only: {ogb.n_edges:,} edges x 512 in bf16 is "
        f"{ogb.n_edges * 512 * 2 / 1e9:.1f} GB for one edge tensor, "
        f"beyond one card")
    return out


def recsys_inputs(np, rng, arch: str, cfg, b: int) -> tuple:
    """A seeded batch of ``arch``'s inputs at batch ``b`` (numpy): ids per
    field within the field's vocabulary, offset globally; labels last."""
    lbl = rng.integers(0, 2, b).astype(np.float32)
    if arch in ("fm", "dcn-v2"):
        ids = (rng.integers(0, cfg.vocab_per_field, (b, cfg.n_sparse))
               + np.arange(cfg.n_sparse) * cfg.vocab_per_field)
        ids = ids.astype(np.int32)
        if arch == "fm":
            return ids, lbl
        return rng.normal(size=(b, cfg.n_dense)).astype(np.float32), ids, lbl
    if arch == "dien":
        return (rng.integers(0, cfg.item_vocab, (b, cfg.seq_len)).astype(
            np.int32), rng.integers(0, cfg.item_vocab, b).astype(np.int32),
            lbl)
    return (rng.integers(0, cfg.user_vocab, (b, cfg.n_user_feats)).astype(
        np.int32), rng.integers(0, cfg.item_vocab,
                                (b, cfg.n_item_feats)).astype(np.int32))


def recsys_arch(torch, np, args, arch: str) -> dict:
    """One recsys model at its published widths and vocabularies: (1)
    card = CPU on a REC_PARITY_BATCH batch from one seeded CPU weight set
    (loss TRAIN_LOSS_RTOL, every gradient TRAIN_GRAD_RTOL normwise);
    (2) the forward at ``serve_p99`` (REC_SERVE), median of 10; (3) AdamW
    steps at ``train_batch`` (REC_TRAIN; two-tower cut to TWOTOWER_TRAIN,
    DIEN in DIEN_MICRO microbatches): one warm-up, 2 timed; matmul FLOPs
    from the dry run's counter on the same step's cell."""
    import dataclasses

    from repro_torch.configs import families, registry, shapes
    from repro_torch.launch import dryrun
    from repro_torch.models import recsys
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer

    cfg = registry.get(arch).config
    rng = np.random.default_rng(args.seed + 40)
    out = dict(arch=arch)
    cpu = recsys.MODELS[arch](cfg, generator=torch.Generator().manual_seed(
        args.seed), device="cpu")
    card = recsys.MODELS[arch](cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    out["params"] = sum(p.numel() for p in card.parameters())
    batch = recsys_inputs(np, rng, arch, cfg, REC_PARITY_BATCH)

    def grads(model, b):
        model.requires_grad_(True)
        return trainer.value_and_grad(lambda p, *x: model.loss(*x),
                                      dict(model.named_parameters()), b)

    want_loss, want = grads(cpu, tuple(torch.from_numpy(x) for x in batch))
    loss, got = grads(card, tuple(torch.from_numpy(x).cuda() for x in batch))
    loss_err = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    errs = {k: rel_err(g, want[k]) for k, g in got.items()}
    worst = max(errs, key=errs.get)
    check(loss_err <= TRAIN_LOSS_RTOL,
          f"{arch} parity: loss off by {loss_err}")
    check(errs[worst] <= TRAIN_GRAD_RTOL,
          f"{arch} parity: gradient {worst} off by {errs[worst]}")
    out["parity"] = dict(batch=REC_PARITY_BATCH, loss_rel_err=loss_err,
                         grad_max_rel_err=errs[worst], grad_worst=worst)
    del cpu, want, got
    gc.collect()

    serve = recsys_inputs(np, rng, arch, cfg, REC_SERVE)
    serve = tuple(torch.from_numpy(x).cuda() for x in serve)
    inputs = serve if arch == "two-tower-retrieval" else serve[:-1]
    card.requires_grad_(False)
    with torch.no_grad():
        scores = card(*inputs)
        check(tuple(scores.shape) == (REC_SERVE,) and
              bool(torch.isfinite(scores).all()),
              f"{arch} serve: scores {tuple(scores.shape)}")
        out["serve_ms"] = call_ms(torch, lambda: card(*inputs), 10)

    b = TWOTOWER_TRAIN if arch == "two-tower-retrieval" else REC_TRAIN
    micro = DIEN_MICRO if arch == "dien" else 1
    train = tuple(torch.from_numpy(x).cuda()
                  for x in recsys_inputs(np, rng, arch, cfg, b))
    params = dict(card.requires_grad_(True).named_parameters())
    ocfg = opt_lib.AdamWConfig()
    state = opt_lib.init(params, ocfg)
    step = trainer.make_train_step(lambda p, *x: card.loss(*x), ocfg,
                                   microbatches=micro,
                                   param_dtype=cfg.torch_dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(3):
        t = time.perf_counter()
        _, state, m = step(params, state, train)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t) * 1e3)
    check(all(math.isfinite(x) for x in losses),
          f"{arch} train: non-finite loss {losses}")
    shape = dataclasses.replace(shapes.RECSYS_SHAPES["train_batch"], batch=b)
    cell = families.recsys_cell(arch, cfg, shape, families.production_mesh())
    flops = dryrun.count_flops(cell) or None
    median = statistics.median(ms[1:])
    out["train"] = dict(
        batch=b, microbatches=micro, warmup_ms=ms[0], step_ms=ms[1:],
        step_ms_median=median, losses=losses, matmul_tflop=(
            flops / 1e12 if flops else None),
        bound_ms=(flops / FP32_OPS_S * 1e3 if flops else None),
        bound_by="operations" if flops else None,
        device_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del card, params, state, train
    gc.collect()
    torch.cuda.empty_cache()
    return out


def two_tower_round(torch, np, args, kernels: list) -> tuple:
    """(c) Private two-tower retrieval at full width: the two-tower
    trained RETRIEVAL_STEPS steps of RETRIEVAL_BATCH co-click pairs
    (`examples.recsys_retrieval.train`); the first stage at
    ``retrieval_cand`` (1 user x 2^17 and RETRIEVAL_CANDS item-tower rows
    of 256: score-top-k against its plain version and ``matmul`` +
    ``topk``); the
    example's round (`retrieve`) over RETRIEVAL_ITEMS items on the RLWE
    backend with its launches counted: recall@5 = 1.0 and decrypted scores
    within 2e-3; then every kernel held against its plain version at the
    round's shapes (`kernel_phase` over the round's index and the round's
    one user, the rows appended to ``kernels``' at-shape lists).  Returns
    (dict, [(path, launches, shapes)])."""
    from repro_torch.configs import registry
    from repro_torch.core import planner
    from repro_torch.examples import recsys_retrieval as ex
    from repro_torch.kernels import ext

    cfg = registry.get("two-tower-retrieval").config
    t0 = time.perf_counter()
    model, loss = ex.train(cfg, steps=RETRIEVAL_STEPS, batch=RETRIEVAL_BATCH,
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    out = dict(train_steps=RETRIEVAL_STEPS, train_batch=RETRIEVAL_BATCH,
               train_loss=loss, train_s=time.perf_counter() - t0)
    rng = np.random.default_rng(args.seed + 50)
    feats = rng.integers(0, cfg.item_vocab, (RETRIEVAL_CANDS,
                                             cfg.n_item_feats))
    emb = ex.item_embeddings(model, feats.astype(np.int32))
    user = rng.integers(0, cfg.user_vocab, (1, cfg.n_user_feats))
    with torch.no_grad():
        taste = model.user_embedding(user.astype(np.int32))
    plan = planner.plan(n=emb.shape[1], N=RETRIEVAL_CANDS, k=5, radius=0.1)
    first = [score_topk_row(torch, taste, emb[:rows], plan.kprime)
             for rows in (2**17, RETRIEVAL_CANDS)]
    for row in first:
        row.update(width=emb.shape[1], cell="retrieval_cand")
    out["first_stage"] = [{k: row[k] for k in (
        "shape", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
        "id_mismatches")} for row in first]
    del emb
    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    res = ex.retrieve(model, n_items=RETRIEVAL_ITEMS, k=5,
                      rng=np.random.default_rng(args.seed + 51),
                      rlwe_params=paper().RLWE,
                      generator=torch.Generator(device="cuda").manual_seed(
                          args.seed))
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    counts = path_launches("two_tower_round", ext.launch_counts())
    paths = [("two_tower_round", counts, shape_counts(ext.launch_shapes()))]
    index = res["index"]
    truth = (index.rows(res["candidate_ids"]).double()
             @ torch.from_numpy(res["taste"]).cuda().double()).cpu().numpy()
    score_err = float(np.abs(res["scores"] - truth).max())
    check(res["recall"] == 1.0,
          f"two-tower round: recall@5 {res['recall']} (ids {res['ids']}, "
          f"plaintext {res['oracle']})")
    check(score_err <= 2e-3, f"two-tower round: decrypted scores off by "
                             f"{score_err}")
    out["round"] = dict(items=RETRIEVAL_ITEMS, dim=index.dim,
                        kprime=res["kprime"], recall_at_5=res["recall"],
                        max_score_err=score_err,
                        wire_bytes=res["transcript"].total_bytes,
                        round_s=round_s, launches=counts)
    # every kernel at width 256, at the round's shapes
    rows = kernel_phase(torch, np, args, index, paper().RLWE, res["plan"],
                        res["taste"][None])
    by_name = {k["name"]: k for k in kernels}
    for row in rows:
        main = by_name[row["name"]]
        extra = [{k: v for k, v in row.items() if k not in (
            "name", "route", "source", "replaces", "launches", "at_shapes",
            "fuses")}] + row.get("at_shapes", [])
        for r in extra:
            r["width"] = index.dim
        main.setdefault("at_shapes", []).extend(extra)
    by_name["score_topk"]["at_shapes"].extend(first)
    del model, res, index
    return out, paths


def dryrun_summary(torch) -> list:
    """(d) Every cell of ``ASSIGNED`` and ``remoterag`` built on the
    (16, 16) production mesh on ``meta`` tensors: its bytes per rank
    against the card's 80 GB and, for the GNN, recsys and RemoteRAG
    cells, its matmul FLOPs (the LM cells' counts take minutes of host
    time: PERF.md records ``dryrun --all``'s).  A cell that cannot be
    counted carries its error."""
    from repro_torch.configs import families, registry
    from repro_torch.launch import dryrun

    mesh = families.production_mesh()
    rows = []
    for arch, entry in registry.REGISTRY.items():
        for name in entry.shapes:
            row = dict(arch=arch, shape=name)
            cell = entry.build_cell(entry.config, entry.shapes[name], mesh)
            row["built"] = True
            row["bytes_per_rank"] = dryrun.bytes_per_rank(cell, mesh)
            row["fits_80gb"] = row["bytes_per_rank"] <= dryrun.H100_HBM_BYTES
            if entry.family != "lm":
                try:
                    row["matmul_flops"] = dryrun.count_flops(cell) or None
                except Exception as e:   # noqa: BLE001 — recorded, not zero
                    row["matmul_flops"] = None
                    row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
                if row["matmul_flops"] is None and "error" not in row:
                    row["error"] = "no matmul-class op"
            rows.append(row)
    check(len(rows) == 42 and all(r["built"] for r in rows),
          f"dry run: {len(rows)} cells built")
    return rows


def arch_phase(torch, np, args, kernels: list) -> tuple:
    """The GNN and recsys models (the ``arch`` phase): (a) `gnn_part`,
    (b) `recsys_arch` for FM, DCN-v2, DIEN and two-tower, (c)
    `two_tower_round`, (d) `dryrun_summary`.  Returns (phase dict, [(path,
    launches, shapes)])."""
    from repro_torch.kernels import ext

    out, paths = dict(cuts=ARCH_CUTS), []
    for name, fn in (("gnn", lambda: gnn_part(torch, np, args)),
                     ("recsys", lambda: [recsys_arch(torch, np, args, a)
                                         for a in REC_ARCHS])):
        torch.cuda.synchronize()
        ext.reset_launches()
        t0 = time.perf_counter()
        out[name] = fn()
        out[f"{name}_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        # like the LM paths, the GNN and recsys paths launch none of ours
        paths.append((name, lm_path(name, ext.launch_counts()),
                      shape_counts(ext.launch_shapes())))
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["two_tower"], round_paths = two_tower_round(torch, np, args, kernels)
    out["two_tower_s"] = time.perf_counter() - t0
    paths += round_paths
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_summary(torch)
    out["dryrun_s"] = time.perf_counter() - t0
    return out, paths



def flat_phases(torch, np, args, emits) -> tuple:
    """Phases 2-7 on the paper config's uniform corpus, in one scope so the
    index, its dense cache and the cache's host pool are freed when it
    returns.  Appends the phases' JSON lines to ``emits``; returns (kernel
    rows, [(path, launches, shapes)], the batch's first stage: its
    perturbed queries, flat-scan values and ids, and k'); leaves the
    normalized corpus in `mesh_dir` for the mesh phase."""
    from repro_torch.core import planner, protocol
    from repro_torch.crypto import rlwe
    from repro_torch.data import synth
    from repro_torch.kernels import ext
    from repro_torch.retrieval.index import FlatIndex

    # -- data, index, cache (paper config: configs/remoterag.py) -----------
    cfg = paper()
    dim, k, kprime_knob, params = cfg.DIM, cfg.K, cfg.KPRIME, cfg.RLWE
    t0 = time.perf_counter()
    corpus = synth.uniform_corpus(np.random.default_rng(args.seed),
                                  args.n_docs, dim)
    queries = synth.queries_near_corpus(np.random.default_rng(args.seed + 1),
                                        corpus, REQUESTS)
    docs = [f"passage-{i}".encode() for i in range(args.n_docs)]
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = FlatIndex.build(corpus, documents=docs)
    del corpus
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    # the mesh phase builds its indexes from these normalized rows
    shutil.rmtree(mesh_dir(), ignore_errors=True)
    mesh_dir().mkdir(parents=True)
    np.save(mesh_dir() / "corpus.npy", index.embeddings.cpu().numpy())
    plan = planner.plan(n=dim, N=args.n_docs, k=k, kprime=kprime_knob)
    cloud = protocol.RemoteRagCloud(index, rlwe_params=params)
    torch.cuda.reset_peak_memory_stats()
    ext.reset_launches()
    t0 = time.perf_counter()
    cache = cloud.candidate_cache
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    cache_launches = ext.launch_counts()

    with Peaks(torch) as pk_serve:
        t0 = time.perf_counter()
        kernels = kernel_phase(torch, np, args, index, params, plan, queries)
        kernels_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        shared, serve = serve_phase(torch, np, args, index, cloud, params,
                                    plan, queries)
        serve_s = time.perf_counter() - t0
    for path in ("launches_seq", "launches_batch"):
        path_launches(path, serve[path])
    with Peaks(torch) as pk_cache:
        t0 = time.perf_counter()
        cache_out = cache_phase(torch, np, args, cache, params, plan, shared)
        cache_phase_s = time.perf_counter() - t0
    with Peaks(torch) as pk_engine:
        t0 = time.perf_counter()
        engine, dense_results = engine_phase(torch, np, args, index, params,
                                             plan, queries, shared)
        engine_s = time.perf_counter() - t0
    with Peaks(torch) as pk_router:
        t0 = time.perf_counter()
        router = router_phase(torch, np, args, index, params, plan, queries,
                              dense_results)
        router_s = time.perf_counter() - t0
    paths = [("serve_seq", serve["launches_seq"], serve["shapes_seq"]),
             ("serve_batch", serve["launches_batch"], serve["shapes_batch"])]
    paths += [(f"engine_{name}", run["launches"], run["shapes"])
              for name, run in engine.items()]
    paths.append(("router", router["launches"], router["shapes"]))
    with Peaks(torch) as pk_paillier:
        t0 = time.perf_counter()
        paillier, paillier_paths = paillier_phase(torch, np, args, index,
                                                  plan, queries, shared)
        paillier_s = time.perf_counter() - t0
    paths += paillier_paths
    emits.append({"phase": "serve", "n_docs": args.n_docs, "dim": dim,
                  "k": plan.k, "kprime": plan.kprime, "path": plan.path,
                  "eps": plan.eps, "data_s": data_s, "index_s": index_s,
                  "cache_build_s": cache_s, "cache_gb": cache.nbytes / 1e9,
                  "cache_launches": cache_launches,
                  "kernels_phase_s": kernels_s, "phase_s": serve_s,
                  "memory": pk_serve.result, **serve})
    emits.append({"phase": "cache", "num_shards": NUM_SHARDS,
                  "phase_s": cache_phase_s, "memory": pk_cache.result,
                  **cache_out})
    emits.append({"phase": "engine", "requests": 2 * len(queries),
                  "tenants": TENANTS, "budget_shards": BUDGET_SHARDS,
                  "phase_s": engine_s, "runs": engine,
                  "memory": pk_engine.result})
    emits.append({"phase": "router", "requests": 2 * len(queries),
                  "phase_s": router_s, "memory": pk_router.result, **router})
    emits.append({"phase": "paillier", "key_bits": PAILLIER_BITS,
                  "kprime": plan.kprime, "dim": dim,
                  "phase_s": paillier_s, "memory": pk_paillier.result,
                  **paillier})
    for run in engine.values():
        run.pop("shapes")
    router.pop("shapes")
    return kernels, paths, shared["first"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=None,
                    help="documents of the paper-config phases (default: "
                         "the config's N_DOCS, 10^6; the IVF phase always "
                         "holds 10^6)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import ext

    if args.n_docs is None:
        args.n_docs = paper().N_DOCS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- environment + kernel build ---------------------------------------
    card = gpu_line()
    t0 = time.perf_counter()
    ext.extension()             # builds every kernel (ninja, in parallel)
    build_s = time.perf_counter() - t0
    emit({"phase": "environment", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "build_s": build_s})

    emits: list = []
    kernels, paths, first = flat_phases(torch, np, args, emits)
    # the flat phases' index, dense cache and host pool are gone: the IVF
    # corpus needs their device and host memory
    gc.collect()
    torch.cuda.empty_cache()
    released = dict(device_gb=torch.cuda.memory_allocated() / 1e9,
                    host_rss_gb=Peaks.rss_gb())
    check(released["device_gb"] < 1.0,
          f"flat phases left {released['device_gb']} GB on the device")
    with Peaks(torch) as pk_ivf:
        t0 = time.perf_counter()
        ivf, ivf_paths = ivf_phase(torch, np, args, paper().RLWE)
        ivf_s = time.perf_counter() - t0
    paths += ivf_paths
    gc.collect()
    torch.cuda.empty_cache()
    with Peaks(torch) as pk_text:
        t0 = time.perf_counter()
        text, text_paths, text_rows = text_phase(torch, np, args,
                                                 paper().RLWE)
        text_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with Peaks(torch) as pk_attack:
        t0 = time.perf_counter()
        attack, attack_paths, attack_rows = attack_phase(torch, np, args)
        attack_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with Peaks(torch) as pk_lm:
        t0 = time.perf_counter()
        lm, lm_paths = lm_phase(torch, np, args)
        lm_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with Peaks(torch) as pk_train:
        t0 = time.perf_counter()
        train, train_paths = train_phase(torch, np, args)
        train_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with Peaks(torch) as pk_mesh:
        t0 = time.perf_counter()
        mesh, mesh_paths = mesh_phase(torch, np, args, first)
        mesh_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with Peaks(torch) as pk_arch:
        t0 = time.perf_counter()
        arch, arch_paths = arch_phase(torch, np, args, kernels)
        arch_s = time.perf_counter() - t0
    paths += text_paths + attack_paths + lm_paths + train_paths + mesh_paths
    paths += arch_paths
    score_row = next(k for k in kernels if k["name"] == "score_topk")
    score_row["at_shapes"] += text_rows + attack_rows
    launch_tally(kernels, paths)
    emit({"kernels": kernels})
    for line in emits:
        emit(line)
    emit({"phase": "ivf_ingest", "n_docs": IVF_DOCS,
          "clusters": IVF_CLUSTERS, "shard_docs": IVF_SHARD_DOCS,
          "ingest_docs": INGEST_DOCS, "released_before": released,
          "phase_s": ivf_s, "memory": pk_ivf.result, **ivf})
    emit({"phase": "text", "phase_s": text_s, "memory": pk_text.result,
          **text})
    emit({"phase": "attack", "phase_s": attack_s,
          "memory": pk_attack.result, **attack})
    emit({"phase": "lm", "phase_s": lm_s, "memory": pk_lm.result, **lm})
    emit({"phase": "train", "phase_s": train_s, "memory": pk_train.result,
          **train})
    items = {key: mesh.pop(key)
             for key in ("engine", "router", "cache", "gpipe", "reshard")}
    emit({"phase": "mesh", "phase_s": mesh_s, "memory": pk_mesh.result,
          **mesh})
    for key, item in items.items():
        emit({"phase": f"mesh_{key}", **item})
    emit({"phase": "arch", "phase_s": arch_s, "memory": pk_arch.result,
          **arch})
    emit({"phase": "summary", "build_s": build_s,
          "host_max_rss_gb": resource.getrusage(
              resource.RUSAGE_SELF).ru_maxrss / 1e6,
          "total_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
