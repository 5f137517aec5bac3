"""Token-choice top-k MoE with grouped, capacity-bounded dispatch.

Counterpart of ``repro/models/moe.py`` (GShard-style routing):

  * routing groups = batch rows; every group sorts and capacity-drops its
    own tokens (per row and expert, the first ``capacity(S)`` (token, k)
    pairs in token order are kept, the rest dropped);
  * expert weights are stacked (E, ...) and zero-padded to a multiple of
    ``ep_pad_to``; the router never routes to padding (its logits are
    -inf there);
  * the expert products are plain batched matrix products over the expert
    axis (the reference's einsums, outside any Pallas kernel).

``impl="shard_a2a"`` with a mesh runs `moe_fwd_sharded` (the reference's
``shard_map`` formulation, SPMD: one process per rank); with no mesh
``moe_fwd`` runs the einsum formulation, as the reference's does.

A `DroplessMoeSpec` runs DeepSeek-V2's layer instead (`moe_fwd_dropless`, no
counterpart in the reference): its softmax-then-top-k gate, every
(token, expert) pair computed in grouped products, and the shared
experts (``shared``, a SwiGLU) added to every token.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.layers import Mlp, make_param, mlp_fwd


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    d_model: int
    d_ff: int                  # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    ep_pad_to: int = 1         # pad experts to a multiple of this
    # token and expert sharding of impl="shard_a2a" (the einsum path runs
    # on one device and ignores them)
    batch_axes: Optional[tuple] = None
    ep_axis: Optional[str] = None
    # "einsum" | "shard_a2a" (over ``mesh``: see moe_fwd_sharded)
    impl: str = "einsum"
    mesh: Optional[object] = None   # repro_torch.launch.mesh.make_mesh
    # not a field: True on `DroplessMoeSpec`, whose layer is DeepSeek's
    dropless = False

    @property
    def padded_experts(self) -> int:
        return -(-self.n_experts // self.ep_pad_to) * self.ep_pad_to

    def capacity(self, group_tokens: int) -> int:
        cap = int(self.capacity_factor * group_tokens * self.top_k
                  / self.n_experts)
        return max(4, -(-cap // 4) * 4)


@dataclasses.dataclass(frozen=True)
class DroplessMoeSpec(MoeSpec):
    """DeepSeek's layer (`moe_fwd_dropless`): a softmax over every expert,
    the top k taken as they are, times ``routed_scale``; the shared
    experts' SwiGLU of ``shared_d_ff`` (none if None) added to every
    token.  The capacity and sharding fields are unused."""
    routed_scale: float = 1.0
    shared_d_ff: Optional[int] = None
    dropless = True


class Moe(nn.Module):
    """The reference's ``moe_params`` tree: ``router`` (d_model, E_pad),
    ``w_gate``/``w_up`` (E_pad, d_model, d_ff), ``w_down`` (E_pad, d_ff,
    d_model); normal x 1/sqrt(d_model), ``w_down`` x 1/sqrt(d_ff), drawn
    from ``generator`` in that order; then, with ``shared_d_ff``, the
    shared experts ``shared`` (an `Mlp`)."""

    def __init__(self, spec: MoeSpec, generator: torch.Generator,
                 device: torch.device, dtype=torch.float32):
        super().__init__()
        self.spec = spec
        e, d, f = spec.padded_experts, spec.d_model, spec.d_ff
        scale = 1.0 / math.sqrt(d)
        self.router = make_param((d, e), scale, generator, device, dtype)
        self.w_gate = make_param((e, d, f), scale, generator, device, dtype)
        self.w_up = make_param((e, d, f), scale, generator, device, dtype)
        self.w_down = make_param((e, f, d), 1.0 / math.sqrt(f), generator,
                                 device, dtype)
        if spec.dropless and spec.shared_d_ff:
            self.shared = Mlp(d, spec.shared_d_ff, generator, device, dtype)

    def forward(self, x: torch.Tensor, probe=None) -> tuple:
        return moe_fwd(self, x, self.spec, probe=probe)


def moe_fwd(p: Moe, x: torch.Tensor, spec: MoeSpec, probe=None) -> tuple:
    """``probe`` (serving traces, dropless path only) is handed the
    number of distinct experts the tokens were routed to, on the
    device."""
    if spec.dropless:
        return moe_fwd_dropless(p, x, spec, probe=probe)
    if spec.impl == "shard_a2a" and spec.mesh is not None:
        return moe_fwd_sharded(p, x, spec)
    return moe_fwd_einsum(p, x, spec)


def route(p: Moe, x: torch.Tensor, spec: MoeSpec) -> tuple:
    """(router logits (B, S, E_pad) float32, sorted, with their expert
    ids): the matmul in x's type, then float32; padded experts -inf.
    Sorted by (logit desc, id asc), the order of ``jax.lax.top_k``."""
    logits = torch.matmul(x, p.router).float()
    if spec.padded_experts != spec.n_experts:
        pad = torch.arange(spec.padded_experts, device=x.device) >= \
            spec.n_experts
        logits = logits.masked_fill(pad, -torch.inf)
    top = torch.sort(logits, dim=-1, descending=True, stable=True)
    return logits, top.values, top.indices


def _gates(p: Moe, x: torch.Tensor, spec: MoeSpec) -> tuple:
    """(gate weights (B, S, K) in x's type, expert ids (B, S, K), aux
    loss over this batch)."""
    logits, values, ids = route(p, x, spec)
    gate_i = ids[..., :spec.top_k]
    gate_w = torch.softmax(values[..., :spec.top_k], dim=-1).to(x.dtype)
    # load-balancing loss: the mean runs over the padded expert axis
    probs = torch.softmax(logits, dim=-1)
    onehot1 = F.one_hot(gate_i[..., 0], spec.padded_experts).float()
    aux = spec.n_experts * torch.mean(onehot1.mean(dim=1) * probs.mean(dim=1))
    return gate_w, gate_i, aux


def moe_fwd_einsum(p: Moe, x: torch.Tensor, spec: MoeSpec) -> tuple:
    """x: (B, S, d) -> ((B, S, d), aux loss).  Each batch row is a group."""
    gate_w, gate_i, aux = _gates(p, x, spec)
    out = _dispatch_compute(p, x, gate_w, gate_i, 0, spec.padded_experts,
                            spec.capacity(x.shape[1]), spec)
    return out, aux


def moe_fwd_sharded(p: Moe, x: torch.Tensor, spec: MoeSpec) -> tuple:
    """Expert-parallel MoE over ``spec.mesh``, run by every rank in
    lockstep: ``x`` is this rank's (B_loc, S, d) tokens (batch split over
    ``spec.batch_axes``, the same on every rank along ``spec.ep_axis``),
    and ``p`` holds the whole router and this rank's ``E_pad / n_ep``
    experts (`repro_torch.models.transformer.shard_params`).

    Every rank routes its tokens (the router is replicated), runs
    `_dispatch_compute` on the (token, k) pairs routed to its own experts
    (dispatch costs no communication), and one all-reduce over the EP axis
    combines the partial outputs.  The aux loss is the global batch's: the
    mean of the ranks' batch means over the batch axes.

    Gradients: the combine is `mesh_lib.all_reduce_fwd` (sum forward,
    identity backward: the output's cotangent is already the same on every
    EP rank, and ``torch.distributed.nn``'s all-reduce would sum it again,
    n_ep times the true gradient); the tokens and gate weights enter the
    rank's experts through `mesh_lib.all_reduce_bwd` (identity forward,
    sum backward: each rank's experts give only their part of those
    gradients).  Every EP rank then holds the whole gradient of ``x`` and
    of the router, and its experts' own; the weights' gradients of the
    global loss are their sums over the batch axes.  The aux loss reduces
    with `mesh_lib.all_reduce_fwd` too, for the same reason."""
    mesh, ep = spec.mesh, spec.ep_axis
    if ep is None:
        raise ValueError("shard_a2a needs an ep_axis")
    ba = tuple(spec.batch_axes or ())
    e = spec.padded_experts
    n_ep = mesh_lib.axes_size(mesh, (ep,))
    if e % n_ep:
        raise ValueError(f"{e} experts do not split over {n_ep} EP ranks")
    e_loc = e // n_ep
    if p.w_gate.shape[0] != e_loc:
        raise ValueError(f"the layer holds {p.w_gate.shape[0]} experts; an "
                         f"EP rank holds {e_loc} (shard_params)")
    gate_w, gate_i, aux = _gates(p, x, spec)
    if ba:
        aux = mesh_lib.all_reduce_fwd(aux, mesh, ba) / \
            mesh_lib.axes_size(mesh, ba)
    e_lo = mesh_lib.axes_position(mesh, (ep,)) * e_loc
    part = _dispatch_compute(p, mesh_lib.all_reduce_bwd(x, mesh, (ep,)),
                             mesh_lib.all_reduce_bwd(gate_w, mesh, (ep,)),
                             gate_i, e_lo, e_loc, spec.capacity(x.shape[1]),
                             spec)
    return mesh_lib.all_reduce_fwd(part, mesh, (ep,)), aux


def _dispatch_compute(p, x: torch.Tensor, gate_w: torch.Tensor,
                      gate_i: torch.Tensor, e_lo: int, n_loc: int, cap: int,
                      spec: MoeSpec) -> torch.Tensor:
    """Capacity-bounded dispatch of (B, S, d) tokens to experts
    [e_lo, e_lo + n_loc), whose weights ``p.w_gate``, ``p.w_up`` and
    ``p.w_down`` hold (already sliced to this range), combined with the
    gate weights.  Pairs routed elsewhere go to a drop bucket (local
    expert ``n_loc``); summing the outputs over disjoint ranges covering
    every expert gives the whole layer's output."""
    b, s, d = x.shape
    k = spec.top_k
    dev = x.device
    flat_e = gate_i.reshape(b, s * k)
    flat_t = torch.arange(s, device=dev).repeat_interleave(k)[None].expand(
        b, -1)
    flat_w = gate_w.reshape(b, s * k)
    mine = (flat_e >= e_lo) & (flat_e < e_lo + n_loc)
    loc_e = torch.where(mine, flat_e - e_lo, n_loc)     # n_loc = drop bucket
    order = torch.argsort(loc_e, dim=1, stable=True)
    se = torch.gather(loc_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    sw = torch.gather(flat_w, 1, order)
    # position of each sorted pair inside its expert's run
    idx = torch.arange(s * k, device=dev)[None].expand(b, -1)
    same = torch.zeros_like(se, dtype=torch.bool)
    same[:, 1:] = se[:, 1:] == se[:, :-1]
    seg_start = torch.cummax(torch.where(same, 0, idx), dim=1).values
    seg_pos = idx - seg_start
    keep = (seg_pos < cap) & (se < n_loc)
    buf_slot = torch.where(keep, se * cap + seg_pos, n_loc * cap)

    # scatter into (B, E·C + 1, d): the last row is the drop slot, the only
    # index written more than once, and it is cut off
    gathered = torch.gather(x, 1, st[..., None].expand(-1, -1, d))
    buffers = x.new_zeros((b, n_loc * cap + 1, d))
    buffers.scatter_(1, buf_slot[..., None].expand(-1, -1, d), gathered)
    # (E, B·C, d): one batched product per expert
    h = buffers[:, :-1].reshape(b, n_loc, cap, d).transpose(0, 1).reshape(
        n_loc, b * cap, d)
    h_g = F.silu(torch.bmm(h, p.w_gate))
    h_u = torch.bmm(h, p.w_up)
    h = torch.bmm(h_g * h_u, p.w_down)
    flat_out = h.reshape(n_loc, b, cap, d).transpose(0, 1).reshape(
        b, n_loc * cap, d)

    safe_slot = torch.clamp(buf_slot, max=n_loc * cap - 1)
    contrib = torch.gather(flat_out, 1, safe_slot[..., None].expand(-1, -1, d))
    contrib = torch.where(keep[..., None], contrib, 0.0) * sw[..., None]
    # Deterministic combine: back to (token, k) order through the inverse
    # of ``order`` (a permutation, so no index repeats), then a sum over k.
    # The reference scatter-adds into the token rows (an atomic add on a
    # GPU, not reproducible run to run in bf16); the order of the k-sum
    # differs from XLA's scatter-add.
    unsorted = torch.empty_like(contrib).scatter_(
        1, order[..., None].expand(-1, -1, d), contrib)
    return unsorted.reshape(b, s, k, d).sum(dim=2)


def softmax_topk_gates(p: Moe, x: torch.Tensor,
                       spec: DroplessMoeSpec) -> tuple:
    """DeepSeek's gate (``MoEGate``, ``topk_method`` greedy, ``scoring_func``
    softmax, ``norm_topk_prob`` false): float32 logits from float32 x and
    router, a softmax over every expert, the top k scores as they are
    (not renormalised) times ``routed_scale``.  (weights (T, k) float32,
    expert ids (T, k))."""
    logits = torch.matmul(x.float(), p.router.float())
    scores = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(scores, spec.top_k, dim=-1)
    return weights * spec.routed_scale, ids


_GROUPED_MM = getattr(torch, "_grouped_mm", None)


def grouped_mm(a: torch.Tensor, w: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """Rows of ``a`` (M, d_in) grouped by expert (the first counts[0] for
    expert 0, ...) through their expert's ``w`` (E, d_in, d_out):
    ``torch._grouped_mm`` over device offsets where this torch has it, in
    bfloat16 on CUDA (an expert with no rows is skipped, its weights never
    read; nothing waits for the host, so a CUDA graph can hold it) or on
    the CPU; else one product per expert with rows, their counts read on
    the host."""
    if _GROUPED_MM is not None and (a.dtype == torch.bfloat16
                                    or not a.is_cuda):
        offs = torch.cumsum(counts, 0, dtype=torch.int32)
        return _GROUPED_MM(a, w, offs=offs)
    out = a.new_empty((a.shape[0], w.shape[-1]))
    lo = 0
    for e, n in enumerate(counts.tolist()):
        if n:
            out[lo:lo + n] = torch.matmul(a[lo:lo + n], w[e])
            lo += n
    return out


def moe_fwd_dropless(p: Moe, x: torch.Tensor, spec: DroplessMoeSpec,
                     probe=None) -> tuple:
    """DeepSeek-V2's MoE at inference (``DeepseekV2MoE.moe_infer``): every
    (token, expert) pair computed, none dropped.  The pairs are sorted by
    expert and each expert's rows go through its SwiGLU as one group
    (`grouped_mm`), so only the experts some token chose are computed;
    the outputs are weighted and summed over k in float32 and cast back,
    then the shared experts' SwiGLU of every token is added.  x: (B, S,
    d) -> ((B, S, d), a zero aux loss: no balancing term at inference)."""
    b, s, d = x.shape
    k = spec.top_k
    xt = x.reshape(b * s, d)
    weights, ids = softmax_topk_gates(p, xt, spec)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    # a scatter, not ``bincount``, which reads the ids' maximum on the host
    counts = torch.zeros(spec.padded_experts, dtype=torch.int64,
                         device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    if probe is not None:
        probe.experts((counts > 0).sum())
    rows = xt[order // k]
    h = F.silu(grouped_mm(rows, p.w_gate, counts)) * grouped_mm(
        rows, p.w_up, counts)
    y = grouped_mm(h, p.w_down, counts)
    unsorted = torch.empty_like(y)
    unsorted[order] = y
    out = (unsorted.reshape(b * s, k, d).float()
           * weights[..., None]).sum(dim=1).to(x.dtype)
    if spec.shared_d_ff:
        out = out + mlp_fwd(p.shared, xt)
    return out.reshape(b, s, d), torch.zeros((), device=x.device)


__all__ = ["MoeSpec", "DroplessMoeSpec", "Moe", "moe_fwd", "moe_fwd_einsum", "moe_fwd_sharded",
           "moe_fwd_dropless", "softmax_topk_gates", "grouped_mm", "route"]
