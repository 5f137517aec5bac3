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

The reference's ``shard_a2a`` implementation (``shard_map`` over a mesh,
each expert-parallel shard running `_dispatch_compute` on its own experts,
one psum combine) waits for the multi-device slice (ROADMAP queue 1,
item 2); with no mesh ``moe_fwd`` runs the einsum formulation, as the
reference's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.layers import make_param


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    d_model: int
    d_ff: int                  # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    ep_pad_to: int = 1         # pad experts to a multiple of this
    # the reference's activation sharding (the port runs on one device)
    batch_axes: Optional[tuple] = None
    ep_axis: Optional[str] = None
    # "einsum" | "shard_a2a" (needs a mesh: not ported yet)
    impl: str = "einsum"
    mesh: Optional[object] = None

    @property
    def padded_experts(self) -> int:
        return -(-self.n_experts // self.ep_pad_to) * self.ep_pad_to

    def capacity(self, group_tokens: int) -> int:
        cap = int(self.capacity_factor * group_tokens * self.top_k
                  / self.n_experts)
        return max(4, -(-cap // 4) * 4)


class Moe(nn.Module):
    """The reference's ``moe_params`` tree: ``router`` (d_model, E_pad),
    ``w_gate``/``w_up`` (E_pad, d_model, d_ff), ``w_down`` (E_pad, d_ff,
    d_model); normal x 1/sqrt(d_model), ``w_down`` x 1/sqrt(d_ff), drawn
    from ``generator`` in that order."""

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

    def forward(self, x: torch.Tensor) -> tuple:
        return moe_fwd(self, x, self.spec)


def moe_fwd(p: Moe, x: torch.Tensor, spec: MoeSpec) -> tuple:
    if spec.impl == "shard_a2a" and spec.mesh is not None:
        raise NotImplementedError(
            "moe impl 'shard_a2a' over a mesh waits for the multi-device "
            "slice (ROADMAP queue 1, item 2)")
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


def moe_fwd_einsum(p: Moe, x: torch.Tensor, spec: MoeSpec) -> tuple:
    """x: (B, S, d) -> ((B, S, d), aux loss).  Each batch row is a group."""
    e = spec.padded_experts
    logits, values, ids = route(p, x, spec)
    gate_i = ids[..., :spec.top_k]                              # (B, S, K)
    gate_w = torch.softmax(values[..., :spec.top_k], dim=-1).to(x.dtype)

    # load-balancing loss: the mean runs over the padded expert axis
    probs = torch.softmax(logits, dim=-1)
    onehot1 = F.one_hot(gate_i[..., 0], e).float()
    aux = spec.n_experts * torch.mean(onehot1.mean(dim=1) * probs.mean(dim=1))

    out = _dispatch_compute(p, x, gate_w, gate_i, 0, e,
                            spec.capacity(x.shape[1]), spec)
    return out, aux


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


__all__ = ["MoeSpec", "Moe", "moe_fwd", "moe_fwd_einsum", "route"]
