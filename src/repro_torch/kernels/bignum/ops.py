"""RNS Montgomery bignum primitives as float64 tensor ops (PyTorch).

Counterpart of ``repro/kernels/bignum/ops.py``: the batched twin of
``ref.py``, identical formulas, over ``torch.float64`` tensors on the
caller's device, so a whole ``[batch, k', channels]`` ciphertext block
moves through each step at once.  The two base extensions are
``torch.matmul`` against the fixed ``[s, s+1]`` matrices from
`ref.RnsSystem`; everything else is elementwise.  The reference computes
these with XLA ops outside any Pallas kernel, and so does this module: no
hand-written kernel.  Every op here is one eager launch, so a multiply is
about a hundred small launches and an exponentiation is bound by launch
overhead, not by bytes or operations.

Constants travel in a plain dict (see `make_consts`): system matrices are
shared across lanes, per-modulus vectors (``c1``, ``NMinv_t``, ``one``,
``plain_one``) are stacked per lane and shaped to broadcast against the
value batch, which is what lets one call serve a multi-tenant batch whose
lanes hold *different* keys of one channel count.

Exactness contract (proved in ref.py, differential-tested in
tests/test_torch_bignum.py): channels < 2^23, products < 2^46, matmul sums
< s·2^46 <= 2^53 for s <= 128 — every double is an exact integer, so the
bits depend on no summation order (cuBLAS's included).  `_mod` divides by
a reciprocal rounded once (precomputed in `make_consts`, as the reference
rounds ``1.0 / m``); its quotient may be off by one either way and both
corrections pin the residue into [0, m).  Do not ``torch.compile`` this.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.bignum import ref

_RADIX = float(ref.RADIX)
_INV_RADIX = 1.0 / _RADIX

_count_lock = threading.Lock()
_counts = {"calls": 0, "values": 0}


def mont_mul_counts() -> dict:
    """Montgomery multiplies since the last `reset_mont_mul_counts`: calls
    of `mont_mul` and the values they multiplied (broadcast batch size)."""
    with _count_lock:
        return dict(_counts)


def reset_mont_mul_counts() -> None:
    with _count_lock:
        _counts["calls"] = 0
        _counts["values"] = 0


def make_consts(system: ref.RnsSystem, moduli: Sequence[ref.RnsModulus],
                batch_ndim: int, *, device: torch.device) -> dict:
    """The constants for a stack of per-lane moduli, on ``device``.

    ``batch_ndim`` is the number of batch axes on the values the ops will
    see (e.g. 2 for ``[lanes, k', channels]``): per-lane vectors are shaped
    ``[lanes, 1, ..., s]`` so they broadcast against any trailing batch
    axes, while the shared system matrices stay rank-2.  The reciprocals
    of the channel moduli (``inv_*``) are rounded here, once.
    """
    # by channel count, not identity: the system is a pure function of s,
    # and replica threads racing on `ref.get_system`'s first call can each
    # build one
    if any(m.system.s != system.s for m in moduli):
        raise ValueError("all moduli must share one channel count")
    lane_shape = (len(moduli),) + (1,) * (batch_ndim - 1)

    def dev(arr):
        return torch.from_numpy(np.asarray(arr, np.float64).copy()).to(device)

    def stack(rows):
        arr = np.stack(rows).astype(np.float64)
        return dev(arr.reshape(lane_shape + (arr.shape[-1],)))

    C = {
        "s": system.s,
        "E1": dev(system.E1), "E2": dev(system.E2),
        "Minv_t": dev(system.Minv_t), "c4": dev(system.c4),
        "Mp_mod_m": dev(system.Mp_mod_m), "Mpinv_r": float(system.Mpinv_r),
        "c1": stack([m.c1 for m in moduli]),
        "NMinv_t": stack([m.NMinv_t for m in moduli]),
        "one": stack([m.one for m in moduli]),
        "plain_one": stack([m.plain_one for m in moduli]),
    }
    for name, mods in (("mv", system.mv), ("mpv", system.mpv),
                       ("tgt", system.tgt), ("allm", system.allm)):
        C[name] = dev(mods)
        C["inv_" + name] = dev(1.0 / np.asarray(mods, np.float64))
    return C


def _mod(t: torch.Tensor, m, inv_m) -> torch.Tensor:
    """``ref._mod`` with ``inv_m`` = 1.0 / m rounded once.  The floor is a
    floor division by 1 (the same bits as ``torch.floor``, -0.0 included):
    on the CPU ``torch.floor`` of a float64 tensor opens a thread-parallel
    region whatever its size, which under other busy processes costs
    milliseconds a call; on the card both are one launch."""
    q = torch.div(t * inv_m, 1.0, rounding_mode="floor")
    r = t - q * m
    r = r + m * (r < 0)
    return r - m * (r >= m)


def mont_mul(a: torch.Tensor, b: torch.Tensor, C: dict) -> torch.Tensor:
    """Batched RNS Montgomery multiply over channel-last tensors."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    with _count_lock:
        _counts["calls"] += 1
        _counts["values"] += int(np.prod(shape[:-1], dtype=np.int64))
    s = C["s"]
    x = _mod(a * b, C["allm"], C["inv_allm"])
    xi = _mod(x[..., :s] * C["c1"], C["mv"], C["inv_mv"])
    u = _mod(torch.matmul(xi, C["E1"]), C["tgt"], C["inv_tgt"])
    wt = _mod(x[..., s:] * C["Minv_t"] + u * C["NMinv_t"], C["tgt"],
              C["inv_tgt"])
    xip = _mod(wt[..., :s] * C["c4"], C["mpv"], C["inv_mpv"])
    g2 = torch.matmul(xip, C["E2"])
    alpha = _mod((_mod(g2[..., s:], _RADIX, _INV_RADIX) - wt[..., s:])
                 * C["Mpinv_r"], _RADIX, _INV_RADIX)
    wm = _mod(g2[..., :s] - alpha * C["Mp_mod_m"], C["mv"], C["inv_mv"])
    return torch.cat([wm, wt], dim=-1)


def pow_table(base: torch.Tensor, C: dict, window: int) -> torch.Tensor:
    """``[2^window, *base.shape]`` table of base^0 .. base^(2^w - 1)."""
    rows = [C["one"].expand(base.shape), base]
    for _ in range(2, 1 << window):
        rows.append(mont_mul(rows[-1], base, C))
    return torch.stack(rows)


def gather_table(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[*batch] = table[idx[*batch], *batch]`` for a ``[T, *batch,
    channels]`` table and int64 ``idx`` of shape ``*batch`` (the
    reference's ``take_along_axis`` on axis 0), one indexing launch."""
    flat = table.reshape(table.shape[0], -1, table.shape[-1])
    rows = torch.arange(flat.shape[1], device=table.device)
    return flat[idx.reshape(-1), rows].reshape(table.shape[1:])


def mont_exp_digits(table: torch.Tensor, digits: torch.Tensor, C: dict,
                    window: int) -> torch.Tensor:
    """Left-to-right windowed exponentiation from a precomputed table.

    ``digits`` is ``[*batch, positions]`` int64 on the table's device,
    most-significant window first, with ``*batch`` equal to the table's
    value batch shape.  Each position is ``window`` squarings plus one
    gathered multiply (the reference's ``lax.scan`` body).
    """
    acc = C["one"].expand(table.shape[1:])
    for p in range(digits.shape[-1]):
        acc = square_n(acc, C, window)
        acc = mont_mul(acc, gather_table(table, digits[..., p]), C)
    return acc


def square_n(x: torch.Tensor, C: dict, n: int) -> torch.Tensor:
    for _ in range(n):
        x = mont_mul(x, x, C)
    return x


def product_reduce(x: torch.Tensor, C: dict) -> torch.Tensor:
    """Tree-reduce a ``[..., n, channels]`` stack to ``[..., channels]``
    with Montgomery multiplies (log2(n) levels, odd tails carried)."""
    while x.shape[-2] > 1:
        half = x.shape[-2] // 2
        y = mont_mul(x[..., :half, :], x[..., half:2 * half, :], C)
        if x.shape[-2] % 2:
            y = torch.cat([y, x[..., 2 * half:, :]], dim=-2)
        x = y
    return x[..., 0, :]


def to_digits(exponents: Sequence[int], window: int,
              positions: int | None = None) -> np.ndarray:
    """Fixed-width base-2^window digit planes, most-significant first,
    ``[len(exponents), positions]`` int64 (leading zeros pad short ones)."""
    if positions is None:
        bits = max(int(e).bit_length() for e in exponents)
        positions = max(1, -(-bits // window))
    mask = (1 << window) - 1
    out = np.zeros((len(exponents), positions), np.int64)
    for i, e in enumerate(exponents):
        e = int(e)
        for p in range(positions - 1, -1, -1):
            out[i, p] = e & mask
            e >>= window
        if e:
            raise ValueError("exponent wider than digit plan")
    return out


__all__ = ["make_consts", "mont_mul", "pow_table", "gather_table",
           "mont_exp_digits", "square_n", "product_reduce", "to_digits",
           "mont_mul_counts", "reset_mont_mul_counts"]
