"""Frozen copy of the wire formula: what a direct-path RLWE round puts on
the user's link, in bytes.  A ciphertext is 2 components x P primes x N
coefficients bit-packed at 20 bits; the request carries the perturbed
query (float32) and k' (4 bytes) beside the encrypted query's chunks; the
reply k' int32 ids and the score ciphertexts (``N / stride`` candidates
each); the fetch k int32 positions; then the documents themselves."""

from __future__ import annotations

from typing import Sequence


def ciphertext_bytes(n_poly: int, num_primes: int) -> int:
    return 2 * num_primes * n_poly * 20 // 8


def transcript(*, dim: int, kprime: int, k: int, docs: Sequence[bytes],
               n_poly: int, num_primes: int, chunk: int) -> dict:
    ct = ciphertext_bytes(n_poly, num_primes)
    chunks = -(-dim // chunk)
    stride = chunk if dim <= chunk else 2 * chunk
    num_ct = -(-kprime // (n_poly // stride))
    return dict(request_bytes=dim * 4 + 4 + chunks * ct,
                reply_bytes=kprime * 4 + num_ct * ct,
                fetch_bytes=4 * k, docs_bytes=sum(len(d) for d in docs),
                ot_wire_bytes=0)
