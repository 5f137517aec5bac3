"""k-out-of-k' oblivious transfer (paper Appendix A.1, Chou-Orlandi style).

The cloud (sender) holds k' documents; the user (receiver) wants the k at
indices S without revealing S.  Group: 2048-bit MODP group (RFC 3526 group
14); hash: SHA-256; symmetric cipher: SHA-256-keyed XOR keystream.

    cloud:  a random,  A = g^a mod p                         -> user
    user:   B_i = A^{c_i} * g^{b_i},  c_i = 0 iff i in S     -> cloud
    cloud:  Key_i = H(B_i^a),  sends Enc(m_i, Key_i)         -> user
    user:   Key_{s_j} = H(A^{b_{s_j}}) decrypts the selected k

For i in S:   B_i^a = g^{a b_i}   = A^{b_i}          -> keys agree.
For i not in S: B_i^a = g^{a(a + b_i)} != g^{a b_i}  -> key mismatch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import secrets
from typing import List, Sequence

# RFC 3526, 2048-bit MODP group 14.
MODP_2048_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
MODP_G = 2


def _hash_key(x: int) -> bytes:
    return hashlib.sha256(x.to_bytes((x.bit_length() + 7) // 8 or 1, "big")).digest()


def _keystream(key: bytes, nonce: int, length: int) -> bytes:
    out = b""
    counter = 0
    while len(out) < length:
        out += hashlib.sha256(key + nonce.to_bytes(8, "big")
                              + counter.to_bytes(8, "big")).digest()
        counter += 1
    return out[:length]


def _xor(data: bytes, stream: bytes) -> bytes:
    return bytes(a ^ b for a, b in zip(data, stream))


@dataclasses.dataclass
class OtSender:
    """Cloud side."""
    messages: List[bytes]
    p: int = MODP_2048_P
    g: int = MODP_G

    def round1(self) -> int:
        self._a = secrets.randbelow(self.p - 2) + 1
        self.A = pow(self.g, self._a, self.p)
        return self.A

    def round2(self, bs: Sequence[int]) -> List[bytes]:
        """Receive B_i, return all k' messages encrypted under Key_i."""
        assert len(bs) == len(self.messages)
        out = []
        for i, (b_i, m) in enumerate(zip(bs, self.messages)):
            key = _hash_key(pow(b_i, self._a, self.p))
            out.append(_xor(m, _keystream(key, i, len(m))))
        return out

    def bytes_sent(self, encrypted: List[bytes]) -> int:
        return (self.p.bit_length() + 7) // 8 + sum(len(e) for e in encrypted)


@dataclasses.dataclass
class OtReceiver:
    """User side."""
    selected: Sequence[int]   # indices S, |S| = k
    total: int                # k'
    p: int = MODP_2048_P
    g: int = MODP_G

    def round1(self, A: int) -> List[int]:
        self._A = A
        self._bs = []
        out = []
        sel = set(self.selected)
        for i in range(self.total):
            b_i = secrets.randbelow(self.p - 2) + 1
            self._bs.append(b_i)
            c_i = 0 if i in sel else 1
            out.append(pow(A, c_i, self.p) * pow(self.g, b_i, self.p) % self.p)
        return out

    def round2(self, encrypted: List[bytes]) -> List[bytes]:
        """Decrypt exactly the selected messages (order of ``selected``)."""
        out = []
        for s in self.selected:
            key = _hash_key(pow(self._A, self._bs[s], self.p))
            out.append(_xor(encrypted[s], _keystream(key, s, len(encrypted[s]))))
        return out


def run_ot(messages: List[bytes], selected: Sequence[int]) -> tuple:
    """Execute the protocol; returns (plaintexts for user, wire bytes)."""
    sender = OtSender(messages=messages)
    receiver = OtReceiver(selected=selected, total=len(messages))
    A = sender.round1()
    bs = receiver.round1(A)
    enc = sender.round2(bs)
    got = receiver.round2(enc)
    group_bytes = (sender.p.bit_length() + 7) // 8
    wire = group_bytes * (1 + len(bs)) + sum(len(e) for e in enc)
    return got, wire


__all__ = ["OtSender", "OtReceiver", "run_ot", "MODP_2048_P", "MODP_G"]
