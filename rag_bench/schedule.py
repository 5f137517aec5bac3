"""The one traffic generator: reads a traffic mix's parameters (a file
under ``traffic/``) and draws every request of a run from the seed.

Two kinds:

* ``closed``: ``clients`` callers, each sending its next request once its
  last reply is back (agents and batch jobs that wait for each
  retrieval).  Request ``i`` is simply the ``i``-th one sent.
* ``poisson``: independent users arriving at ``rate_rps``.  Every seed
  gets the same multiset of inter-arrival gaps (the exponential
  distribution's quantiles at ``(j + 0.5) / M``, ``M = rate * seconds``),
  in an order drawn from the seed, so seeds change where the bursts fall
  and not how much work a run holds.

Each request's query (an index into the configuration's pool), tenant and
DistanceDP key are drawn from the seed too."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

KINDS = ("closed", "poisson")
MAX_REQUESTS = 1 << 17     # a closed loop's draws: far above any window


def _rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64),
                                                         tag]))


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for ``tag``'s stream (torch generators, tenants)."""
    return int(np.random.SeedSequence([seed % (1 << 64), tag])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass(frozen=True)
class Schedule:
    kind: str
    clients: int                       # closed loop: callers
    arrivals: Optional[np.ndarray]     # poisson: due offsets (s), sorted
    query: np.ndarray                  # (n_req,) index into the pool
    tenant: np.ndarray                 # (n_req,) tenant number
    key: np.ndarray                    # (n_req,) DistanceDP keys (int64)

    @property
    def size(self) -> int:
        return int(self.query.shape[0])


def poisson_arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    m = max(int(round(rate * seconds)), 1)
    u = (np.arange(m) + 0.5) / m
    gaps = -np.log1p(-u) / rate
    gaps = gaps[_rng(seed, 1).permutation(m)]
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def make(traffic: dict, *, seed: int, seconds: float, pool: int,
         tenants: int) -> Schedule:
    kind = traffic["kind"]
    if kind == "closed":
        clients = int(traffic["clients"])
        if clients < 1:
            raise ValueError("a closed loop needs at least one client")
        arrivals, n = None, MAX_REQUESTS
    elif kind == "poisson":
        rate = float(traffic["rate_rps"])
        if rate <= 0:
            raise ValueError("rate_rps must be positive")
        clients, arrivals = 0, poisson_arrivals(rate, seconds, seed)
        n = arrivals.shape[0]
    else:
        raise ValueError(f"unknown traffic kind {kind!r}; one of {KINDS}")
    rng = _rng(seed, 2)
    return Schedule(kind=kind, clients=clients, arrivals=arrivals,
                    query=rng.integers(0, pool, n),
                    tenant=rng.integers(0, tenants, n),
                    key=rng.integers(0, np.iinfo(np.int64).max, n,
                                     dtype=np.int64))
