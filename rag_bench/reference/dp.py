"""Frozen copy of the (n, eps)-DistanceDP mechanism as the port draws it:
``e' = e + r v`` with ``r ~ Gamma(n, 1/eps)`` by Marsaglia-Tsang on the
generator's normals and uniforms (float64), ``v`` a normalized float32
Gaussian, all from one ``torch.Generator`` seeded with the request's key
on the device of the run.  The same draws in the same order give the same
noise, so the reference recomputes the perturbed query the cloud saw."""

from __future__ import annotations

import math

import numpy as np
import torch


def sample_gamma(g: torch.Generator, a: float) -> torch.Tensor:
    dev = g.device
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(1, dtype=torch.float64, device=dev)
    todo = torch.arange(1, device=dev)
    while todo.numel():
        m = todo.numel()
        x = torch.randn(m, generator=g, dtype=torch.float64, device=dev)
        u = torch.rand(m, generator=g, dtype=torch.float64, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if boost:
        u = torch.rand(1, generator=g, dtype=torch.float64, device=dev)
        out = out * u ** (1.0 / a)
    return out.to(torch.float32).reshape(())


def perturb(key: int, e: np.ndarray, eps: float,
            device: torch.device) -> torch.Tensor:
    """The perturbed query (n,) float32 on ``device`` for DistanceDP key
    ``key``."""
    g = torch.Generator(device=device).manual_seed(int(key))
    e = torch.as_tensor(np.asarray(e, np.float32), device=device)
    n = e.shape[-1]
    r = sample_gamma(g, float(n)) / float(eps)
    t = torch.randn((n,), generator=g, dtype=torch.float32, device=device)
    v = t / torch.linalg.norm(t, dim=-1, keepdim=True)
    return e + r * v
