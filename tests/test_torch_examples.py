"""The port's ``private_rag_serve`` example against the reference example,
run in-process on the CPU.

The reference example (``examples/private_rag_serve.py``) runs as it is,
with its embedder's parameters and its engine's results recorded.  The
port's example then runs with those parameters carried across
(`convert.embedder`).  Two things cannot be replayed across the packages
and are made equal inside the test only: a request's DistanceDP
perturbation (``jax.random``: the port's `batching.perturb_batch` returns
the reference's perturbation for the port request's integer key, which is
the reference request's ``PRNGKey`` seed, as in test_torch_engine.py) and
the tenants' keys (both session managers draw them from the tenant name,
``deterministic_seeds``, instead of OS entropy).  Then every request's ids
and wire bytes must equal the reference's."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.models import embedder as jemb
from repro.serve import ServeEngine as JServeEngine
from repro.serve import batching as jbatching
from repro.serve import session as jsession
from repro_torch import convert
from repro_torch.examples import private_rag_serve
from repro_torch.serve import batching
from repro_torch.serve import session as tsession

ROOT = Path(__file__).resolve().parents[1]


def _deterministic_sessions(monkeypatch, module):
    init = module.SessionManager.__init__

    def seeded(self, *args, **kw):
        kw["deterministic_seeds"] = True
        init(self, *args, **kw)

    monkeypatch.setattr(module.SessionManager, "__init__", seeded)


def _jax_perturb(generators, E, epss, *, device=None):
    keys = [jax.random.PRNGKey(g.initial_seed()) for g in generators]
    return torch.from_numpy(np.array(jbatching.perturb_batch(keys, E, epss)))


def _reference_example(monkeypatch):
    """Run examples/private_rag_serve.py's main; returns (embedder params,
    engine results)."""
    spec = importlib.util.spec_from_file_location(
        "reference_private_rag_serve", ROOT / "examples" /
        "private_rag_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}
    init_params, drain = jemb.init_params, JServeEngine.drain

    def recording_init(key, cfg):
        seen["params"] = init_params(key, cfg)
        return seen["params"]

    def recording_drain(self, **kw):
        out = drain(self, **kw)
        seen.setdefault("results", []).extend(out)
        return out

    with monkeypatch.context() as m:
        m.setattr(jemb, "init_params", recording_init)
        m.setattr(JServeEngine, "drain", recording_drain)
        m.setattr("sys.argv", ["private_rag_serve.py"])
        _deterministic_sessions(m, jsession)
        mod.main()
    return seen["params"], seen["results"]


def test_private_rag_serve_equals_reference_example(monkeypatch, capsys):
    params, want = _reference_example(monkeypatch)
    assert capsys.readouterr().out.count("recall=100%") == len(want)
    cfg = private_rag_serve.encoder_config(dim=private_rag_serve.DIM,
                                           vocab=private_rag_serve.VOCAB,
                                           n_layers=2)
    model = convert.embedder(jax.tree.map(np.asarray, params), cfg,
                             device="cpu")
    monkeypatch.setattr(batching, "perturb_batch", _jax_perturb)
    _deterministic_sessions(monkeypatch, tsession)
    # one intra-op thread: beside other busy test workers torch's thread
    # pools make the plain NTT's many small ops slow
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = private_rag_serve.main(["--device", "cpu"], model=model)
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    assert len(got) == len(want) == len(private_rag_serve.QUERIES)
    for a, b in zip(got, want):
        assert a.ok and b.ok and a.request_id == b.request_id
        assert a.tenant == b.tenant
        assert a.ids.tolist() == np.asarray(b.ids).tolist()
        assert a.docs == b.docs
        for f in ("total_bytes", "request_bytes", "reply_bytes"):
            assert getattr(a.transcript, f) == getattr(b.transcript, f)
    assert out.count("recall=100%") == len(want)
