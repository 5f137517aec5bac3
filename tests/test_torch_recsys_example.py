"""The port's ``recsys_retrieval`` example against the reference example,
run in-process on the CPU.

The reference example (``examples/recsys_retrieval.py``) runs as it is,
with its trained two-tower parameters and its round's result recorded.
The port's `recsys_retrieval.retrieve` then runs from those parameters
(`convert.recsys_params`) with the reference's ``np.random.default_rng(0)``
stream, so the items, the user and the keys are the reference's.  The
DistanceDP perturbation cannot be replayed across the packages (``jax.random``
against a ``torch.Generator``); with k' = 60 of 4,000 items both rounds
must still return the same ids in the same order, the same wire bytes and
recall 1.0.  Item embeddings agree within 1e-5.  The port's own example
(its training too) must reach recall 1.0."""

import importlib.util
from pathlib import Path

import numpy as np

import jax

from repro.core import protocol as jprotocol
from repro.models import recsys as jrec
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.examples import recsys_retrieval

ROOT = Path(__file__).resolve().parents[1]


def _reference_example(monkeypatch):
    """Run examples/recsys_retrieval.py's main; returns (trained params,
    item embeddings, (items, ids, transcript))."""
    spec = importlib.util.spec_from_file_location(
        "reference_recsys_retrieval", ROOT / "examples" / "recsys_retrieval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}
    item_embedding, run = jrec.item_embedding, jprotocol.run_remoterag

    def recording_items(params, cfg, feats):
        seen["params"] = params
        seen["items"] = item_embedding(params, cfg, feats)
        return seen["items"]

    def recording_run(*a, **kw):
        seen["round"] = run(*a, **kw)
        return seen["round"]

    with monkeypatch.context() as m:
        m.setattr(jrec, "item_embedding", recording_items)
        m.setattr(jprotocol, "run_remoterag", recording_run)
        mod.main()
    return seen["params"], np.asarray(seen["items"]), seen["round"]


def test_port_example_equals_reference(monkeypatch):
    params, want_items, (want_docs, want_ids, want_tr) = \
        _reference_example(monkeypatch)
    cfg = treg.get("two-tower-retrieval").reduced
    model = convert.recsys_params("two-tower-retrieval",
                                  jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    got = recsys_retrieval.retrieve(model, rng=np.random.default_rng(0))
    emb = got["index"].embeddings.numpy()
    norms = np.linalg.norm(want_items, axis=1, keepdims=True)
    assert np.abs(emb - want_items / norms).max() <= 1e-5
    assert got["recall"] == 1.0
    assert got["ids"].tolist() == np.asarray(want_ids).tolist()
    assert got["items"] == want_docs
    for f in ("total_bytes", "request_bytes", "reply_bytes", "fetch_bytes",
              "docs_bytes", "path"):
        assert getattr(got["transcript"], f) == getattr(want_tr, f), f
    # decrypted scores against the plaintext inner products
    truth = got["index"].rows(got["candidate_ids"]).double().numpy() @ \
        got["taste"].astype(np.float64)
    assert np.abs(got["scores"] - truth).max() <= 2e-3


def test_port_example_main_recall(capsys):
    assert recsys_retrieval.main(["--device", "cpu"]) == 1.0
    out = capsys.readouterr().out
    assert "recall vs plaintext ranking: 100%" in out
