"""A run at a small size on the CPU (the look for a card skipped), with
the timed path broken underneath: ``correct`` comes out false for each
fault a serving cell can have."""

import io

import numpy as np
import pytest
import torch

from conftest import SMALL_RAG, SMALL_TOWER
from rag_bench import harness


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell="rag768-sat", fault=None, overrides=SMALL_RAG, seed=2**31 + 9):
    return harness.run_cell(cell, seed=seed, seconds=1.0, trace=False,
                            device="cpu", config_overrides=overrides,
                            fault=fault, log=io.StringIO())


def _failing(out):
    return {n for n, c in out["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell,overrides", [
    ("rag768-sat", SMALL_RAG), ("tower256-paced", SMALL_TOWER)])
def test_an_unbroken_run_is_correct(cell, overrides):
    out = _run(cell, overrides=overrides)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) >= {"setup_s", "wire_kb_per_request"}


def test_half_of_each_batch_left_out():
    def fault(engine):
        step = engine.step
        engine.step = lambda **kw: step(**kw)[::2]
    out = _run(fault=fault)
    assert not out["correct"] and out["failed"] > 0
    assert "missing" in _failing(out)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from repro_torch.crypto import backend
    impl = backend.get_backend("rlwe")
    decrypt = impl.decrypt_scores

    def flipped(*a, **kw):
        return [-np.asarray(s) for s in decrypt(*a, **kw)]

    out = _run(fault=lambda e: monkeypatch.setattr(impl, "decrypt_scores",
                                                   flipped))
    assert not out["correct"] and "topk_gap" in _failing(out)


def test_the_perturbation_drawn_at_another_budget(monkeypatch):
    from repro_torch.serve import batching
    perturb = batching.perturb_batch

    def wider(gens, E, epss, **kw):
        return perturb(gens, E, [e / 4 for e in epss], **kw)

    out = _run(fault=lambda e: monkeypatch.setattr(batching, "perturb_batch",
                                                   wider))
    assert not out["correct"] and "cand_gap" in _failing(out)


def test_documents_of_other_ids(monkeypatch):
    def fault(engine):
        index = engine.cloud.index
        fetch = index.fetch_documents
        monkeypatch.setattr(index, "fetch_documents",
                            lambda ids: fetch([(int(i) + 1) % 2000
                                               for i in ids]))
    out = _run(fault=fault)
    assert not out["correct"] and "doc_errors" in _failing(out)
