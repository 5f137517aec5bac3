"""The port's ``private_rag_serve`` example on the CPU, in-process, in its
default, ``--trace-out`` and ``--cache-shard-docs`` modes, which must serve
the same ids, documents and wire bytes (the modes change where the
re-rank's cache lives and what is recorded, never a result).  Tenant keys
come from the tenant names (``deterministic_seeds``) inside the test, so
the runs encrypt alike.  One intra-op thread: beside other busy test
workers torch's thread pools make the plain NTT's many small ops slow."""

import json

import pytest
import torch

from repro_torch.examples import private_rag_serve
from repro_torch.serve import session as tsession


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seed_sessions(monkeypatch):
    init = tsession.SessionManager.__init__

    def seeded(self, *args, **kw):
        kw["deterministic_seeds"] = True
        init(self, *args, **kw)

    monkeypatch.setattr(tsession.SessionManager, "__init__", seeded)


@pytest.fixture
def seeded_sessions(monkeypatch):
    _seed_sessions(monkeypatch)


@pytest.fixture(scope="module")
def default_run(one_thread):
    with pytest.MonkeyPatch.context() as m:
        _seed_sessions(m)
        return private_rag_serve.main(["--device", "cpu"])


def _same(a, b):
    assert (a.request_id, a.tenant, a.ids.tolist(), a.docs) == (
        b.request_id, b.tenant, b.ids.tolist(), b.docs)
    for f in ("total_bytes", "request_bytes", "reply_bytes"):
        assert getattr(a.transcript, f) == getattr(b.transcript, f)


@pytest.mark.parametrize("mode", ["trace", "sharded"])
def test_private_rag_serve_modes_serve_the_default_results(
        mode, default_run, seeded_sessions, tmp_path, capsys):
    if mode == "trace":
        path = tmp_path / "trace.json"
        got = private_rag_serve.main(["--device", "cpu", "--trace-out",
                                      str(path)])
        events = json.loads(path.read_text())["traceEvents"]
        assert any(e.get("name") == "encrypt" for e in events)
        assert "trace:" in capsys.readouterr().out
    else:
        got = private_rag_serve.main(["--device", "cpu", "--cache-shard-docs",
                                      "500", "--cache-budget-mb", "40"])
        assert "sharded cache:" in capsys.readouterr().out
    assert len(got) == len(default_run) == len(private_rag_serve.QUERIES)
    for a, b in zip(got, default_run):
        _same(a, b)
