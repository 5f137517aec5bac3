"""The port's copies of the framework-free serving modules run the JAX
package's own suites: `tests/test_obs.py` against `repro_torch.obs`, and
`tests/test_admission.py` against `repro_torch.serve.admission` through the
port's `ServeEngine` (on the CPU).  Each reference test runs unchanged with
the module-level names it uses re-pointed at the port (inside the test
only); request keys become the port's integer generator seeds."""

import inspect
from types import SimpleNamespace

import numpy as np
import pytest

import test_admission as ref_admission
import test_obs as ref_obs

from repro_torch import obs
from repro_torch.crypto import rlwe as tr
from repro_torch.data import synth
from repro_torch.obs import trace
from repro_torch.retrieval.index import FlatIndex
from repro_torch.serve import (AdmissionConfig, AdmissionError, EngineConfig,
                               InvalidEmbedding, QueueFull, RateLimited,
                               ServeEngine, UnknownTenant)
from repro_torch.serve import admission as adm
from repro_torch.serve.session import SessionManager

TP = tr.RlweParams(n_poly=1024, chunk=512)


def _tests(mod):
    return sorted(n for n, f in vars(mod).items()
                  if n.startswith("test_") and callable(f))


def _call(fn, **fixtures):
    params = inspect.signature(fn).parameters
    return fn(**{k: v for k, v in fixtures.items() if k in params})


@pytest.mark.parametrize("name", _tests(ref_obs))
def test_reference_obs_suite(name, monkeypatch, tmp_path):
    monkeypatch.setattr(ref_obs, "obs", obs)
    monkeypatch.setattr(ref_obs, "_MAX_STR", trace._MAX_STR)
    _call(getattr(ref_obs, name), tmp_path=tmp_path)


@pytest.fixture(scope="module")
def port_corpus():
    """The reference suite's corpus (its fixture's seed and sizes), on a
    port index."""
    rng = np.random.default_rng(0)
    emb = synth.uniform_corpus(rng, ref_admission.N_DOCS, ref_admission.DIM)
    docs = [f"passage-{i}".encode() for i in range(ref_admission.N_DOCS)]
    index = FlatIndex.build(emb, documents=docs, device="cpu")
    return index, emb, synth.queries_near_corpus(rng, emb, 8)


def _port_build(index, *, admission, max_batch=4, clock=None, **config_kw):
    kw = {"clock": clock} if clock is not None else {}
    eng = ServeEngine(
        index,
        config=EngineConfig(max_batch=max_batch, max_wait_s=30.0,
                            admission=admission, **config_kw),
        sessions=SessionManager(rlwe_params=TP, deterministic_seeds=True,
                                device="cpu"), **kw)
    for t in ref_admission.TENANTS:
        eng.open_session(t, n=ref_admission.DIM, N=ref_admission.N_DOCS,
                         k=ref_admission.K, radius=0.05, backend="rlwe")
    return eng


@pytest.mark.parametrize("name", _tests(ref_admission))
def test_reference_admission_suite(name, monkeypatch, port_corpus):
    for attr, value in dict(
            _build=_port_build, AdmissionConfig=AdmissionConfig,
            AdmissionError=AdmissionError, InvalidEmbedding=InvalidEmbedding,
            QueueFull=QueueFull, RateLimited=RateLimited,
            UnknownTenant=UnknownTenant, adm=adm,
            jax=SimpleNamespace(random=SimpleNamespace(PRNGKey=int))).items():
        monkeypatch.setattr(ref_admission, attr, value)
    _call(getattr(ref_admission, name), corpus=port_corpus)
