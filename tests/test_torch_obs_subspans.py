"""The port's sub-spans inside the batched round's blocking points, its
profiler ranges and its device track, on the CPU.

A traced `ServeEngine` batch records ``decrypt_wait`` / ``decrypt_copy`` /
``decrypt_crt`` inside ``decrypt``, ``encrypt_draw`` inside each lane's
``encrypt`` and, where the first stage keeps fewer candidates a tile than
k', ``topk_certificate`` inside ``topk``; tracing changes no result; the
NULL tracer records and opens nothing.  The device marks' arithmetic is
held here with stand-in events (a CUDA event cannot exist on the CPU);
``tests/test_torch_cuda.py`` holds the marks to a profiler trace on the
card."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.crypto import rlwe
from repro_torch.data import synth
from repro_torch.kernels.scoretopk import ops as sops
from repro_torch.obs import trace
from repro_torch.retrieval.index import FlatIndex
from repro_torch.serve import EngineConfig, ServeEngine, batching
from repro_torch.serve.session import SessionManager

N_DOCS, DIM, K = 500, 64, 4
N_REQ = 6
TENANTS = ("alice", "bob")
TP = rlwe.RlweParams(n_poly=1024, chunk=512)
SUB = {"decrypt_wait": "decrypt", "decrypt_copy": "decrypt",
       "decrypt_crt": "decrypt", "encrypt_draw": "encrypt",
       "topk_certificate": "topk"}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    emb = synth.uniform_corpus(rng, N_DOCS, DIM)
    docs = [f"passage-{i}".encode() for i in range(N_DOCS)]
    return emb, docs, synth.queries_near_corpus(rng, emb, N_REQ)


@pytest.fixture
def small_tiles(monkeypatch):
    """The first stage in 8-row tiles, so k' (17 here) exceeds a tile's
    candidates and the certificate runs."""
    real = sops.topk_scores
    monkeypatch.setattr(sops, "topk_scores",
                        lambda q, c, k, **kw: real(q, c, k,
                                                   **{**kw, "tile": 8}))


def _run(corpus, **config_kw):
    emb, docs, queries = corpus
    eng = ServeEngine(
        FlatIndex.build(emb, documents=docs, device="cpu"),
        config=EngineConfig(max_batch=N_REQ, max_wait_s=30.0, **config_kw),
        sessions=SessionManager(rlwe_params=TP, deterministic_seeds=True,
                                device="cpu"))
    for t in TENANTS:
        eng.open_session(t, n=DIM, N=N_DOCS, k=K, radius=0.05)
    for i, q in enumerate(queries):
        eng.submit(TENANTS[i % len(TENANTS)], q, key=i)
    got = eng.drain()
    eng.close()
    return eng, got


def _parent(span, spans):
    """The span ``span`` nests in: its parent's name, same batch (and
    request, on a request track), enclosing interval."""
    return [p for p in spans if p.name == SUB[span.name]
            and p.batch_id == span.batch_id
            and p.request_id == span.request_id
            and p.t_start <= span.t_start and span.t_end <= p.t_end]


@pytest.mark.usefixtures("small_tiles")
def test_subspans_nest_inside_their_parents(corpus):
    eng, got = _run(corpus, trace=True)
    assert all(r.ok for r in got)
    spans = eng.tracer.spans()
    kprime = eng.sessions.get("alice").plan.kprime
    assert kprime > 8
    subs = [s for s in spans if s.name in SUB]
    assert {s.name for s in subs} == set(SUB)
    for s in subs:
        assert s.batch_id is not None
        assert len(_parent(s, spans)) == 1, s
        obs.validate_attrs(s.attrs)
        assert set(s.attrs) <= obs.ALLOWED_ATTR_KEYS
    draws = [s for s in subs if s.name == "encrypt_draw"]
    assert sorted(s.attrs["lane"] for s in draws) == list(range(N_REQ))
    assert all(s.track == f"request-{s.request_id}" for s in draws)
    for dec in (s for s in spans if s.name == "decrypt"):
        parts = [s for s in subs if s.name.startswith("decrypt_")
                 and s.batch_id == dec.batch_id]
        assert len(parts) == 3
        assert sum(p.duration_s for p in parts) <= dec.duration_s
        by = {p.name: p.attrs for p in parts}
        assert by["decrypt_wait"]["lanes"] == dec.attrs["lanes"]
        assert by["decrypt_crt"]["num_cands"] == dec.attrs["lanes"] * kprime
        # the scores: (lanes, k') float64
        assert by["decrypt_copy"]["bytes"] == dec.attrs["lanes"] * kprime * 8
    cert = [s for s in subs if s.name == "topk_certificate"]
    assert [c.attrs["kprime"] for c in cert] == [kprime] * len(cert)
    assert all(c.attrs["ok"] is True for c in cert)
    # the CPU engine marks no device step
    assert not [s for s in spans if s.track == obs.DEVICE_TRACK]


def test_traced_and_untraced_engines_agree_bit_for_bit(corpus):
    eng, traced = _run(corpus, trace=True)
    _, plain = _run(corpus)
    assert {s.name for s in eng.tracer.spans()} >= set(SUB) - {
        "topk_certificate"}
    for a, b in zip(traced, plain):
        assert a.request_id == b.request_id and a.ok and b.ok
        assert np.asarray(a.ids).tolist() == np.asarray(b.ids).tolist()
        assert a.docs == b.docs
        assert a.transcript == b.transcript


@pytest.mark.parametrize("k,want", [(40, None), (100, True), (10, False)])
def test_certificate_span_only_when_a_tile_keeps_fewer_than_k(k, want):
    """tile 64 over 512 rows: k = 40 needs no certificate; k = 100 keeps
    64 a tile and is certified exact; with 4 a tile and k = 10 the ten
    best rows all sit in tile 0, so the certificate says not exact."""
    g = torch.Generator().manual_seed(1)
    corpus = torch.randn(512, 8, generator=g)
    q = torch.randn(3, 8, generator=g)
    per_tile = 4 if want is False else None
    if want is False:
        corpus[:10] = q[0] * 10 + torch.arange(10.0)[:, None] * 1e-3
        q = q[:1]
    tracer = obs.Tracer()
    out = sops.topk_scores(q, corpus, k, tile=64, per_tile_k=per_tile,
                           tracer=tracer.bind(batch_id=7))
    spans = [s for s in tracer.spans() if s.name == "topk_certificate"]
    if want is None:
        assert spans == [] and out.exact is True
        return
    (span,) = spans
    assert out.exact is want and span.attrs["ok"] is want
    assert span.attrs == {"lanes": q.shape[0], "kprime": k, "ok": want}
    assert span.batch_id == 7


def test_certificate_span_reaches_through_the_batched_search(corpus):
    emb, docs, queries = corpus
    index = FlatIndex.build(emb, documents=docs, device="cpu")
    tracer = obs.Tracer()
    q = torch.from_numpy(np.asarray(queries[:2], np.float32))
    res = batching.topk_batch(index, q, 300, tracer=tracer)
    assert [s.name for s in tracer.spans()] == []     # 300 < one tile
    index = FlatIndex.build(np.concatenate([emb] * 5), device="cpu")
    res = batching.topk_batch(index, q, 2100, tracer=tracer)
    (span,) = tracer.spans()
    assert span.name == "topk_certificate"
    assert span.attrs == {"lanes": 2, "kprime": 2100, "ok": res.exact}


def _ranges(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()
            if e.name.startswith("repro_torch/")]


def test_spans_open_profiler_ranges_and_null_tracer_nothing():
    sk = rlwe.keygen(TP, np.random.default_rng(0), device="cpu")
    e = synth.uniform_corpus(np.random.default_rng(1), 1, DIM)[0]

    def encrypt(tracer):
        return lambda: rlwe.encrypt_query(sk, e, np.random.default_rng(2),
                                          tracer=tracer)

    null = obs.NULL_TRACER
    assert null.bind(batch_id=1, device="cpu") is null
    assert null.mark_device("decrypt", "cpu") is None
    assert null.record_device_spans(("decrypt",)) == 0
    assert _ranges(encrypt(null)) == []
    assert null.spans() == []
    tracer = obs.Tracer()
    assert _ranges(encrypt(tracer.bind(lane=3))) == [
        "repro_torch/encrypt_draw"]
    with null.span("stage") as late:
        assert late is None
    with tracer.span("stage") as late:
        late["ok"] = False
    names = [s.name for s in tracer.spans()]
    assert names == ["encrypt_draw", "stage"]
    assert tracer.spans()[-1].attrs == {"ok": False}
    ct_a = rlwe.encrypt_query(sk, e, np.random.default_rng(2),
                              tracer=tracer)
    ct_b = rlwe.encrypt_query(sk, e, np.random.default_rng(2))
    assert torch.equal(ct_a.c0, ct_b.c0) and torch.equal(ct_a.c1, ct_b.c1)


class _FakeEvent:
    """A stand-in for a completed CUDA timing event at device time ``t``
    (seconds)."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3

    def query(self):
        return self.done


def _bound(marks, anchor, clock_at):
    tracer = obs.Tracer(clock=lambda: clock_at)
    bound = tracer.bind(batch_id=5)
    bound._marks = trace._DeviceMarks()
    bound._marks.marks = [(s, _FakeEvent(t)) for s, t in marks]
    bound._marks.anchor = (anchor, clock_at)
    return tracer, bound


def test_device_marks_map_onto_the_tracer_clock():
    """Device times 1.0 .. 1.5 s, the anchor at device 1.6 s read at host
    100.0 s: the spans tile 99.4 .. 99.9 s on the device track."""
    stages = ("perturb", "topk", "encrypt", "score", "decrypt")
    marks = [("start", 1.0)] + [(s, 1.0 + 0.1 * (i + 1))
                                for i, s in enumerate(stages)]
    tracer, bound = _bound(marks, _FakeEvent(1.6), 100.0)
    assert bound.record_device_spans(stages, lanes=4) == 5
    spans = tracer.spans()
    assert [s.name for s in spans] == [f"{s}_device" for s in stages]
    assert all(s.track == obs.DEVICE_TRACK and s.batch_id == 5
               and s.attrs == {"lanes": 4} for s in spans)
    for i, s in enumerate(spans):
        assert s.t_start == pytest.approx(99.4 + 0.1 * i)
        assert s.duration_s == pytest.approx(0.1)
    for a, b in zip(spans, spans[1:]):
        assert a.t_end == pytest.approx(b.t_start)


@pytest.mark.parametrize("case", ["repeated", "missing", "pending",
                                  "no_anchor"])
def test_device_marks_out_of_shape_record_nothing(case):
    stages = ("perturb", "decrypt")
    marks = [("start", 1.0), ("perturb", 1.1), ("decrypt", 1.2)]
    if case == "repeated":
        marks.append(("decrypt", 1.3))     # a re-run decryption
    if case == "missing":
        marks.pop(1)
    tracer, bound = _bound(marks, _FakeEvent(1.5, case != "pending"), 9.0)
    if case == "no_anchor":
        bound._marks.anchor = None
    assert bound.record_device_spans(stages) == 0
    assert tracer.spans() == []


def test_chrome_export_puts_the_device_track_on_its_own_row(tmp_path):
    spans = [
        trace.Span(name="dispatch", track="engine", t_start=1.0,
                   duration_s=0.5, batch_id=0),
        trace.Span(name="decrypt", track="engine", t_start=1.3,
                   duration_s=0.2, batch_id=0, attrs={"lanes": 2}),
        trace.Span(name="score_device", track=obs.DEVICE_TRACK,
                   t_start=1.1, duration_s=0.1, batch_id=0,
                   attrs={"lanes": 2}),
        trace.Span(name="decrypt_device", track=obs.DEVICE_TRACK,
                   t_start=1.2, duration_s=0.15, batch_id=0,
                   attrs={"lanes": 2}),
    ]
    path = tmp_path / "trace.json"
    assert obs.write_chrome_trace(str(path), spans) == 4
    events = obs.load_chrome_trace(str(path))["traceEvents"]
    dur = {e["name"]: e for e in events if e["ph"] == "X"}
    host = {(dur[n]["pid"], dur[n]["tid"]) for n in ("dispatch", "decrypt")}
    dev = {(dur[n]["pid"], dur[n]["tid"]) for n in ("score_device",
                                                    "decrypt_device")}
    assert len(host) == len(dev) == 1 and host != dev
    (dev_pid, _), = dev
    (host_pid, _), = host
    assert dev_pid != host_pid
    meta = [e for e in events if e["ph"] == "M"]
    assert {(m["name"], m["pid"], m["args"]["name"]) for m in meta} == {
        ("thread_name", host_pid, "engine"),
        ("process_name", dev_pid, obs.DEVICE_TRACK),
        ("thread_name", dev_pid, obs.DEVICE_TRACK)}
    assert dur["decrypt_device"]["args"] == {"lanes": 2, "batch_id": 0}
    assert dur["score_device"]["ts"] == pytest.approx(1e5)
