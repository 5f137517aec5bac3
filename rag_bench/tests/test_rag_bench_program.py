"""A configuration that brings its own program runs through the harness
with files alone: a toy configuration, written outside ``rag_bench/``
(a config, a module with ``make_program``, a cell and a traffic mix), is
found by name and run for one second on the CPU, and its check decides
``correct``."""

import io
import json
import textwrap

import pytest
import torch

from rag_bench import harness, manifest

PROGRAM = textwrap.dedent('''
    """A one-layer map served in batches: y = tanh(x @ W)."""
    import dataclasses

    import torch


    @dataclasses.dataclass
    class Transcript:
        total_bytes: int


    @dataclasses.dataclass
    class Result:
        request_id: int
        ok: bool
        y: torch.Tensor
        transcript: Transcript


    def _weights_and_pool(cfg, seed, device):
        g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
        d = cfg["dim"]
        w = torch.randn(d, d, generator=g, device=device) / d ** 0.5
        return w, torch.randn(cfg["pool"], d, generator=g, device=device)


    class Map:
        def __init__(self, cfg, cell, seed, device):
            self.cfg, self.device = cfg, device
            self.w, self.pool = _weights_and_pool(cfg, seed, device)
            self.tenants = list(range(cfg["tenants"]))
            self.shapes = {"dim": cfg["dim"]}
            self.queue, self.next_id = [], 0
            for size in cell["warmup"]:
                for j in range(size):
                    self.submit(self.tenants[j % len(self.tenants)],
                                self.pool[j], j)
                self.drain()

        def submit(self, tenant, payload, key):
            self.queue.append((self.next_id, payload))
            self.next_id += 1
            return self.next_id - 1

        @property
        def pending(self):
            return len(self.queue)

        def step(self):
            n = self.cfg["max_batch"]
            batch, self.queue = self.queue[:n], self.queue[n:]
            if not batch:
                return []
            x = torch.stack([p for _, p in batch])
            y = torch.tanh(x @ self.w)
            return [Result(rid, True, y[j], Transcript(8 * x.shape[1]))
                    for j, (rid, _) in enumerate(batch)]

        def drain(self):
            out = []
            while self.queue:
                out += self.step()
            return out

        def close(self):
            self.w = None

        def check(self, run, served, sched, seed):
            w, pool = _weights_and_pool(self.cfg, seed, self.device)
            gap = 0.0
            for i, r in served.items():
                ref = torch.tanh(pool[int(sched.query[i])] @ w)
                gap = max(gap, float((r.y - ref).abs().max()))
            return {"missing": len(run.due) - len(served), "out_gap": gap}


    def make_program(cfg, cell, seed, device, tracer):
        return Map(cfg, cell, seed, device)
''')

BENCH = {
    "workloads": [{"name": "toy-map-closed", "config": "toy-map",
                   "traffic": "closed-4", "chips": 1, "why": "a toy"}],
    "end_to_end": [
        {"name": "throughput_rps", "unit": "req/s", "better": "higher",
         "bound": 0.25, "source": "host_clock"},
        {"name": "wire_kb_per_request", "unit": "kB/req", "better": "lower",
         "bound": 0.01, "source": "host_clock"},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"}],
    "per_layer": [],
}


def _files(root):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's files in ``tmp_path``, which the manifest then reads in
    place of ``rag_bench/``; the metric readers are the benchmark's own."""
    def write(kind, name, text):
        (tmp_path / kind).mkdir(exist_ok=True)
        (tmp_path / kind / name).write_text(text)

    cell = {"config": "toy-map", "traffic": "closed-4", "warmup": [4],
            "limits": {"missing": 0, "out_gap": 1e-6}}
    write("configs", "toy-map.json", json.dumps(
        {"name": "toy-map", "dim": 16, "pool": 32, "tenants": 2,
         "max_batch": 4}))
    write("configs", "toy-map.py", PROGRAM)
    write("traffic", "closed-4.json", json.dumps({"kind": "closed",
                                                  "clients": 4}))
    write("cells", "toy-map-closed.json", json.dumps(cell))
    write("cells", "toy-map-short.json", json.dumps(
        {**cell, "limits": {"missing": 0}}))
    (tmp_path / "metrics").symlink_to(manifest.HERE / "metrics")
    before = _files(manifest.HERE)
    monkeypatch.setattr(manifest, "HERE", tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    monkeypatch.undo()
    assert _files(manifest.HERE) == before


def _run(cell="toy-map-closed", fault=None):
    return harness.run_cell(cell, seed=2**31 + 17, seconds=1.0, trace=False,
                            device="cpu", bench=BENCH, fault=fault,
                            log=io.StringIO())


def test_a_program_of_its_own_runs_and_is_correct(toy):
    out = _run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out["checks"]) == ["missing", "out_gap"]
    assert set(out["metrics"]) == {"throughput_rps", "wire_kb_per_request",
                                   "setup_s"}
    assert out["metrics"]["wire_kb_per_request"]["value"] == 0.128


def test_an_output_altered_where_it_is_produced(toy):
    def fault(program):
        step = program.step

        def altered():
            results = step()
            for r in results:
                r.y = r.y + 1e-3
            return results
        program.step = altered

    out = _run(fault=fault)
    assert not out["correct"]
    assert out["checks"]["out_gap"]["value"] > out["checks"]["out_gap"]["limit"]


def test_a_check_without_a_limit_raises(toy):
    with pytest.raises(ValueError, match="limits"):
        _run("toy-map-short")
