"""The reading of the profiler's events: busy time as a union, stage
device time by the launch's correlation id, idle time by the host's open
stage; and, on the card, a traced run that reports every metric."""

import io

import pytest
import torch

from conftest import SMALL_RAG
from rag_bench import devtrace

CPU, CUDA = "cpu", "cuda"


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, ann=False):
        self._v = (name, dev, start, dur, corr, ann)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[2] + self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_stage_time_follows_the_launch_not_the_run():
    ev = [
        Ev("topk", CPU, 0, 100, ann=True),
        Ev("cudaLaunchKernel", CPU, 10, 2, corr=7),
        Ev("cudaLaunchKernel", CPU, 20, 2, corr=8),
        Ev("decrypt", CPU, 100, 300, ann=True),
        Ev("cudaMemcpyAsync", CPU, 110, 2, corr=9),
        Ev("aten::mm", CPU, 10, 50, corr=8),      # a CPU op's own id space
        # two overlapping kernels of the top-k, the second running on
        # into the decrypt's time; a copy launched under the decrypt
        Ev("score_topk_kernel", CUDA, 30, 80, corr=7),
        Ev("merge", CUDA, 60, 70, corr=8),
        Ev("Memcpy DtoH", CUDA, 200, 50, corr=9),
        Ev("topk", CUDA, 30, 100, ann=True),      # the GPU-side range
    ]
    out = devtrace.analyse(ev, (0, 1000), CUDA)
    assert out["busy_s"] == pytest.approx(150e-9)    # (30, 130) + (200, 250)
    assert out["window_s"] == pytest.approx(1e-6)
    assert out["stage_device_s"] == pytest.approx({"topk": 100e-9,
                                                   "decrypt": 50e-9})
    names = [n for n, _ in out["device_ops"]]
    assert names == ["score_topk_kernel", "merge", "Memcpy DtoH"]
    idle = dict(out["idle_gaps"])
    assert idle["topk"] == pytest.approx(30e-9)           # (0, 30)
    assert idle["decrypt"] == pytest.approx(70e-9)        # (130, 200)
    assert idle["no stage"] == pytest.approx(750e-9)      # (250, 1000)


def test_operations_outside_the_window_are_clipped():
    ev = [Ev("k", CUDA, -50, 100, corr=1), Ev("k", CUDA, 990, 100, corr=2)]
    out = devtrace.analyse(ev, (0, 1000), CUDA)
    assert out["busy_s"] == pytest.approx(60e-9)
    assert out["stage_device_s"] == {}


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reports_every_metric():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rag_bench import harness, manifest
    small = {**SMALL_RAG, "num_docs": 100_000,
             "engine": {**SMALL_RAG["engine"], "max_batch": 8}}
    out = harness.run_cell("rag768-sat", seed=5, seconds=3.0, trace=True,
                           config_overrides=small, log=io.StringIO())
    assert out["correct"]
    want = {m["name"] for m in manifest.per_layer(manifest.benchmark(),
                                                  "rag768-sat")}
    assert set(out["metrics"]) == want
    for name, m in out["metrics"].items():
        if "roofline" in name:
            assert 0 < m["value"] <= 100
    assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]
