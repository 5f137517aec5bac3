"""repro_torch.obs — privacy-safe observability for the serving engine
(a copy of the framework-free ``repro.obs``).

`Tracer` records bounded per-request stage spans (see `repro_torch.obs.trace`
for the redact-by-construction schema), `StageHistogram` keeps fixed-
bucket per-stage latency profiles, and `repro_torch.obs.export` writes
Perfetto-loadable Chrome-trace timelines.  Tracing is off by default;
`NULL_TRACER` is the shared no-op sink.  `Tracer.bind` passes a tracer
down to sub-spans and, on CUDA, keeps a dispatch's device-side stage
ends (the ``device`` track).
"""

from repro_torch.obs.histogram import StageHistogram, summarize
from repro_torch.obs.trace import (ALLOWED_ATTR_KEYS, DEVICE_TRACK,
                                   NULL_TRACER, BoundTracer, NullTracer,
                                   Span, Tracer, validate_attrs)
from repro_torch.obs.export import (chrome_trace_events, load_chrome_trace,
                                    write_chrome_trace)

__all__ = [
    "ALLOWED_ATTR_KEYS", "DEVICE_TRACK", "NULL_TRACER", "BoundTracer",
    "NullTracer", "Span", "Tracer",
    "StageHistogram", "summarize", "validate_attrs",
    "chrome_trace_events", "load_chrome_trace", "write_chrome_trace",
]
