"""Static-batch greedy generation through the port's LM serving path.

`Generator` serves token-id prompts with a `repro_torch.models.transformer
.Transformer`: ``submit`` queues a prompt; each ``step`` runs either one
prefill (`Transformer.prefill` with ``last_only``) of up to ``max_batch``
queued prompts of one length, which opens a batch and gives its first
answer token, or one `Transformer.decode_step` of the open batch through
its cache.  Every answer is ``answer_len`` greedy tokens (no stop token),
so a batch finishes after ``answer_len - 1`` decode steps, and that step
returns its results.  The next tokens, the served tokens and their logits
stay on the device until the batch finishes: one copy to the host a
batch.  ``drain`` steps until nothing is queued or open; ``pending``
counts queued and open requests.

On CUDA, for a bfloat16 model, the decode step is a CUDA graph: for each
(lanes, prompt length) the generator keeps one cache
(`Transformer.init_cache`), which every such batch's prefill writes
into, a device-side cache length, and the graph of one `decode_step`
over them, captured at that shape's first decode step (the warm-up's,
where the caller warms up its shapes); a step copies its input tokens
in, replays the graph and advances the length.  Elsewhere (the CPU; a
float32 MoE on CUDA, whose grouped products wait for the host) the step
runs eagerly over the batch's own cache.

A result (`Generation`) carries its served tokens (int32), each served
token's logit in float32 (the logit the model computed, in its dtype),
and a `Transcript`: the token ids in and out, 4 bytes each.

With a tracer (`repro_torch.obs.Tracer`), each step records a host span,
``prefill`` or ``decode`` with ``lanes``; on CUDA the step then waits for
the card, and records its device span between timing events around it
(``prefill_device`` / ``decode_device``, `obs.BoundTracer`'s marks) and,
for a decode step, each layer's ``<mark>_device`` spans of its attention
and its MLP (``mla`` / ``attn``, then ``moe`` / ``mlp``: see
`Transformer.decode_step`'s ``probe``), from timing events captured in
the graph.  An ``experts_touched`` record gives in ``count`` the distinct
routed experts the decode step's MoE layers read, summed over them.  With
no tracer none of this runs, and no step waits for the card.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import DEVICE_TRACK, NULL_TRACER

TOKEN_BYTES = 4          # an int32 token id on the wire


@dataclasses.dataclass(frozen=True)
class Transcript:
    """Bytes on the wire: the prompt's ids in, the answer's ids out."""
    request_bytes: int
    reply_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.request_bytes + self.reply_bytes


@dataclasses.dataclass
class Generation:
    request_id: int
    ok: bool
    tokens: np.ndarray          # (answer_len,) int32, the served answer
    logits: np.ndarray          # (answer_len,) float32, each one's logit
    transcript: Transcript
    tenant: object = None


class _Probe:
    """`Transformer.decode_step`'s probe in a traced step: a timing event
    at each mark (external, so that a graph capture keeps it as a node
    recorded at every replay), and each MoE layer's count of distinct
    experts, kept on the device."""

    def __init__(self, device):
        self.device = device
        self.marks: List[Tuple[str, Optional[torch.cuda.Event]]] = []
        self.touched: List[torch.Tensor] = []

    def mark(self, stage: str) -> None:
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record()
        self.marks.append((stage, ev))

    def experts(self, n: torch.Tensor) -> None:
        self.touched.append(n)


@dataclasses.dataclass
class _Graph:
    """One (lanes, prompt length)'s decode step on CUDA."""
    cache: dict                 # the cache tensors, written in place
    length: torch.Tensor        # 0-d int64: positions cached
    tokens: torch.Tensor        # (B, 1) int64: the step's input
    graph: Optional[torch.cuda.CUDAGraph] = None
    logits: Optional[torch.Tensor] = None
    probe: Optional[_Probe] = None
    touched: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _Batch:
    rids: list
    tenants: list
    prompt_len: int
    cache: Optional[dict]       # eager decode's cache
    graph: Optional[_Graph]     # or the graph's
    tokens: torch.Tensor        # (B, answer_len) served ids
    logits: torch.Tensor        # (B, answer_len) float32
    done: int = 0               # answer tokens produced


class Generator:
    """Greedy static batches over ``model`` (see the module docstring).
    Prompts are 1-D integer tensors on the model's device; a batch takes
    the queued prompts of the first one's length, up to ``max_batch``."""

    def __init__(self, model, *, max_batch: int, answer_len: int,
                 tracer=None):
        if max_batch < 1 or answer_len < 1:
            raise ValueError("max_batch and answer_len must be positive")
        self.model = model
        self.max_batch, self.answer_len = max_batch, answer_len
        self.device = model.device
        self.vocab = model.cfg.vocab
        self.tracer = tracer if tracer is not None and tracer.enabled \
            else None
        self._queue: deque = deque()
        self._batch: Optional[_Batch] = None
        self._last: Optional[torch.Tensor] = None   # (B, 1) next inputs
        self._graphs: Dict[tuple, _Graph] = {}
        self._graphed = (self.device.type == "cuda"
                         and model.cfg.torch_dtype == torch.bfloat16)
        self._next_id = 0

    # -- requests --------------------------------------------------------

    def submit(self, tenant, prompt: torch.Tensor, key=None) -> int:
        """Queue ``prompt`` (1-D token ids); returns its request id.
        ``key`` is taken for the serving interface and unused: decoding
        is greedy."""
        if prompt.dim() != 1 or prompt.numel() == 0:
            raise ValueError("a prompt is a non-empty 1-D tensor of ids")
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, tenant, prompt))
        return rid

    @property
    def pending(self) -> int:
        running = len(self._batch.rids) if self._batch is not None else 0
        return len(self._queue) + running

    def step(self) -> List[Generation]:
        """One prefill or one decode step; the results of a batch that
        finished in it."""
        if self._batch is None:
            if not self._queue:
                return []
            self._prefill()
        else:
            self._decode()
        if self._batch.done == self.answer_len:
            return self._finish()
        return []

    def drain(self) -> List[Generation]:
        out: List[Generation] = []
        while self._queue or self._batch is not None:
            out.extend(self.step())
        return out

    def close(self) -> None:
        """Drop the open batch, the queue, the graphs and the model."""
        self._queue.clear()
        self._batch = self._last = None
        self._graphs.clear()
        self.model = None

    # -- steps -----------------------------------------------------------

    def _take(self) -> list:
        s = self._queue[0][2].numel()
        picked, rest = [], deque()
        while self._queue:
            item = self._queue.popleft()
            if len(picked) < self.max_batch and item[2].numel() == s:
                picked.append(item)
            else:
                rest.append(item)
        self._queue = rest
        return picked

    def _emit(self, logits: torch.Tensor) -> None:
        """The greedy token of each row, recorded with its logit, and kept
        as the next step's input."""
        b = self._batch
        logits = logits[:, :self.vocab]
        nxt = torch.argmax(logits, dim=-1)
        b.tokens[:, b.done] = nxt.to(b.tokens.dtype)
        b.logits[:, b.done] = logits.gather(1, nxt[:, None])[:, 0].float()
        b.done += 1
        self._last = nxt[:, None]

    def _graph_for(self, lanes: int, prompt_len: int) -> _Graph:
        key = (lanes, prompt_len)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _Graph(
                cache=self.model.init_cache(lanes,
                                            prompt_len + self.answer_len),
                length=torch.zeros((), dtype=torch.int64, device=self.device),
                tokens=torch.zeros((lanes, 1), dtype=torch.int64,
                                   device=self.device))
        return g

    def _prefill(self) -> None:
        picked = self._take()
        prompts = torch.stack([p for _, _, p in picked])
        n, s = prompts.shape
        tr, dev = self.tracer, self.device
        with (tr or NULL_TRACER).span("prefill", lanes=n):
            bound = self._start()
            g = self._graph_for(n, s) if self._graphed else None
            logits, cache = self.model.prefill(
                prompts, s + self.answer_len, last_only=True,
                cache=None if g is None else g.cache)
            if g is not None:
                g.length.fill_(s)
                cache = None
            self._batch = _Batch(
                rids=[r for r, _, _ in picked],
                tenants=[t for _, t, _ in picked], prompt_len=s, cache=cache,
                graph=g,
                tokens=torch.zeros((n, self.answer_len), dtype=torch.int32,
                                   device=dev),
                logits=torch.zeros((n, self.answer_len), dtype=torch.float32,
                                   device=dev))
            self._emit(logits)
            self._end(bound, "prefill", n)

    def _decode(self) -> None:
        b = self._batch
        tr = self.tracer
        with (tr or NULL_TRACER).span("decode", lanes=len(b.rids)):
            bound = self._start()
            g = b.graph
            if g is None:
                probe = _Probe(self.device) if tr else None
                if probe:
                    probe.mark("start")
                logits, b.cache = self.model.decode_step(self._last, b.cache,
                                                         probe=probe)
                touched = (torch.stack(probe.touched).sum()
                           if probe and probe.touched else None)
            else:
                if g.graph is None:
                    self._capture(g)
                g.tokens.copy_(self._last)
                g.graph.replay()
                g.length += 1
                logits, probe, touched = g.logits, g.probe, g.touched
            self._emit(logits)
            self._end(bound, "decode", len(b.rids), probe, touched)

    def _capture(self, g: _Graph) -> None:
        """Capture ``g``'s decode step, with the probe's events in a traced
        generator, after one eager step on a side stream (lazy set-ups),
        both at the current length and tokens, which the step writes into
        the cache as the replay then does again."""
        g.tokens.copy_(self._last)
        cache = {**g.cache, "len": g.length}
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.model.decode_step(g.tokens, cache)
        main.wait_stream(side)
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph):
            g.probe = _Probe(self.device) if self.tracer else None
            if g.probe:
                g.probe.mark("start")
            g.logits, _ = self.model.decode_step(g.tokens, cache,
                                                 probe=g.probe)
            if g.probe and g.probe.touched:
                g.touched = torch.stack(g.probe.touched).sum()

    def _start(self):
        """A traced step's binding, its start mark recorded."""
        if self.tracer is None:
            return None
        bound = self.tracer.bind(device=self.device)
        bound.mark_device("start", self.device)
        return bound

    def _end(self, bound, kind: str, lanes: int, probe=None,
             touched=None) -> None:
        """A traced step's end: wait for the card, then its device spans
        and expert count."""
        if bound is None:
            return
        bound.mark_device(kind, self.device)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
            bound.anchor_device()
            torch.cuda.current_stream(self.device).synchronize()
            bound.record_device_spans([kind], lanes=lanes)
            if probe is not None and probe.marks:
                ends = [bound.device_time(ev) for _, ev in probe.marks]
                for (stage, _), t0, t1 in zip(probe.marks[1:], ends,
                                              ends[1:]):
                    bound.record(f"{stage}_device", t0, t1,
                                 track=DEVICE_TRACK, lanes=lanes)
        if touched is not None:
            now = bound.clock()
            bound.record("experts_touched", now, now, count=int(touched))

    def _finish(self) -> List[Generation]:
        b = self._batch
        self._batch = None
        tokens = b.tokens.cpu().numpy()
        logits = b.logits.cpu().numpy()
        sent = Transcript(request_bytes=TOKEN_BYTES * b.prompt_len,
                          reply_bytes=TOKEN_BYTES * self.answer_len)
        return [Generation(request_id=rid, ok=True, tokens=tokens[j],
                           logits=logits[j], transcript=sent, tenant=t)
                for j, (rid, t) in enumerate(zip(b.rids, b.tenants))]


__all__ = ["Generator", "Generation", "Transcript", "TOKEN_BYTES"]
