"""The port's query-serving tier (the counterpart of
:mod:`repro.serve.server`): admission control + deadline-aware continuous
batching over :func:`repro_torch.core.engine.run_batch`.

The pipeline is the reference's:

1. **Admission** (:meth:`GraphServer.submit`): bounded queue depth;
   overload and already-expired deadlines are rejected *with a reason*
   (never silently dropped); a distance-cache hit completes immediately
   without traversal, bit-identical to a cold run by construction.
2. **Batching** (:meth:`GraphServer.step`): queued requests are ordered
   earliest-deadline-first (FIFO among equal deadlines), expired ones
   rejected, then the head-of-line request's compatibility group
   ``(graph, epoch, op, schedule, delta)`` is gathered, up to
   ``max_batch``, and the batch is rounded up to a power-of-two
   **K-bucket** (``run_batch(..., pad_to=)``).  On the card a fused
   server dispatches each BSP batch as ONE launch of the fused kernel
   with K-bucket rows, and each ``schedule="delta"`` batch as one
   single-row delta launch a row;
   :class:`repro_torch.serve.cache.ExecutableCache` records the buckets
   dispatched.
3. **Completion**: every real lane's distance row is returned, recorded
   in the :class:`repro_torch.serve.cache.DistanceCache` under the
   graph's current epoch, and observed into the latency reservoir.  A
   request finishing past its deadline still completes (counted
   ``deadline_misses``); only *queued* expiry rejects.

Multi-tenancy: several resident graphs (:meth:`GraphServer.load_graph`,
moved to the server's device once), each with a swap **epoch**; swapping
a graph bumps the epoch and fully invalidates both caches for that name.
All timing flows through an injected clock
(:mod:`repro_torch.serve.clock`).  The server runs on the card unless
``device="cpu"``; requests carry no backend (the device decides).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

import numpy as np

from repro_torch.core import engine, operators
from repro_torch.core.graph import resolve_device
from repro_torch.serve.cache import DistanceCache, ExecutableCache
from repro_torch.serve.clock import SystemClock
from repro_torch.serve.metrics import Metrics

#: admission-reject reasons (Response.reason; counted as
#: ``rejected:<reason>`` in the metrics)
REJECT_QUEUE_FULL = "queue_full"
REJECT_DEADLINE = "deadline_expired"
REJECT_UNKNOWN_GRAPH = "unknown_graph"

_NO_DEADLINE = float("inf")


def k_bucket(k: int, max_batch: int) -> int:
    """Round a batch size up to the next power of two, capped at
    ``max_batch`` — the serving analogue of
    :func:`repro_torch.core.worklist.bucket` (O(log max_batch) batch
    shapes per compatibility group)."""
    if k < 1:
        raise ValueError(f"batch size must be >= 1, got {k}")
    return min(1 << (k - 1).bit_length(), max_batch)


@dataclasses.dataclass
class Request:
    """One graph query.  ``deadline`` is *absolute* clock time (None =
    best-effort); the engine knobs default to the server's defaults and
    stay independently settable per request."""

    source: int
    graph: str = "default"
    op: str = "shortest_path"
    schedule: str = "bsp"
    delta: Optional[int] = None
    deadline: Optional[float] = None
    # -- filled in by the server at admission --
    id: int = -1
    submit_time: float = 0.0

    def group_key(self, epoch: int) -> tuple:
        """Batch-compatibility key: requests batch together iff equal."""
        return (self.graph, epoch, self.op, self.schedule, self.delta)

    @property
    def deadline_rank(self) -> float:
        return _NO_DEADLINE if self.deadline is None else self.deadline


@dataclasses.dataclass
class Response:
    """Terminal outcome of a request — completed or rejected, never
    silence."""

    request: Request
    status: str                       # "ok" | "rejected"
    reason: Optional[str] = None      # set iff rejected
    dist: Optional[np.ndarray] = None  # [N] distance row iff ok
    finish_time: float = 0.0
    cached: bool = False              # served from the distance cache
    batch_lanes: int = 0              # K-bucket of the dispatch it rode

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def latency(self) -> float:
        return self.finish_time - self.request.submit_time


class GraphServer:
    """Deadline-aware continuous batcher over resident graphs, on the
    card unless ``device="cpu"``."""

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 max_queue: int = 64, max_batch: int = 8,
                 mode: str = "fused", max_iterations: int = 100000,
                 executable_capacity: int = 16,
                 result_cache_capacity: int = 256, device="cuda"):
        if max_queue < 1 or max_batch < 1:
            raise ValueError("max_queue and max_batch must be >= 1")
        if mode not in ("stepped", "fused"):
            raise ValueError(
                f"mode must be 'stepped' or 'fused', got {mode!r}")
        self.device = resolve_device(device)
        self.clock = clock if clock is not None else SystemClock()
        self.max_queue = max_queue
        self.max_batch = max_batch
        self.mode = mode
        self.max_iterations = max_iterations
        self.metrics = Metrics()
        self.result_cache = DistanceCache(result_cache_capacity,
                                          self.metrics)
        self.executable_cache = ExecutableCache(executable_capacity,
                                                self.metrics)
        self._graphs: dict = {}            # name -> (CSRGraph, epoch)
        self._queue: list[Request] = []
        self._ids = itertools.count()

    # -- multi-tenant resident graphs -------------------------------------

    def load_graph(self, name: str, graph) -> int:
        """Make ``graph`` resident under ``name`` (on the server's
        device); re-loading an existing name is a **swap**: the epoch
        bumps and every cache entry for the name is invalidated (stale
        distances must never hit).  Returns the new epoch."""
        if name in self._graphs:
            epoch = self._graphs[name][1] + 1
            self.result_cache.invalidate_graph(name)
            self.executable_cache.invalidate_graph(name)
            self.metrics.inc("graph_swaps")
        else:
            epoch = 0
        self._graphs[name] = (graph.to(self.device), epoch)
        self.metrics.gauge("resident_graphs", len(self._graphs))
        return epoch

    def unload_graph(self, name: str) -> None:
        self._graphs.pop(name, None)
        self.result_cache.invalidate_graph(name)
        self.executable_cache.invalidate_graph(name)
        self.metrics.gauge("resident_graphs", len(self._graphs))

    def graph_epoch(self, name: str) -> int:
        return self._graphs[name][1]

    # -- admission ---------------------------------------------------------

    def submit(self, request: Request) -> Optional[Response]:
        """Admit (returns None — the request is queued), serve from cache
        (ok Response), or reject with a reason (rejected Response)."""
        now = self.clock()
        request.id = next(self._ids)
        request.submit_time = now
        self.metrics.inc("submitted")
        op = operators.resolve(request.op)   # raises on unknown op
        if request.schedule == "delta" and self.mode != "fused":
            raise ValueError(
                "schedule='delta' requests need a mode='fused' server "
                "(batched delta-stepping is fused-only)")
        engine._check_schedule(None, request.schedule, request.delta, op)
        if request.graph not in self._graphs:
            return self._reject(request, REJECT_UNKNOWN_GRAPH, now)
        if request.deadline is not None and request.deadline <= now:
            return self._reject(request, REJECT_DEADLINE, now)
        epoch = self._graphs[request.graph][1]
        row = self.result_cache.lookup(request.graph, epoch,
                                       request.source, request.op)
        if row is not None:
            self.metrics.inc("completed")
            self.metrics.observe_latency(0.0)
            return Response(request=request, status="ok", dist=row,
                            finish_time=now, cached=True)
        if len(self._queue) >= self.max_queue:
            return self._reject(request, REJECT_QUEUE_FULL, now)
        self._queue.append(request)
        self.metrics.inc("admitted")
        self.metrics.gauge("queue_depth", len(self._queue))
        return None

    def _reject(self, request: Request, reason: str,
                now: float) -> Response:
        self.metrics.inc("rejected_total")
        self.metrics.inc(f"rejected:{reason}")
        return Response(request=request, status="rejected", reason=reason,
                        finish_time=now)

    # -- batching ----------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def step(self) -> list[Response]:
        """One batcher turn: expire, pick the EDF head's group, dispatch
        one K-bucketed batch.  Returns every request that reached a
        terminal state this turn (rejected-expired + completed)."""
        now = self.clock()
        out: list[Response] = []
        live: list[Request] = []
        for r in self._queue:                      # queued-deadline sweep
            if r.deadline is not None and r.deadline <= now:
                out.append(self._reject(r, REJECT_DEADLINE, now))
            elif r.graph not in self._graphs:      # unloaded while queued
                out.append(self._reject(r, REJECT_UNKNOWN_GRAPH, now))
            else:
                live.append(r)
        self._queue = live
        if not self._queue:
            self.metrics.gauge("queue_depth", 0)
            return out
        # earliest deadline first; submission order among equals.  The
        # sort is stable and _queue is in submission order, so no seq key
        # is needed.
        self._queue.sort(key=lambda r: r.deadline_rank)
        head = self._queue[0]
        key = head.group_key(self._graphs[head.graph][1])
        batch = [r for r in self._queue
                 if r.group_key(self._graphs[r.graph][1]) == key]
        batch = batch[:self.max_batch]
        taken = set(id(r) for r in batch)
        self._queue = [r for r in self._queue if id(r) not in taken]
        self.metrics.gauge("queue_depth", len(self._queue))
        out.extend(self._dispatch(batch, key))
        return out

    def drain(self, max_steps: int = 100000) -> list[Response]:
        """Step until the queue empties; returns all terminal responses.

        Raises :class:`RuntimeError` if ``max_steps`` turns cannot empty
        the queue: silently returning would strand the queued requests
        without a terminal :class:`Response`, violating the "every
        submission reaches exactly one terminal Response" invariant
        (docs/serving.md) — the caller must either raise ``max_steps``
        or handle/reject the stragglers itself.  The responses already
        collected ride on the exception (``.responses``)."""
        out: list[Response] = []
        for _ in range(max_steps):
            if not self._queue:
                return out
            out.extend(self.step())
        if self._queue:
            err = RuntimeError(
                f"drain(max_steps={max_steps}) exhausted its step budget "
                f"with {len(self._queue)} request(s) still queued — "
                f"raising instead of silently dropping them (every "
                f"submission must reach exactly one terminal Response, "
                f"docs/serving.md); raise max_steps or step()/reject the "
                f"remainder explicitly")
            err.responses = out
            raise err
        return out

    def _dispatch(self, batch: list[Request], key: tuple) -> list[Response]:
        graph_name, epoch, op, schedule, delta = key
        graph = self._graphs[graph_name][0]
        lanes = k_bucket(len(batch), self.max_batch)
        self.executable_cache.admit(
            ExecutableCache.key(graph_name, epoch, op, schedule, delta,
                                lanes))
        res = engine.run_batch(
            graph, [r.source for r in batch], mode=self.mode, op=op,
            schedule=schedule, delta=delta, pad_to=lanes,
            max_iterations=self.max_iterations, device=self.device)
        finish = self.clock()
        self.metrics.inc("batches")
        self.metrics.inc("lanes_dispatched", lanes)
        self.metrics.inc("lanes_busy", len(batch))
        out = []
        for row, request in zip(res.dist, batch):
            self.result_cache.insert(graph_name, epoch, request.source,
                                     request.op, row)
            self.metrics.inc("completed")
            if request.deadline is not None and finish > request.deadline:
                self.metrics.inc("deadline_misses")
            self.metrics.observe_latency(finish - request.submit_time)
            served = np.array(row, copy=True)
            served.setflags(write=False)
            out.append(Response(request=request, status="ok", dist=served,
                                finish_time=finish, batch_lanes=lanes))
        return out

    # -- landmarks ---------------------------------------------------------

    def warm(self, graph_name: str, sources,
             op: str = "shortest_path") -> int:
        """Precompute + **pin** distance rows for hot sources (landmarks:
        the arXiv:1605.02043 "pin" class — never LRU-evicted, dropped
        only by a graph swap).  Dispatches through the same batcher path
        as served traffic so bucket reuse and occupancy accounting stay
        uniform.  Returns the number of rows pinned."""
        graph, epoch = self._graphs[graph_name]
        sources = [int(s) for s in sources]
        pinned = 0
        for start in range(0, len(sources), self.max_batch):
            chunk = sources[start:start + self.max_batch]
            lanes = k_bucket(len(chunk), self.max_batch)
            self.executable_cache.admit(
                ExecutableCache.key(graph_name, epoch, op, "bsp", None,
                                    lanes))
            res = engine.run_batch(graph, chunk, mode=self.mode, op=op,
                                   pad_to=lanes,
                                   max_iterations=self.max_iterations,
                                   device=self.device)
            self.metrics.inc("batches")
            self.metrics.inc("lanes_dispatched", lanes)
            self.metrics.inc("lanes_busy", len(chunk))
            for row, src in zip(res.dist, chunk):
                self.result_cache.insert(graph_name, epoch, src, op, row,
                                         pin=True)
                pinned += 1
        self.metrics.inc("landmarks_pinned", pinned)
        return pinned

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """The metric dict every consumer shares (the reference's
        keys)."""
        self.metrics.gauge("queue_depth", len(self._queue))
        self.metrics.gauge("resident_graphs", len(self._graphs))
        self.metrics.gauge("result_cache_size", len(self.result_cache))
        self.metrics.gauge("exec_cache_size", len(self.executable_cache))
        return self.metrics.snapshot()
