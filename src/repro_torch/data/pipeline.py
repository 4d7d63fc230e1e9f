"""Deterministic, stateless-resumable token data pipeline (the port's own
copy of :mod:`repro.data.pipeline`: numpy only, the same batches bit for
bit).

Design constraints for 1000+-node fleets:

* **Stateless sampling** — batch ``i`` is a pure function of ``(seed, i)``,
  so restarts need only the step counter from the checkpoint (no shard
  cursors to persist, no coordination on restore, elastic re-sharding is a
  pure re-index).
* **Host sharding** — each host materializes only its slice of the global
  batch, keyed by (data-axis index, pod index).
* **Prefetch** — a double-buffered iterator overlaps host batch synthesis
  with device compute.

The generator is a synthetic LM stream (hash-mixed token ids with a Zipfian
marginal, documents delimited by EOS) — self-contained so the framework has
no external data dependency, while exercising the same code paths a real
loader would (sharding, prefetch, checkpointable position).
"""

from __future__ import annotations

import dataclasses
import threading
import queue
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class PipelineState:
    """Everything needed to resume: goes into the checkpoint."""
    seed: int
    step: int


class TokenPipeline:
    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, host_index: int = 0, host_count: int = 1,
                 prefetch: int = 2):
        assert global_batch % host_count == 0, (global_batch, host_count)
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count
        self.prefetch = prefetch

    # -- stateless batch synthesis ---------------------------------------
    def batch_at(self, step: int) -> dict:
        """Batch for global step ``step`` — pure function of (seed, step).

        Each *global row* gets its own counter-based stream (Philox keyed
        by (seed, step, row)), so any host materializes exactly its rows
        and the union over hosts is bit-identical to a single-host run —
        the property that makes elastic rescaling a pure re-index."""
        row0 = self.host_index * self.local_batch
        toks = np.empty((self.local_batch, self.seq_len + 1), np.int64)
        eos = np.empty((self.local_batch, self.seq_len + 1), bool)
        for i in range(self.local_batch):
            rng = np.random.default_rng(np.random.Philox(
                key=(self.seed << 32) ^ (step * 0x9E3779B1) ^ (row0 + i)))
            # Zipf-ish marginal (real-text-like rank-frequency)
            toks[i] = rng.zipf(1.3, size=self.seq_len + 1)
            eos[i] = rng.random(self.seq_len + 1) < 1e-3
        tokens = (toks + np.arange(row0, row0 + self.local_batch)[:, None]
                  * 131071) % (self.vocab_size - 2) + 2
        tokens = np.where(eos, 1, tokens).astype(np.int32)
        return {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
            "segment_ids": np.cumsum(tokens == 1, axis=1)[:, :-1]
                             .astype(np.int32),
        }

    # -- prefetching iterator ---------------------------------------------
    def iterate(self, start_step: int = 0,
                stop_step: Optional[int] = None) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                if stop_step is not None and step >= stop_step:
                    q.put(None)
                    return
                q.put((step, self.batch_at(step)))
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item[1]
        finally:
            stop.set()

    def state(self, step: int) -> PipelineState:
        return PipelineState(seed=self.seed, step=step)

    @classmethod
    def restore(cls, state: PipelineState, **kwargs) -> "TokenPipeline":
        return cls(seed=state.seed, **kwargs)
