"""Batched serving loop with continuous batching (the counterpart of
:mod:`repro.runtime.serve`).

A fixed decode batch of ``num_slots`` sequences; when a sequence emits EOS,
reaches its token budget or the cache's end, its slot is refilled at once
from the request queue by a batch-1 prefill.  Slots decode at their own
positions (ragged); idle slots decode a dummy token at ``max_len - 1``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.graph import resolve_device


#: the families the loop refuses, and why
UNSERVED = {
    "vlm": "its prefill needs vision_embeds, which a Request does not "
           "carry (drive forward/decode_step directly)",
    "audio": "its prompts are [S, K] codebook tokens and its greedy pick "
             "is one token a codebook (drive forward/decode_step "
             "directly)",
}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # [S] token ids
    max_new_tokens: int = 32
    generated: Optional[list] = None


class ServeLoop:
    """Drives ``model.forward`` (prefill) and ``model.decode_step`` over a
    slot batch whose cache lives on ``device`` (default ``"cuda"``; it
    raises without a card).  The model must lie on the same device.

    It serves token models: a vision config (its prefill needs the
    frontend's embeddings, which a request does not carry) and an audio
    config (its tokens are [S, K] codebook rows, its greedy pick is one
    per codebook) are refused with a ``ValueError``.  The reference's
    loop accepts them and fails inside its prefill or its decode.

    Per call it records wall seconds, ending in a device sync:
    ``prefill_seconds`` (one per request) and ``decode_seconds`` (one per
    batched decode step); ``nonfinite_logits`` counts decode steps whose
    logits held a NaN or infinity."""

    def __init__(self, model, *, num_slots: int, max_len: int,
                 eos_id: int = 1, device="cuda"):
        family = model.cfg.family
        if family in UNSERVED:
            raise ValueError(f"ServeLoop serves token models, not "
                             f"{model.cfg.name} (family {family!r}): "
                             f"{UNSERVED[family]}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if model.device != self.device:
            raise ValueError(f"the model lies on {model.device}, the loop "
                             f"runs on {self.device}")
        self.model = model
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache = model.new_cache(num_slots, max_len)
        self.positions = np.zeros(num_slots, np.int64)   # next position
        self.active: List[Optional[Request]] = [None] * num_slots
        self.prefill_seconds: List[float] = []
        self.decode_seconds: List[float] = []
        self.nonfinite_logits = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fill_slot(self, slot: int, req: Request) -> None:
        """Batch-1 prefill into a fresh cache, written into the slot (every
        cache leaf keeps the batch on axis 0)."""
        self._sync()
        t0 = time.perf_counter()
        tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.int64,
                                 device=self.device)
        one = self.model.new_cache(1, self.max_len)
        self.model(tokens, cache=one)
        for full, new in zip(self.cache["layers"], one["layers"]):
            for key, leaf in new.items():
                full[key][slot].copy_(leaf[0])
        self._sync()
        self.prefill_seconds.append(time.perf_counter() - t0)
        self.positions[slot] = len(req.prompt)
        req.generated = []
        self.active[slot] = req

    def run(self, requests: List[Request]) -> List[Request]:
        """Run to completion; returns the requests, in order of finishing,
        with ``generated`` filled."""
        queue = list(requests)
        done: List[Request] = []
        for s in range(self.num_slots):
            if queue:
                self._fill_slot(s, queue.pop(0))
        while any(a is not None for a in self.active):
            last_tokens = np.zeros((self.num_slots, 1), np.int64)
            pos_vec = np.full(self.num_slots, self.max_len - 1, np.int64)
            for s, a in enumerate(self.active):
                if a is None:
                    continue
                last_tokens[s, 0] = (a.generated[-1] if a.generated
                                     else a.prompt[-1])
                pos_vec[s] = self.positions[s]
            t0 = time.perf_counter()
            logits, self.cache = self.model.decode_step(
                self.cache, torch.as_tensor(last_tokens, device=self.device),
                torch.as_tensor(pos_vec, device=self.device))
            # greedy: the first index of the largest logit
            nxt = torch.argmax(logits[:, 0], dim=-1)
            finite = torch.isfinite(logits).all()
            nxt, finite = nxt.cpu().numpy(), bool(finite)
            self.decode_seconds.append(time.perf_counter() - t0)
            self.nonfinite_logits += not finite
            for s, a in enumerate(self.active):
                if a is None:
                    continue
                tok = int(nxt[s])
                a.generated.append(tok)
                self.positions[s] += 1
                finished = (tok == self.eos_id
                            or len(a.generated) >= a.max_new_tokens
                            or self.positions[s] >= self.max_len - 1)
                if finished:
                    done.append(a)
                    self.active[s] = None
                    if queue:
                        self._fill_slot(s, queue.pop(0))
        return done
