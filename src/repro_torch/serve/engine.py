"""Batched serving engine: slot-based continuous batching.

Counterpart of ``repro.serve.engine`` with the same scheduling, so that the
two engines give identical tokens and ``request_steps()`` on the same model:
requests occupy fixed slots of a shared KV cache; admitted prompts are
teacher-forced together, one ``decode_step`` per token *index*; each
``step()`` then advances every active slot by one token, one slot per
``decode_step`` (the other rows carry a filler token 0, written at their
current position and overwritten before those slots advance). Logits come
back to the host as float32 and the greedy argmax runs there.

The model's caches live on the engine's device and are updated in place.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    generated: list[int] = dataclasses.field(default_factory=list)
    #: engine step counter at submit / completion (for latency summaries)
    submit_step: int = 0
    done_step: Optional[int] = None

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return bool(self.generated and self.eos_id is not None
                    and self.generated[-1] == self.eos_id)


class ServeEngine:
    def __init__(self, model, params, *, slots: int = 4, window: int = 256,
                 greedy: bool = True, device=None):
        cfg = getattr(model, "cfg", None)
        if cfg is not None and (cfg.encdec is not None
                                or cfg.vision is not None):
            # prompts are teacher-forced through decode_step, which takes no
            # frames or patches: whisper would attend to a zero cross cache
            raise NotImplementedError(
                f"{cfg.name}: serving needs the encoder's frames or the "
                "image's patches, which the engine cannot take yet "
                "(ROADMAP.md queue 1 item 5b)")
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.slots = slots
        self.window = window
        self.greedy = greedy
        self.cache = model.init_cache(slots, window, device=self.device)
        self.pos = np.zeros(slots, np.int32)           # next write position
        self.active: list[Optional[Request]] = [None] * slots
        self._queue: deque[Request] = deque()
        self._rid = itertools.count()
        self._results: dict[int, Request] = {}
        self._steps = 0
        self._pending: Optional[np.ndarray] = None
        #: ``decode_step`` calls made so far
        self.decode_calls = 0

    # ------------------------------------------------------------- frontend
    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               eos_id: int | None = None) -> int:
        if not prompt:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to condition its first output on")
        r = Request(next(self._rid), list(prompt), max_new_tokens, eos_id,
                    submit_step=self._steps)
        self._queue.append(r)
        return r.rid

    def result(self, rid: int) -> list[int] | None:
        r = self._results.get(rid)
        return list(r.generated) if r is not None else None

    def request_steps(self) -> dict[int, tuple[int, int]]:
        """``rid -> (submit_step, done_step)`` for every completed request."""
        return {rid: (r.submit_step, r.done_step)
                for rid, r in self._results.items()}

    # ------------------------------------------------------------- scheduler
    def _admit(self):
        admitted: list[Request] = []
        slots_adm: list[int] = []
        for slot in range(self.slots):
            if self.active[slot] is None and self._queue:
                r = self._queue.popleft()
                self.active[slot] = r
                self.pos[slot] = 0
                admitted.append(r)
                slots_adm.append(slot)
        if not admitted:
            return
        # batched prefill: one decode_step per token index; short prompts
        # sit out of later calls
        for k in range(max(len(r.prompt) for r in admitted)):
            toks = np.zeros(self.slots, np.int32)
            live = []
            for slot, r in zip(slots_adm, admitted):
                if k < len(r.prompt):
                    toks[slot] = r.prompt[k]
                    live.append(slot)
            self._step_slots(live, toks)

    def _step_slots(self, slots: Sequence[int], toks: np.ndarray):
        """Feed one token into each slot in ``slots`` (``toks`` is the
        full-width token row) at per-row positions, and record the logits
        as each stepped slot's pending next-token distribution."""
        pos = np.maximum(self.pos, 0).astype(np.int32)
        with torch.no_grad():
            logits, self.cache = self.model.decode_step(
                self.params, self.cache,
                {"token": torch.from_numpy(toks).to(self.device),
                 "pos": torch.from_numpy(pos).to(self.device)})
            rows = logits[list(slots), 0].float().cpu().numpy()
        self.decode_calls += 1
        if self._pending is None:
            self._pending = np.zeros((self.slots, logits.shape[-1]),
                                     np.float32)
        for i, slot in enumerate(slots):
            self.pos[slot] += 1
            self._pending[slot] = rows[i]

    def _step_one_slot(self, slot: int, token: int):
        toks = np.zeros(self.slots, np.int32)
        toks[slot] = token
        self._step_slots([slot], toks)

    def step(self) -> int:
        """One engine step: admit + advance every active slot by one token
        (greedy over its pending logits); returns active request count."""
        self._admit()
        act = [s for s in range(self.slots) if self.active[s] is not None]
        if not act:
            return 0
        self._steps += 1
        for slot in act:
            r = self.active[slot]
            nxt = int(np.argmax(self._pending[slot]))
            r.generated.append(nxt)
            if r.done:
                r.done_step = self._steps
                self._results[r.rid] = r
                self.active[slot] = None
                self.pos[slot] = 0
            else:
                self._step_one_slot(slot, nxt)
        return len(act)

    def run_until_idle(self, max_steps: int = 1000) -> int:
        steps = 0
        while (self._queue or any(a is not None for a in self.active)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return steps
