"""Continuous-batching LM serving scheduler, ported from
``repro.serve.lm``.

Production serving keeps the decode batch full: finished requests release
their slot at once and queued requests claim it mid-flight (vLLM-style
iteration-level scheduling). Every tick runs one ``decode_step`` over the
fixed (B, …) cache buffers, each slot at its own position (per-slot
``lengths``); slot turnover is host bookkeeping plus one reset of the
slot's cache rows. The step runs eagerly (one CUDA graph a step is later
speed work).

Pieces:
  Request           — prompt + max_new_tokens (+ a callback for streaming)
  SlotState         — the host view of one batch slot
  ContinuousBatcher — admits and evicts requests, feeds prompts token by
                      token (prefill) and runs batched decode ticks,
                      collects outputs.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import lm


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (L,) int32
    max_new_tokens: int = 16
    on_token: Optional[Callable[[int, int], None]] = None   # (uid, token)


@dataclasses.dataclass
class SlotState:
    request: Optional[Request] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    prompt_pos: int = 0                # tokens of the prompt already fed

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def prefilling(self) -> bool:
        return (self.request is not None
                and self.prompt_pos < len(self.request.prompt))


class ContinuousBatcher:
    """Iteration-level scheduler over a fixed decode batch of ``model``
    (an :class:`~repro_torch.models.lm.LM`, whose device the caches share),
    greedy (argmax) decoding. ``dtype``: the KV caches'. MoE layers run on
    the capacity path, as the reference's do (its combine is the gather
    kernel on the card). ``last_logits`` holds the last tick's (B, 1, V)
    logits."""

    def __init__(self, model: lm.LM, batch_size: int, max_len: int,
                 dtype=torch.float32):
        self.model = model
        self.cfg = model.cfg
        self.batch = batch_size
        self.max_len = max_len
        self.slots = [SlotState() for _ in range(batch_size)]
        self.queue: Deque[Request] = deque()
        self.finished: Dict[int, List[int]] = {}
        self.state = lm.init_decode_state(self.cfg, batch_size, max_len,
                                          dtype, device=model.device)
        # per-slot position counter (the shared DecodeState.length advances
        # globally; each slot's validity is its own position mask)
        self.positions = np.zeros(batch_size, np.int32)
        self.last_logits: Optional[torch.Tensor] = None

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot.free and self.queue:
                self.slots[i] = SlotState(request=self.queue.popleft())
                self._reset_slot_cache(i)
                self.positions[i] = 0

    def _reset_slot_cache(self, i: int):
        """Zero slot i's cache and state rows, in place.

        Structural, not shape-matched: lead caches carry the batch on axis
        0, period caches on axis 1 (after the stacked-periods axis);
        guessing by size breaks when num_layers == batch_size."""
        for caches, axis in ((self.state.lead, 0), (self.state.period, 1)):
            for cache in caches:
                for t in cache:
                    if t.dim() > axis:
                        t.select(axis, i).zero_()

    # -- one scheduler tick --------------------------------------------------
    def tick(self) -> int:
        """Admit → build the token batch (the next prompt token for a
        prefilling slot, the last generated token for a decoding one) → one
        decode_step → collect/evict. Returns the number of active slots."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if not active:
            return 0
        tokens = np.zeros((self.batch, 1), np.int32)
        was_prefill = [False] * self.batch
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            if slot.prefilling:
                was_prefill[i] = True
                tokens[i, 0] = slot.request.prompt[slot.prompt_pos]
            else:
                tokens[i, 0] = slot.generated[-1]

        dev = self.model.device
        logits, self.state = lm.decode_step(
            self.model, torch.from_numpy(tokens).to(dev), self.state,
            lengths=torch.from_numpy(self.positions).to(dev))
        self.last_logits = logits
        next_tok = logits[:, -1, :self.cfg.vocab_size].argmax(-1).cpu().numpy()

        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            self.positions[i] += 1
            if was_prefill[i]:
                slot.prompt_pos += 1
                if slot.prompt_pos < len(slot.request.prompt):
                    continue              # mid-prompt: no output yet
                # the tick that consumed the LAST prompt token produced the
                # logits of the first generated token: fall through
            tok = int(next_tok[i])
            slot.generated.append(tok)
            if slot.request.on_token:
                slot.request.on_token(slot.request.uid, tok)
            done = (len(slot.generated) >= slot.request.max_new_tokens
                    or self.positions[i] >= self.max_len - 1)
            if done:
                self.finished[slot.request.uid] = slot.generated
                self.slots[i] = SlotState()   # slot freed: next tick admits
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> Dict[int, List[int]]:
        ticks = 0
        while (self.queue or any(not s.free for s in self.slots)) \
                and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.finished
