"""Continuous batching for serving (slot-based), in PyTorch.

Copied from ``repro.serve.batching``: a fixed pool of ``n_slots`` decode
slots shares one cache; requests are admitted into free slots in arrival
order (each prompt prefilled alone into a one-row cache, then copied into
its slot), decode advances the active slots one group of equal positions
at a time, and a slot retires at EOS, at ``max_new_tokens`` or one
position before the end of its cache.  The group's slot caches are
gathered with ``index_select`` and written back with ``index_copy_`` (in
place), so other slots' caches stay untouched.  Each cache leaf is cut
along its own batch axis (``Model.cache_batch_axes``): axis 1 of the dense
KV cache and of Mamba2's state, axis 2 of the hybrid's stacked ``(napp, k,
B, ...)`` Mamba state.  (The reference cuts axis 1 of every leaf, which
breaks the hybrid's cache.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..kernels._common import resolve_device
from ..models.registry import Model
from . import serve_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int
    eos_id: int = -1              # -1: never
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    def __init__(self, model: Model, params, n_slots: int, max_len: int,
                 device: serve_step.Device = None):
        """``device``: where ``params`` lie and the cache goes (``None``:
        CUDA, raising without a card)."""
        self.device = resolve_device(device)
        serve_step.check_params_device(params, self.device)
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = serve_step.zero_cache(model, n_slots, max_len,
                                           self.device)
        self.axes = model.cache_batch_axes()
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)
        self.slot_tok = np.zeros((n_slots, 1), np.int32)
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    @torch.no_grad()
    def _admit(self):
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                S = len(req.prompt)
                c1 = serve_step.zero_cache(self.model, 1, self.max_len,
                                           self.device)
                tokens = torch.as_tensor(np.asarray(req.prompt)[None],
                                         device=self.device).to(torch.int32)
                logits, c1 = self.model.prefill(self.params,
                                                {"tokens": tokens}, c1)
                tok = int(logits[:, -1].argmax())
                req.out.append(tok)
                serve_step.tree_map(
                    lambda full, one, ax: full.select(ax, s).copy_(
                        one.select(ax, 0)), self.cache, c1, self.axes)
                self.slot_req[s] = req
                self.slot_pos[s] = S
                self.slot_tok[s, 0] = tok

    # -- decode tick -----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        self._admit()
        active = [s for s in range(self.n_slots)
                  if self.slot_req[s] is not None]
        if not active:
            return False
        # Decode per same-position group: gather the group's cache slice,
        # advance it, scatter back -- other slots' caches stay untouched.
        # As in the reference, a slot that a group advanced to the next
        # group's position is decoded again in that group; unlike the
        # reference (which then raises on ``None.out``), a slot that
        # retired in this tick is left out.
        for pos in sorted({int(self.slot_pos[s]) for s in active}):
            group = [s for s in active if self.slot_pos[s] == pos
                     and self.slot_req[s] is not None]
            if not group:
                continue
            gidx = torch.tensor(group, dtype=torch.long, device=self.device)
            sub_cache = serve_step.tree_map(
                lambda full, ax: full.index_select(ax, gidx), self.cache,
                self.axes)
            toks = torch.as_tensor(self.slot_tok[group], device=self.device)
            logits, sub_cache = self.model.decode_step(
                self.params, toks, sub_cache, pos)
            serve_step.tree_map(
                lambda full, sub, ax: full.index_copy_(ax, gidx, sub),
                self.cache, sub_cache, self.axes)
            nxt = logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()
            for gi, s in enumerate(group):
                req = self.slot_req[s]
                tok = int(nxt[gi])
                req.out.append(tok)
                self.slot_pos[s] += 1
                self.slot_tok[s, 0] = tok
                if (tok == req.eos_id
                        or len(req.out) >= req.max_new_tokens
                        or self.slot_pos[s] >= self.max_len - 1):
                    req.done = True
                    self.finished[req.rid] = req
                    self.slot_req[s] = None
        return True

    def run_to_completion(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished
