"""Minimal batched serving engine over ``transformer.serve_step``.

Continuous-batching-lite: a fixed slot pool; finished sequences free their
slot, queued requests claim it and prefill token-by-token through the
decode path.  Admission, prefill and decode are the JAX package's
``serving/engine.py`` step for step, including its cache writes: each
step feeds one slot's token (the other rows get token 0) and
``serve_step`` writes every row's K/V at that slot's position, so with
several slots a step overwrites the other slots' cache there, as in the
JAX engine.  The cache lives on the parameters' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import transformer


@dataclasses.dataclass
class Request:
    prompt: list
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.cache = transformer.init_cache(cfg, slots, max_len,
                                            device=self.device)
        self.positions = np.zeros(slots, np.int64)
        self.active: list[Request | None] = [None] * slots

    @torch.no_grad()
    def _feed_token(self, slot: int, token: int) -> int:
        """Insert one token at the slot's position, return the greedy
        next token (the first maximum, as ``jnp.argmax``)."""
        toks = np.zeros((self.slots, 1), np.int64)
        toks[slot, 0] = token
        logits, self.cache = transformer.serve_step(
            self.params, self.cache, torch.as_tensor(toks, device=self.device),
            int(self.positions[slot]), self.cfg)
        self.positions[slot] += 1
        return int(torch.argmax(logits[slot]))

    def run(self, requests: list[Request]) -> list[Request]:
        queue = list(requests)
        while queue or any(r is not None for r in self.active):
            # admit
            for s in range(self.slots):
                if self.active[s] is None and queue:
                    req = queue.pop(0)
                    self.active[s] = req
                    self.positions[s] = 0
                    # prefill (token by token through the decode path)
                    nxt = 0
                    for tok in req.prompt:
                        nxt = self._feed_token(s, tok)
                    req.out.append(nxt)
            # decode one token for every active slot
            for s in range(self.slots):
                req = self.active[s]
                if req is None:
                    continue
                if (len(req.out) >= req.max_new_tokens
                        or self.positions[s] >= self.max_len - 1):
                    req.done = True
                    self.active[s] = None
                    continue
                req.out.append(self._feed_token(s, req.out[-1]))
        return requests
