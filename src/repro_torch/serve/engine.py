"""Batched LM serving with continuous batching over a static KV arena.

The port of ``repro.serve.engine``.  The server keeps a fixed (B, T) KV
cache arena (layout (L, B, T, KV, Dh)) and swaps finished sequences for
queued requests between decode steps:

  * admit: a free slot gets the next queued request; its prompt is
    prefilled (one request, through the flash kernel when
    ``attn_impl="flash"``) and its KV rows are written into the slot,
  * decode: one step advances every slot by a token, with per-slot
    positions (the chunked attention path: the offsets are a vector),
  * evict: slots hitting EOS or ``max_new`` are drained and freed.

Like the reference, the batched decode runs every slot, inactive ones too
(position 0, their last token): it writes their cache rows, and admission
overwrites them.  Dense and MoE configs take the same path (``_layer``);
in an MoE layer the inactive slots route too and take expert capacity from
the active ones, as in the reference.  Sampling is argmax; the first
maximum wins ties.

``ServeEngine.stats`` counts the tokens of the prefills and of the decode
steps and the host-clock seconds each took; each ends in a read of the
sampled token on the host, which waits for the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models import transformer as lm
from repro_torch.models.layers import DTYPE, rope_angles
from repro_torch.models.transformer import LMConfig, _layer, layer_params, logits_of, rms_norm


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list  # token ids
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeStats:
    prefills: int = 0
    prefill_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_steps: int = 0
    decode_tokens: int = 0  # tokens of active slots only
    decode_seconds: float = 0.0


def decode_step_multipos(params, cfg: LMConfig, cache, tokens, positions):
    """One decode step with PER-SLOT positions.

    tokens (B,) int; positions (B,) int current length of each slot, both
    on the device of ``params``.  Writes the new K/V into ``cache`` in
    place; returns (logits (B,V), cache).
    """
    x = params["embed"].to(DTYPE)[tokens.to(torch.int64)][:, None, :]
    cos, sin = rope_angles(positions.float(), cfg.d_head, cfg.rope_theta)
    cos, sin = cos[:, None, :], sin[:, None, :]  # (B,1,half)
    for i in range(cfg.n_layers):
        x, _, _ = _layer(cfg, x, layer_params(params, i), cos, sin,
                         q_offset=positions, k_cache=cache["k"][i],
                         v_cache=cache["v"][i])
    hidden = rms_norm(x, params["final_norm"])
    return logits_of(params, hidden)[:, 0, :], cache


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


class ServeEngine:
    def __init__(self, params, cfg: LMConfig, n_slots: int, max_len: int,
                 sample: Callable | None = None, eos_id: int = 1,
                 device: str | torch.device = "cuda"):
        self.device = resolve(device, "ServeEngine")
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"ServeEngine on {self.device}: the params lie on "
                f"{params['embed'].device}"
            )
        self.params, self.cfg = params, cfg
        self.n_slots, self.max_len = n_slots, max_len
        self.eos_id = eos_id
        self.sample = sample or _argmax
        self.cache = lm.init_cache(cfg, n_slots, max_len, device=params["embed"].device)
        self.positions = np.zeros(n_slots, np.int32)
        self.slot_req: list[Request | None] = [None] * n_slots
        self.last_tok = np.zeros(n_slots, np.int32)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.stats = ServeStats()

    # -- scheduler ---------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        dev = self.params["embed"].device
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                t0 = time.perf_counter()
                req = self.queue.pop(0)
                toks = torch.tensor([req.prompt], dtype=torch.int64, device=dev)
                logits, cache1 = lm.prefill(self.params, self.cfg, toks)
                plen = len(req.prompt)
                # write the slot's prefilled KV rows into the arena
                for key in ("k", "v"):
                    self.cache[key][:, slot, :plen] = cache1[key][:, 0]
                tok = int(self.sample(logits[0, -1]))
                self.stats.prefills += 1
                self.stats.prefill_tokens += plen
                self.stats.prefill_seconds += time.perf_counter() - t0
                self.slot_req[slot] = req
                self.positions[slot] = plen
                self.last_tok[slot] = tok
                req.out.append(tok)

    def _evict(self):
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            hit_eos = req.out and req.out[-1] == self.eos_id
            full = len(req.out) >= req.max_new or self.positions[slot] >= self.max_len - 1
            if hit_eos or full:
                req.done = True
                self.finished.append(req)
                self.slot_req[slot] = None
                self.positions[slot] = 0

    def step(self):
        """One scheduler tick: admit -> batched decode -> evict."""
        self._admit()
        self._evict()  # a prompt whose first sampled token is EOS is done
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if active:
            t0 = time.perf_counter()
            dev = self.params["embed"].device
            logits, self.cache = decode_step_multipos(
                self.params, self.cfg, self.cache,
                torch.from_numpy(self.last_tok).to(dev),
                torch.from_numpy(self.positions).to(dev),
            )
            toks = self.sample(logits).cpu().numpy()
            self.stats.decode_steps += 1
            self.stats.decode_tokens += len(active)
            self.stats.decode_seconds += time.perf_counter() - t0
            for slot in active:
                self.positions[slot] += 1
                self.last_tok[slot] = toks[slot]
                self.slot_req[slot].out.append(int(toks[slot]))
        self._evict()
        return len(active)

    def run(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(self.slot_req)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished
