"""Mixture-of-Experts FFN with sort-based, chunk-local dispatch.

The port of ``repro.models.moe``.  Top-k routing with renormalised gates;
each token chunk (``n_token_shards`` of them) sorts its (token, k) pairs by
expert, stably, so that the tokens of an expert keep their order; a
binary search of the segment starts gives each pair its position in its
expert, and pairs past the capacity go to a trash slot.  The experts run
as one batched product over their (E, C * cap, D) rows, and the combine
adds each token's kept contributions in a fixed order.

Three choices keep the port equal to the reference on the same inputs:

  * the top k put the lower expert index first on ties, as
    ``jax.lax.top_k`` does (``torch.topk`` does not: a router of zeros,
    the reference's initial one, ties every expert);
  * every slot of the batch routes, inactive serving slots included, and
    takes capacity in token order;
  * the combine sums each token's contributions in ascending slot order,
    the reference's scatter order, one add at a time in the activation
    dtype: no atomic adds, so two runs on the card give the same bits.

With a ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`), ``dp_axes``
and ``ep_axis`` shard the call as the reference's ``with_sharding_constraint``
layout does: each data rank holds one token chunk (chunk d of the
reference's (C, Tl) view) and routes it; each rank along ``ep_axis``
holds E / model of the experts (their weights' blocks), gathers the
tokens of its experts' slots from its chunk (replicated along the model
axis, so nothing crosses ranks), runs them, adds its slots' contributions
in the unsharded order, and the partial outputs are summed over the model
axis in the activation dtype (with ``seq_parallel``, where the caller
gathered the chunk along the sequence, reduce-scattered to this rank's
sequence block, and only the rank's own block passes the router's
gradient back).  The load-balancing loss takes the mean
probabilities and the expert counts over all chunks (all-reduced over the
data axes), as the reference's global one.  Without a mesh they change
nothing, as in the reference without one.  :class:`RoutingLog` (entered with
:func:`routing_log`) sees every call in its thread: the expert load and
the pairs kept, and on request each call's router probabilities and top
k on the host, or top k to replay in place of the router's own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from repro_torch.core import collectives as coll

from .layers import swiglu


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def n_chunks(n_tok: int, n_token_shards: int) -> int:
    """The token chunks: ``n_token_shards``, stepped down until it divides
    the token count."""
    c = max(1, min(n_token_shards, n_tok))
    while n_tok % c:
        c -= 1
    return c


def capacity(tl: int, top_k: int, capacity_factor: float, n_experts: int) -> int:
    """Slots an expert has in a chunk of ``tl`` tokens (Python's round, as
    the reference)."""
    cap = _round_up(max(8, int(round(tl * top_k * capacity_factor / n_experts))), 8)
    return min(cap, tl)


@dataclasses.dataclass
class Routing:
    """One call's routing over C chunks of Tl tokens, E experts, K a token."""
    cap: int
    probs: torch.Tensor      # (C, Tl, E) f32: the router's softmax
    gate_vals: torch.Tensor  # (C, Tl, K) f32: the top k renormalised
    gate_idx: torch.Tensor   # (C, Tl, K) int64: the experts the pairs go to
    top_idx: torch.Tensor    # (C, Tl, K) int64: the router's top k, larger first,
                             # lower index on ties (gate_idx unless replayed)
    counts: torch.Tensor     # (C, E) f32: pairs routed to each expert
    order: torch.Tensor      # (C, Tl*K) int64: pairs t*K + k stably by expert
    slot: torch.Tensor       # (C, Tl*K) int64: e*cap + pos of each sorted pair; E*cap dropped
    slot_tok: torch.Tensor   # (C, E*cap) int64: each slot's token; Tl when empty
    slot_gate: torch.Tensor  # (C, E*cap) f32: each slot's gate; 0 when empty
    aux: torch.Tensor        # () f32: the Switch load-balancing loss over all chunks


class RoutingLog:
    """What the MoE calls made while the log was active.

    ``load`` and ``kept`` (E,) count the (token, k) pairs routed to each
    expert and kept within capacity, summed over calls on the device;
    ``pairs`` counts the pairs on the host; ``by_tokens`` maps a chunk's
    token count to its calls' [pairs, kept].  With ``keep_calls`` each
    call's probabilities and the router's own top k go to ``routes`` on the
    host (a read that waits for the device).  With ``replay``, a list of
    (C, Tl, K) top k, the calls route to those experts in turn, with the
    gates their own probabilities renormalised."""

    def __init__(self, keep_calls: bool = False, replay: list | None = None):
        self.calls = 0
        self.pairs = 0
        self.load = None
        self.kept = None
        self.by_tokens: dict[int, list] = {}
        self.keep_calls = keep_calls
        self.routes: list[dict] = []
        self.replay = None if replay is None else list(replay)

    def forced(self, device: torch.device) -> torch.Tensor | None:
        if self.replay is None:
            return None
        if self.calls >= len(self.replay):
            raise RuntimeError(f"routing replay holds {len(self.replay)} calls")
        return self.replay[self.calls].to(device=device, dtype=torch.int64)

    def add(self, r: Routing) -> None:
        load = r.counts.sum(0).to(torch.int64)
        kept = r.counts.clamp(max=r.cap).sum(0).to(torch.int64)
        self.load = load if self.load is None else self.load + load
        self.kept = kept if self.kept is None else self.kept + kept
        self.pairs += r.gate_idx.numel()
        tally = self.by_tokens.setdefault(r.probs.shape[1], [0, 0])
        tally[0] += r.gate_idx.numel()
        tally[1] = tally[1] + kept.sum()
        if self.keep_calls:
            self.routes.append(dict(probs=r.probs.detach().cpu(), gate_idx=r.top_idx.cpu()))
        self.calls += 1


_active = threading.local()


@contextlib.contextmanager
def routing_log(log: RoutingLog | None = None):
    """Make ``log`` (a new one by default) see the MoE calls of this
    thread until the block ends; yields it."""
    log = RoutingLog() if log is None else log
    stack = _active.__dict__.setdefault("logs", [])
    stack.append(log)
    try:
        yield log
    finally:
        stack.remove(log)


class _Capture:
    """Keeps what each MoE call was forced to (None when it routed by its
    router), forcing nothing."""

    def __init__(self):
        self.routes: list[torch.Tensor | None] = []

    def forced(self, device: torch.device) -> None:
        return None

    def add(self, r: Routing) -> None:
        # gate_idx is the router's own top_idx unless a log forced it
        self.routes.append(None if r.gate_idx is r.top_idx else r.gate_idx)


class _Replay:
    """Forces the MoE calls as the captured ones were forced, in turn (so
    each takes the same path through ``route``); records nothing."""

    def __init__(self, capture: _Capture):
        self.capture, self.calls = capture, 0

    def forced(self, device: torch.device) -> torch.Tensor | None:
        self.calls += 1
        return self.capture.routes[self.calls - 1]

    def add(self, r: Routing) -> None:
        pass


@contextlib.contextmanager
def _only(log):
    """Hide this thread's logs behind ``log`` until the block ends."""
    stack = _active.__dict__.setdefault("logs", [])
    _active.logs = [log]
    try:
        yield log
    finally:
        _active.logs = stack


def remat_contexts():
    """``(forward, recompute)`` context managers for one call of
    ``torch.utils.checkpoint`` (its ``context_fn``): the forward records
    how each MoE call it makes was routed, beside the thread's logs, and
    the recompute in the backward repeats it with the logs hidden: a call
    that a log forced is forced to the same experts, and one that routed
    by its router routes by it again, on the same inputs.  So the
    recompute routes as the forward did, and no log sees a call twice or
    spends a replayed route on it."""
    capture = _Capture()
    return routing_log(capture), _only(_Replay(capture))


def route(xt: torch.Tensor, router_w: torch.Tensor, top_k: int,
          capacity_factor: float = 1.25,
          forced: torch.Tensor | None = None, mesh=None, dp_axes: tuple = ()) -> Routing:
    """Route the chunks ``xt`` (C, Tl, D) through ``router_w`` (D, E):
    logits, softmax and gates in f32, the top k, the capacity and the
    slot maps.  ``forced`` (C, Tl, K) replaces the router's top k.  With a
    ``mesh``, the chunks are this data rank's and the load-balancing loss
    takes the mean probabilities and the counts of every rank along
    ``dp_axes``."""
    c, tl, _ = xt.shape
    e = router_w.shape[1]
    tk = tl * top_k
    cap = capacity(tl, top_k, capacity_factor, e)
    dev = xt.device

    probs = torch.softmax(xt.float() @ router_w.float(), dim=-1)  # (C, Tl, E)
    # a stable sort, descending: ties keep the lower index first
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_idx = idx[..., :top_k]
    if forced is None:
        gate_vals, gate_idx = vals[..., :top_k], top_idx
    else:
        gate_idx = forced.reshape(c, tl, top_k)
        gate_vals = probs.gather(-1, gate_idx)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    # aux loss (Switch): E * sum_e f_e * p_e, over all chunks
    flat_e = gate_idx.reshape(c, tk)
    me = probs.mean(dim=(0, 1))
    counts = torch.zeros((c, e), dtype=torch.float32, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones(flat_e.shape, dtype=torch.float32,
                                              device=dev))
    total, n_tok = counts.sum(0), c * tl
    ranks = 1 if coll.is_trivial(mesh, dp_axes) else mesh.axis(dp_axes).size
    if ranks > 1:  # the mean over every rank's chunks; its gradient local
        me = coll.all_reduce(me * (1.0 / ranks), mesh, dp_axes)
        total = coll.all_reduce_raw(total, mesh, dp_axes)
        n_tok *= ranks
    aux = e * torch.sum(me * total / (n_tok * top_k))

    # sort-based dispatch, per chunk
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    experts = torch.arange(e, dtype=flat_e.dtype, device=dev).expand(c, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts, side="left")  # (C, E)
    pos = torch.arange(tk, device=dev)[None, :] - starts.gather(1, sorted_e)
    slot = torch.where(pos < cap, sorted_e * cap + pos, e * cap)  # (C, TK)
    tok = order // top_k
    # slot -> (token, gate); dropped pairs all land in column E*cap, cut off
    slot_tok = torch.full((c, e * cap + 1), tl, dtype=torch.int64, device=dev)
    slot_tok = slot_tok.scatter_(1, slot, tok)[:, :e * cap]
    sorted_gate = gate_vals.reshape(c, tk).gather(1, order)
    slot_gate = torch.zeros((c, e * cap + 1), dtype=torch.float32, device=dev)
    slot_gate = slot_gate.scatter_(1, slot, sorted_gate)[:, :e * cap]
    return Routing(cap=cap, probs=probs, gate_vals=gate_vals, gate_idx=gate_idx,
                   top_idx=top_idx, counts=counts, order=order, slot=slot, slot_tok=slot_tok,
                   slot_gate=slot_gate, aux=aux)


def moe_ffn(
    x: torch.Tensor,         # (B, S, D)
    router_w: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,    # (E, D, F)
    w_in: torch.Tensor,      # (E, D, F)
    w_out: torch.Tensor,     # (E, F, D)
    top_k: int,
    capacity_factor: float = 1.25,
    n_token_shards: int = 1,
    dp_axes: tuple = (),
    ep_axis: str | None = None,
    mesh=None,
    seq_parallel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux load-balancing loss).  With ``mesh``,
    ``x`` is this data rank's tokens and the expert weights this model
    rank's experts (see the module's docstring).  ``seq_parallel``: ``x``
    was all-gathered along the sequence over ``ep_axis`` (whose backward
    sums its gradient over the axis), and the output is this rank's
    sequence block (B, S / ep, D) of the sum, reduce-scattered."""
    logs = getattr(_active, "logs", ())
    forced = None
    for log in logs:  # the first log that replays routes the call
        if forced is None:
            forced = log.forced(x.device)
    if mesh is not None:
        return _moe_sharded(x, router_w, w_gate, w_in, w_out, top_k, capacity_factor,
                            n_token_shards, tuple(dp_axes), ep_axis, mesh, logs, forced,
                            seq_parallel)
    b, s, d = x.shape
    e = router_w.shape[1]
    n_tok = b * s
    c = n_chunks(n_tok, n_token_shards)
    tl = n_tok // c

    xt = x.reshape(c, tl, d)
    r = route(xt, router_w, top_k, capacity_factor, forced)
    for log in logs:
        log.add(r)
    cap = r.cap

    # dispatch: a chunk-local gather of each slot's token (row Tl is zero),
    # then the experts as one batched product over (E, C*cap, D)
    xt_pad = torch.cat([xt, xt.new_zeros(c, 1, d)], dim=1)
    chunk = torch.arange(c, device=x.device)
    buf = xt_pad[chunk[:, None], r.slot_tok]  # (C, E*cap, D)
    buf = buf.reshape(c, e, cap, d).transpose(0, 1).reshape(e, c * cap, d)
    h = swiglu(buf, w_gate, w_in, w_out)  # (E, C*cap, D)
    h = h.reshape(e, c, cap, d).transpose(0, 1).reshape(c, e * cap, d)

    # combine: each token's kept contributions in ascending slot order,
    # added one at a time in x's dtype; dropped pairs read the zero row
    contrib = (h * r.slot_gate[..., None].to(h.dtype)).to(x.dtype)
    contrib = torch.cat([contrib, contrib.new_zeros(c, 1, d)], dim=1)
    pair_slot = torch.empty_like(r.slot).scatter_(1, r.order, r.slot)
    pair_slot = torch.sort(pair_slot.reshape(c, tl, top_k), dim=-1).values
    return _combine(contrib, pair_slot, top_k).reshape(b, s, d), r.aux


def _combine(contrib: torch.Tensor, pair_slot: torch.Tensor, top_k: int) -> torch.Tensor:
    """Each token's contributions (rows of ``contrib``, (C, slots + 1, D),
    the last row zero) at its ``pair_slot`` (C, Tl, K, ascending), added
    one at a time."""
    c = contrib.shape[0]
    chunk = torch.arange(c, device=contrib.device)
    parts = contrib[chunk[:, None, None], pair_slot]  # (C, Tl, K, D)
    out = parts[:, :, 0]
    for j in range(1, top_k):
        out = out + parts[:, :, j]
    return out


def _moe_sharded(x, router_w, w_gate, w_in, w_out, top_k, capacity_factor,
                 n_token_shards, dp, ep, mesh, logs, forced, seq_parallel=False):
    """The sharded ``moe_ffn``: one chunk a data rank, E / model experts a
    model rank."""
    b, s, d = x.shape
    e = router_w.shape[1]
    ranks = 1 if coll.is_trivial(mesh, dp) else mesh.axis(dp).size
    tl = b * s
    if n_chunks(tl * ranks, n_token_shards) != ranks:
        raise ValueError(f"sharded moe_ffn wants one token chunk a data rank: "
                         f"n_token_shards {n_token_shards}, {ranks} data ranks")
    xt = x.reshape(1, tl, d)
    seq_parallel = seq_parallel and not coll.is_trivial(mesh, ep)
    xr = xt
    if seq_parallel:
        # the router's work is the same on every rank along ep, and the
        # gather's backward sums over ep: only this rank's sequence block
        # passes the router's gradient back
        sb = s // mesh.axis(ep).size
        pos = torch.arange(s, device=x.device) // sb == mesh.axis(ep).index
        xr = torch.where(pos.repeat(b)[None, :, None], xt, xt.detach())
    r = route(xr, router_w, top_k, capacity_factor, forced, mesh=mesh, dp_axes=dp)
    for log in logs:
        log.add(r)
    cap, el = r.cap, w_gate.shape[0]
    lo = (0 if coll.is_trivial(mesh, ep) else mesh.axis(ep).index) * el * cap
    n_slots = el * cap

    # the chunk's tokens and the gates enter this rank's experts: their
    # gradients there are this rank's part of the whole (under sequence
    # parallelism the gather's backward sums the tokens')
    xt_in = coll.grad_all_reduce(xt, mesh, ep) if ep and not seq_parallel else xt
    gate = coll.grad_all_reduce(r.slot_gate, mesh, ep) if ep else r.slot_gate
    xt_pad = torch.cat([xt_in, xt_in.new_zeros(1, 1, d)], dim=1)
    buf = xt_pad[0][r.slot_tok[0, lo:lo + n_slots]]  # (El*cap, D)
    h = swiglu(buf.reshape(el, cap, d), w_gate, w_in, w_out).reshape(1, n_slots, d)
    contrib = (h * gate[:, lo:lo + n_slots, None].to(h.dtype)).to(x.dtype)
    contrib = torch.cat([contrib, contrib.new_zeros(1, 1, d)], dim=1)
    pair_slot = torch.empty_like(r.slot).scatter_(1, r.order, r.slot)
    pair_slot = torch.sort(pair_slot.reshape(1, tl, top_k), dim=-1).values - lo
    pair_slot = torch.where((pair_slot >= 0) & (pair_slot < n_slots), pair_slot, n_slots)
    out = _combine(contrib, pair_slot, top_k).reshape(b, s, d)
    if seq_parallel:  # the partial outputs, in x's dtype: this rank's block of the sum
        return coll.reduce_scatter_dim(out, mesh, ep, 1), r.aux
    if ep:
        out = coll.all_reduce(out, mesh, ep)  # the partial outputs, in x's dtype
    return out, r.aux
