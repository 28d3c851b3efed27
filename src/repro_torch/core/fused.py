"""Fused rounds and waves: the round loops with their flags on the device.

The port of ``repro.core.fused``: the forward rounds and the overdelete
waves of the incremental delete path.  The host round loop of
:meth:`repro_torch.core.engine.TorchEngine._forward` (``fuse_rounds=False``)
reads counts and flags from the device several times a round and sizes the
insertion by them.  Here one round is a static-shape body,
:func:`forward_round`: process the candidate stream at round ``r``
(:func:`repro_torch.core.engine.process_static`), then evaluate every delta
plan at ``r + 1`` and squeeze the bucketed heads back to the stream width.
Its counts and overflow bits accumulate in one int64 flag vector on the
device, sticky as the reference's ``lax.while_loop`` carry keeps them, and
the host reads that vector once a round to decide whether to go on:
:func:`fused_forward_rounds`.

* On the CPU (the tests' path) the body runs eagerly in a Python loop.
* On the card the body is captured once into a ``torch.cuda.CUDAGraph``
  (:class:`RoundGraph`) over static carry buffers, and every round after
  the capture is one replay followed by one copy of the flag vector to
  pinned memory and one synchronise.  The round that precedes the capture
  runs eagerly on the same buffers: it is the warm-up, and capturing
  records without running, so no round runs twice.  The graph is keyed by
  the stream width, the plan signature and the capacities, and the engine
  keeps it across ``materialise_state`` calls.

The overdelete waves go the same way (:func:`fused_delete_waves`): one wave
is :func:`delete_wave` (every tombstone plan, squeezed to the delta width,
then :func:`repro_torch.core.incremental_spmd._od_step`), its flags one
vector read once a wave; on the card :class:`WaveGraph` captures it after
an eager first wave and replays it wave after wave, delete after delete.
The wave counter lives in the carry and restarts at 0 on each delete.

The forward loop exits as the reference's does: when the stream empties,
when a capacity flag fires, on a contradiction, when rho reaches a rule constant
(``consts_changed``: that round's plan evaluation runs at the impossible
round :data:`_NULL_ROUND`, so it counts and emits nothing, and the host
rewrites the program and evaluates the round again), or after ``max_inner``
rounds.  Every delta plan runs every round: there is no delta-mask skipping
(a skipped plan matches no row, so the counters are the same).

Under a mesh (the reference's ``shard_map``'d loops) the bodies take the
mesh and run eagerly on every rank: a CUDA graph cannot hold the
collectives.  Each rank folds the round's local counts and bits into one
vector, and one all-reduce of it (:func:`_reduce_round`, the reference's
``psum`` of ``n_new`` and ``_pany`` of the overflow bits, packed) makes the
flags the same on every rank before the host reads them, so every rank
leaves the loop at the same round.  The round's own early exit (its
nullified plan evaluation) decides on the rank's bits: every bit but
``consts_changed``, which rho makes the same on every rank, raises on the
host after the loop, so no state of such a round is kept.

Each round counts one ``fforward`` dispatch and each wave one ``fwave``
(the reference counts one of each for a whole stretch of rounds or waves,
its ``lax.while_loop``); a capture counts under ``compiles``.  Both bodies
register a trace builder with the audit (:func:`_audit_fforward`,
:func:`_audit_fwave`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels import ops

from . import collectives as coll
from . import spans
from .engine import (
    I32,
    I64,
    TorchEngine,
    _squeeze_stream,
    build_plans,
    eval_plan,
    process_static,
    register_auditable,
)
from .terms import is_var

__all__ = [
    "FLAGS",
    "RoundGraph",
    "WAVE_FLAGS",
    "WaveGraph",
    "delete_wave",
    "forward_plan_signature",
    "forward_round",
    "fused_delete_waves",
    "fused_forward_rounds",
    "program_tables",
]

# round sentinel for the nullified exit round: far below any real round, so
# every epoch predicate matches no row and the round's plan evaluation
# contributes exactly nothing
_NULL_ROUND = -(1 << 20)

# the flag vector: one int64 each; the counts accumulate over rounds, the
# overflow and exit bits are sticky, ``have_cands`` and ``n_new`` are the
# last round's
FLAGS = ("iters", "have_cands", "n_new", "n_pairs", "n_reflexive",
         "n_deriv", "n_appl", "ov_store", "ov_rewrite", "ov_route", "ov_pair",
         "ov_bind", "ov_out", "ov_squeeze", "contradiction", "consts_changed")
_SUMS = ("iters", "n_pairs", "n_reflexive", "n_deriv", "n_appl")
_STOPS = ("ov_store", "ov_rewrite", "ov_route", "ov_pair", "ov_bind", "ov_out",
          "ov_squeeze", "contradiction", "consts_changed")
# the entries that are bits (any rank's), not counts
_BITS = ("have_cands",) + _STOPS
# the tensors one round reads and writes in place
CARRY = ("spo", "epoch", "marked", "n_used", "rep", "sort_perm",
         "sorted_keys", "cands", "cand_valid", "r", "flags")


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def forward_plan_signature(program, tombstone: bool = False) -> tuple:
    """Static plan signature of a program: one ``(rule_idx, plan,
    head_var_slots)`` entry per delta (or tombstone) plan — what the round
    and wave bodies close over (the constants are :func:`program_tables`)."""
    sig = []
    for k, rule in enumerate(program.rules):
        head_slots = tuple(t if is_var(t) else None for t in rule.head)
        for plan in build_plans(rule, full=False, tombstone=tombstone):
            sig.append((k, tuple(plan), head_slots))
    return tuple(sig)


def program_tables(program, width: int | None = None):
    """The program's constants as numpy tables.

    Returns ``(atom_consts, head_consts, const_vals, const_valid)``:

    * ``atom_consts`` (n_rules, max_atoms, 3) / ``head_consts`` (n_rules, 3)
      int32 — each rule's constants (variable positions hold 0),
    * ``const_vals`` / ``const_valid`` — the distinct rule constants,
      padded to ``width`` (default: the next power of two).  Every constant
      is a rho fixed point when the loop starts (the program is rewritten
      under a compressed rho), so a rewrite is due exactly when
      ``any(const_valid & (rep[const_vals] != const_vals))``.

    A rewrite changes what the tables hold, never their shapes (rewriting
    can only merge constants), so a captured round reads the new constants
    from the same buffers.
    """
    rules = program.rules
    n_rules = max(len(rules), 1)
    max_atoms = max((len(r.body) for r in rules), default=1)
    ac = np.zeros((n_rules, max(max_atoms, 1), 3), np.int32)
    hc = np.zeros((n_rules, 3), np.int32)
    consts: set[int] = set()
    for k, rule in enumerate(rules):
        for j, atom in enumerate(rule.body):
            for pos, t in enumerate(atom):
                if not is_var(t):
                    ac[k, j, pos] = t
                    consts.add(int(t))
        for pos, t in enumerate(rule.head):
            if not is_var(t):
                hc[k, pos] = t
                consts.add(int(t))
    cs = np.asarray(sorted(consts), np.int32)
    width = _pow2(max(cs.shape[0], 1)) if width is None else width
    if cs.shape[0] > width:
        raise ValueError(f"{cs.shape[0]} rule constants, table width {width}")
    vals = np.zeros((width,), np.int32)
    vals[: cs.shape[0]] = cs
    valid = np.arange(width) < cs.shape[0]
    return ac, hc, vals, valid


def eval_plans(spo, epoch, marked, sorted_keys, sort_perm, r_eval,
               atom_consts, head_consts, plans: tuple, width: int, *,
               bind_cap: int, plan_out_cap: int, tomb=None, mesh=None):
    """Evaluate the static ``plans`` at round ``r_eval`` and squeeze (or
    pad) their concatenated heads to ``width`` rows.  Returns ``(heads,
    valid, n_deriv, n_appl, ov_bind, ov_out, ov_squeeze)``, the last five
    as 0-d tensors (the rank's own under a ``mesh``)."""
    dev = spo.device
    zero = torch.zeros((), dtype=I64, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    outs, vals = [], []
    n_deriv, n_appl, ov_bind, ov_out, ov_squeeze = zero, zero, false, false, false
    for k, plan, head_slots in plans:
        o, v, nd, na, ovb, ovo = eval_plan(
            spo, epoch, marked, sorted_keys, sort_perm, r_eval,
            atom_consts[k], head_consts[k], plan, head_slots,
            bind_cap, plan_out_cap, tomb=tomb, mesh=mesh,
        )
        outs.append(o)
        vals.append(v)
        n_deriv = n_deriv + nd
        n_appl = n_appl + na
        ov_bind = ov_bind | ovb
        ov_out = ov_out | ovo
    if not outs:
        heads = torch.zeros((width, 3), dtype=I32, device=dev)
        valid = torch.zeros(width, dtype=torch.bool, device=dev)
    else:
        heads = torch.cat(outs, dim=0)
        valid = torch.cat(vals, dim=0)
        if heads.shape[0] > width:
            heads, valid, ov_squeeze = _squeeze_stream(heads, valid, width)
        elif heads.shape[0] < width:
            pad = width - heads.shape[0]
            heads = torch.cat([heads, torch.zeros((pad, 3), dtype=I32, device=dev)])
            valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
    return heads, valid, n_deriv, n_appl, ov_bind, ov_out, ov_squeeze


def new_carry(state, cands, cand_valid) -> dict:
    """The carry of a fused run that starts from ``state`` with the given
    candidate stream, in the state's own tensors (the eager loop updates
    them in place): the arena columns, the index, rho, the stream, the
    round counter and a zeroed flag vector."""
    dev = state.spo.device
    return dict(
        spo=state.spo, epoch=state.epoch, marked=state.marked,
        n_used=state.n_used, rep=state.rep, sort_perm=state.sort_perm,
        sorted_keys=state.sorted_keys, cands=cands, cand_valid=cand_valid,
        r=torch.full((), state.r, dtype=I32, device=dev),
        flags=torch.zeros(len(FLAGS), dtype=I64, device=dev),
    )


def round_tables(program, device, width: int | None = None) -> dict:
    """:func:`program_tables` on ``device``, with the flag vector's masks."""
    ac, hc, cv, cvd = program_tables(program, width)
    return dict(
        atom_consts=torch.from_numpy(ac).to(device),
        head_consts=torch.from_numpy(hc).to(device),
        const_vals=torch.from_numpy(cv).to(device),
        const_valid=torch.from_numpy(cvd).to(device),
        sums=torch.tensor([f in _SUMS for f in FLAGS], device=device),
        stops=torch.tensor([f in _STOPS for f in FLAGS], device=device),
        bits=torch.tensor([f in _BITS for f in FLAGS], device=device),
    )


def _reduce_round(upd: torch.Tensor, bits: torch.Tensor, mesh) -> torch.Tensor:
    """A round's (or wave's) flag update summed over the ranks, its bits
    read as any rank's and its ``iters`` (entry 0) as one round: one
    all-reduce, the reference's psums and ``_pany`` packed."""
    if mesh is None:
        return upd
    upd = coll.psum(upd, mesh)
    upd = torch.where(bits, (upd > 0).to(I64), upd)
    upd[0] = 1
    return upd


def forward_round(c: dict, t: dict, plans: tuple, *, rewrite_cap: int,
                  bind_cap: int, plan_out_cap: int, mesh=None,
                  route_cap: int | None = None, pair_cap: int = 4096) -> None:
    """One fused round on the carry ``c`` (updated in place; every tensor
    keeps its storage) with the constant tables ``t``: process the stream
    at round ``r + 1``, evaluate every delta plan at ``r + 2`` (at
    :data:`_NULL_ROUND` when the round stops the loop), and fold the
    round's counts and bits into ``c["flags"]`` (reduced over the ranks
    under a ``mesh``).  Makes no host read.  With the spans on, the plan
    evaluation is the stage ``rew.join`` and the fold and the carry copies
    ``rew.flags`` (the stream's processing marks its own), and the body's
    end is marked."""
    width = c["cands"].shape[0]
    r = c["r"] + 1
    spo, epoch, marked, n_used, rep, perm, keys, fl = process_static(
        c["spo"], c["epoch"], c["marked"], c["n_used"], c["rep"],
        c["sort_perm"], c["sorted_keys"], c["cands"], c["cand_valid"], r,
        rewrite_cap, mesh=mesh, route_cap=route_cap, pair_cap=pair_cap,
    )
    spans.stage("rew.join", spo.device)
    cv = t["const_vals"]
    consts_changed = (
        t["const_valid"] & (rep[cv.clamp(0, rep.shape[0] - 1).to(I64)] != cv)
    ).any()
    stop = (fl["ov_store"] | fl["ov_rewrite"] | fl["ov_route"] | fl["ov_pair"]
            | fl["contradiction"] | consts_changed)
    r_eval = torch.where(stop, _NULL_ROUND, r + 1)
    heads, valid, n_deriv, n_appl, ov_bind, ov_out, ov_squeeze = eval_plans(
        spo, epoch, marked, keys, perm, r_eval, t["atom_consts"],
        t["head_consts"], plans, width, bind_cap=bind_cap,
        plan_out_cap=plan_out_cap, mesh=mesh,
    )
    spans.stage("rew.flags", spo.device)
    now = {
        "iters": torch.ones((), dtype=I64, device=spo.device),
        "have_cands": valid.any(), "n_deriv": n_deriv, "n_appl": n_appl,
        "ov_bind": ov_bind, "ov_out": ov_out, "ov_squeeze": ov_squeeze,
        "consts_changed": consts_changed, **fl,
    }
    upd = torch.stack([now[f].to(I64) for f in FLAGS])
    upd = _reduce_round(upd, t["bits"], mesh)
    f = c["flags"]
    f.copy_(torch.where(t["sums"], f + upd, torch.where(t["stops"], f | upd, upd)))
    c["marked"].copy_(marked)
    c["n_used"].copy_(n_used)
    c["rep"].copy_(rep)
    c["sort_perm"].copy_(perm)
    c["sorted_keys"].copy_(keys)
    c["cands"].copy_(heads)
    c["cand_valid"].copy_(valid)
    c["r"].copy_(r)
    spans.stage_end(spo.device)


class _Captured:
    """A step body captured once into a CUDA graph over static buffers.

    :meth:`start` runs the body eagerly the first time (the warm-up; the
    capture records without running, so no step runs twice), captures it
    the second time and replays it from then on, then starts an
    asynchronous copy of the flag vector to pinned memory.  A replay
    launches no kernel through :mod:`repro_torch.kernels.ops`, so each adds
    the capture's launch counts to ``ops.LAUNCHES`` (the capture itself
    counts nothing); ``replays`` counts them.  ``family`` is the dispatch
    family of a step; ``stages`` lists the stage markers the capture
    recorded (none when the spans were off), which each replay runs.

    The capture runs in the thread-local error mode, on PyTorch's capture
    stream: another thread may launch, copy to the host and synchronise
    its own streams meanwhile (the serving tier's readers answer queries
    while its maintenance worker captures).
    """

    family = ""

    def __init__(self, key, n_flags: int) -> None:
        self.key = key
        self.replays = 0
        self.flags_host = torch.empty(n_flags, dtype=I64, pin_memory=True)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.warm = False
        self.calls: dict[str, int] = {}  # a replay's launches by entry point
        self.launches: dict[str, int] = {}  # ... and by kernel
        self.capture_s = 0.0
        self.captured_now = False  # the last run through it captured
        self.stages: tuple = ()  # the stage markers the capture recorded

    def _body(self) -> None:
        raise NotImplementedError

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with spans.span("rew.capture"), spans.marks_recorded() as marks, \
                ops.recording() as calls, torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
            self._body()
        self.stages = tuple(marks)
        self.calls = calls
        self.launches = ops.by_kernel(calls)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        self.captured_now = True

    def start(self) -> torch.Tensor:
        if not self.warm:
            self._body()  # the warm-up step; the capture follows it
            self.warm = True
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            ops.book(self.calls)
            self.replays += 1
        self.flags_host.copy_(self.carry["flags"], non_blocking=True)
        return self.flags_host


def _load_rep(buf: torch.Tensor, rep: torch.Tensor) -> None:
    """rho into its power-of-two graph buffer: identities past its end."""
    n = rep.shape[0]
    buf[:n].copy_(rep)
    buf[n:].copy_(torch.arange(n, buf.shape[0], dtype=buf.dtype, device=buf.device))


class RoundGraph(_Captured):
    """:func:`forward_round` captured once into a CUDA graph over static
    carry and table buffers.

    :meth:`load` copies a state, a stream and the program's constants into
    the buffers; :meth:`start` starts one round (eagerly until the
    capture, which follows the first round, then by replay);
    :meth:`carry_out` hands the state back as copies, so a later run
    through the same graph leaves it alone.  rho sits in a buffer of
    ``n_pad`` entries, identities past the state's: the same graph serves
    a state whose rho grew within it.  The constant tables are ``width``
    entries wide (default: the program's own count, to a power of two).
    """

    family = "fforward"

    def __init__(self, key, state, cands, cand_valid, plans,
                 caps: dict, n_pad: int, width: int | None = None) -> None:
        super().__init__(key, len(FLAGS))
        self.plans = plans
        self.caps = caps
        carry = new_carry(state, cands, cand_valid)
        carry["rep"] = torch.empty(n_pad, dtype=I32, device=state.spo.device)
        self.carry = {k: v.clone() for k, v in carry.items()}
        self.tables = round_tables(state.program, state.spo.device, width)

    def load(self, state, cands, cand_valid) -> None:
        self.captured_now = False
        src = new_carry(state, cands, cand_valid)
        for k in CARRY:
            if k == "rep":
                _load_rep(self.carry["rep"], src["rep"])
            else:
                self.carry[k].copy_(src[k])
        width = self.tables["const_vals"].shape[0]
        names = ("atom_consts", "head_consts", "const_vals", "const_valid")
        for k, v in zip(names, program_tables(state.program, width)):
            self.tables[k].copy_(torch.from_numpy(v))

    def _body(self) -> None:
        forward_round(self.carry, self.tables, self.plans, **self.caps)

    def carry_out(self, state) -> tuple:
        """Copies of the carry: the state's tensors and the stream."""
        n_res = state.n_res
        c = {k: v.clone() for k, v in self.carry.items()}
        c["rep"] = c["rep"][:n_res]
        _to_state(state, c)
        return c["cands"], c["cand_valid"]


def _to_state(state, c: dict) -> None:
    state.spo, state.epoch, state.marked = c["spo"], c["epoch"], c["marked"]
    state.n_used, state.rep = c["n_used"], c["rep"]
    state.sort_perm, state.sorted_keys = c["sort_perm"], c["sorted_keys"]


def _go_on(fl: dict, max_inner: int) -> bool:
    """The reference's loop condition after at least one round."""
    stop = any(fl[k] for k in _STOPS)
    return bool(fl["have_cands"]) and not stop and fl["iters"] < max_inner


def fused_forward_rounds(state, cands, cand_valid, max_inner: int, *,
                         plans: tuple, rewrite_cap: int, bind_cap: int,
                         plan_out_cap: int, log, dispatches,
                         graph: RoundGraph | None = None, mesh=None,
                         route_cap: int | None = None, pair_cap: int = 4096):
    """Run forward rounds from ``state`` until the loop exits (see the
    module docstring); at least one round runs.

    With ``graph`` (on the card) the rounds run through it and the state
    gets copies of its buffers back; without, the body runs eagerly on the
    state's own tensors.  ``log`` (a :class:`repro_torch.core.engine.RoundLog`)
    times each round and makes its one host read; ``dispatches`` (a
    :class:`~repro_torch.core.stats.DispatchCounter`) counts each round
    and the capture.  Returns ``(cands,
    cand_valid, flags)`` with ``flags`` the exit report by :data:`FLAGS`
    name (counts summed over the rounds run here).  With a ``mesh`` the
    rounds run eagerly on every rank (no ``graph``) and the flags are the
    ranks' reduced ones.
    """
    width = cands.shape[0]
    if width != plan_out_cap:
        raise ValueError(f"stream width {width} != plan_out_cap {plan_out_cap}")
    if mesh is not None and graph is not None:
        raise ValueError("a CUDA graph cannot hold the mesh's collectives")
    caps = dict(rewrite_cap=rewrite_cap, bind_cap=bind_cap,
                plan_out_cap=plan_out_cap)
    if mesh is not None:
        caps.update(mesh=mesh, route_cap=route_cap, pair_cap=pair_cap)
    if graph is None:
        c = new_carry(state, cands, cand_valid)
        t = round_tables(state.program, state.spo.device)

        def start_round() -> torch.Tensor:
            forward_round(c, t, plans, **caps)
            return c["flags"]
    else:
        graph.load(state, cands, cand_valid)
        start_round = graph.start
    while True:
        log.begin_round()
        dispatches.record("fforward")
        flags = start_round()
        fl = dict(zip(FLAGS, log.read(flags.tolist)))
        log.end_round()
        if not _go_on(fl, max_inner):
            break
    if graph is None:
        _to_state(state, c)
        return c["cands"], c["cand_valid"], fl
    if graph.captured_now:
        dispatches.record_compile(graph.family)
    cands, cand_valid = graph.carry_out(state)
    return cands, cand_valid, fl


# the wave's flag vector: ``iters`` and ``n_od`` accumulate, ``n_new`` is
# the last wave's, the overflow bits are sticky (``ov_route`` stays 0 on
# one device: the reference's owner routing is the identity there)
WAVE_FLAGS = ("iters", "n_od", "n_new", "ov_route", "ov_refl", "ov_bind",
              "ov_out", "ov_squeeze")
_WAVE_SUMS = ("iters", "n_od")
_WAVE_STOPS = ("ov_route", "ov_refl", "ov_bind", "ov_out", "ov_squeeze")
# what a wave reads and leaves alone (tombstone tagging never changes
# liveness, so the sorted index stays exact for every wave's probes)
WAVE_CONSTS = ("spo", "epoch", "marked", "sorted_keys", "sort_perm", "rep", "sizes")
# what a wave updates in place
WAVE_CARRY = ("tomb", "suspect", "w", "flags")


def wave_tables(program, device) -> dict:
    """The tombstone plans' constant tables and the wave flags' masks."""
    ac, hc, _, _ = program_tables(program)
    return dict(
        atom_consts=torch.from_numpy(ac).to(device),
        head_consts=torch.from_numpy(hc).to(device),
        sums=torch.tensor([f in _WAVE_SUMS for f in WAVE_FLAGS], device=device),
        stops=torch.tensor([f in _WAVE_STOPS for f in WAVE_FLAGS], device=device),
        bits=torch.tensor([f in _WAVE_STOPS for f in WAVE_FLAGS], device=device),
    )


def delete_wave(c: dict, k: dict, t: dict, plans: tuple, *, bind_cap: int,
                plan_out_cap: int, refl_cap: int, mesh=None,
                route_cap: int | None = None) -> None:
    """One fused overdelete wave on the carry ``c`` (updated in place) over
    the loop constants ``k``: every tombstone plan at wave ``w + 1``,
    squeezed to ``plan_out_cap`` rows, then the od step without its masks;
    the flags are reduced over the ranks under a ``mesh``.  Makes no host
    read.  With the spans on, the plans are the stage ``maint.tomb_join``
    and the od step and the fold ``maint.od_step``, and the end is marked."""
    from .incremental_spmd import _od_step  # the module imports this one

    w = c["w"] + 1
    spans.stage("maint.tomb_join", w.device)
    heads, hv, _nd, _na, ov_bind, ov_out, ov_squeeze = eval_plans(
        k["spo"], k["epoch"], k["marked"], k["sorted_keys"], k["sort_perm"], w,
        t["atom_consts"], t["head_consts"], plans, plan_out_cap,
        bind_cap=bind_cap, plan_out_cap=plan_out_cap, tomb=c["tomb"],
        mesh=mesh,
    )
    spans.stage("maint.od_step", w.device)
    tomb, suspect, n_new, ov_route, ov_refl, _masks = _od_step(
        k["spo"], k["epoch"], k["marked"], c["tomb"], k["sorted_keys"],
        k["sort_perm"], k["rep"], k["sizes"], c["suspect"], heads, hv, w,
        refl_cap=refl_cap, with_masks=False, mesh=mesh, route_cap=route_cap,
    )
    one = torch.ones((), dtype=I64, device=w.device)
    now = dict(iters=one, n_od=n_new, n_new=n_new, ov_route=ov_route,
               ov_refl=ov_refl, ov_bind=ov_bind, ov_out=ov_out,
               ov_squeeze=ov_squeeze)
    upd = torch.stack([now[f].to(I64) for f in WAVE_FLAGS])
    upd = _reduce_round(upd, t["bits"], mesh)
    f = c["flags"]
    f.copy_(torch.where(t["sums"], f + upd, torch.where(t["stops"], f | upd, upd)))
    c["tomb"].copy_(tomb)
    c["suspect"].copy_(suspect)
    c["w"].copy_(w)
    spans.stage_end(w.device)


class WaveGraph(_Captured):
    """:func:`delete_wave` captured once into a CUDA graph.

    :meth:`load` copies a state's arena, index, rho, the clique sizes and
    the program's constants into the loop-constant buffers and starts the
    carry (the tombstones, no suspect, wave 0, zero flags); :meth:`carry_out`
    hands back copies of the tombstone column and the suspect mask.  rho,
    the sizes and the suspect mask sit in buffers of ``n_pad`` entries.
    """

    family = "fwave"

    def __init__(self, key, state, plans, caps: dict, n_pad: int) -> None:
        super().__init__(key, len(WAVE_FLAGS))
        self.plans = plans
        self.caps = caps
        dev = state.spo.device
        self.consts = {f: getattr(state, f).clone() for f in WAVE_CONSTS[:5]}
        self.consts["rep"] = torch.empty(n_pad, dtype=I32, device=dev)
        self.consts["sizes"] = torch.zeros(n_pad, dtype=I32, device=dev)
        self.carry = dict(
            tomb=state.tomb.clone(),
            suspect=torch.zeros(n_pad, dtype=torch.bool, device=dev),
            w=torch.zeros((), dtype=I32, device=dev),
            flags=torch.zeros(len(WAVE_FLAGS), dtype=I64, device=dev),
        )
        self.tables = wave_tables(state.program, dev)

    def load(self, state, sizes, suspect) -> None:
        self.captured_now = False
        for f in WAVE_CONSTS[:5]:
            self.consts[f].copy_(getattr(state, f))
        _load_rep(self.consts["rep"], state.rep)
        n = sizes.shape[0]
        self.consts["sizes"][:n].copy_(sizes)
        self.consts["sizes"][n:].zero_()
        self.carry["tomb"].copy_(state.tomb)
        self.carry["suspect"].zero_()
        self.carry["suspect"][:n].copy_(suspect)
        self.carry["w"].zero_()
        self.carry["flags"].zero_()
        ac, hc, _, _ = program_tables(state.program)
        self.tables["atom_consts"].copy_(torch.from_numpy(ac))
        self.tables["head_consts"].copy_(torch.from_numpy(hc))

    def _body(self) -> None:
        delete_wave(self.carry, self.consts, self.tables, self.plans, **self.caps)

    def carry_out(self, n_res: int):
        return self.carry["tomb"].clone(), self.carry["suspect"][:n_res].clone()


def _waves_go_on(fl: dict, max_inner: int) -> bool:
    """The reference's wave-loop condition after at least one wave."""
    stop = any(fl[k] for k in _WAVE_STOPS)
    return fl["n_new"] > 0 and not stop and fl["iters"] < max_inner


def fused_delete_waves(state, sizes, suspect, max_inner: int, *, plans: tuple,
                       bind_cap: int, plan_out_cap: int, refl_cap: int, log,
                       dispatches, graph: WaveGraph | None = None, mesh=None,
                       route_cap: int | None = None):
    """The overdelete wave loop with its flags on the device: waves run
    until one tags nothing new, an overflow bit is set, or ``max_inner``
    waves ran; at least one runs.  With ``graph`` (on the card) through its
    replays, else eagerly on ``state.tomb`` in place; ``dispatches`` counts
    each wave and the capture.  Returns ``(tomb, suspect, flags)`` with
    ``flags`` by :data:`WAVE_FLAGS` name.  With a ``mesh`` the waves run
    eagerly on every rank and the flags are the ranks' reduced ones."""
    if mesh is not None and graph is not None:
        raise ValueError("a CUDA graph cannot hold the mesh's collectives")
    if graph is None:
        dev = state.spo.device
        k = {f: getattr(state, f) for f in WAVE_CONSTS[:6]}
        k["sizes"] = sizes
        c = dict(tomb=state.tomb, suspect=suspect.clone(),
                 w=torch.zeros((), dtype=I32, device=dev),
                 flags=torch.zeros(len(WAVE_FLAGS), dtype=I64, device=dev))
        t = wave_tables(state.program, dev)
        caps = dict(bind_cap=bind_cap, plan_out_cap=plan_out_cap,
                    refl_cap=refl_cap)
        if mesh is not None:
            caps.update(mesh=mesh, route_cap=route_cap)

        def start_wave() -> torch.Tensor:
            delete_wave(c, k, t, plans, **caps)
            return c["flags"]
    else:
        graph.load(state, sizes, suspect)
        start_wave = graph.start
    while True:
        dispatches.record("fwave")
        fl = dict(zip(WAVE_FLAGS, log.read(start_wave().tolist)))
        if not _waves_go_on(fl, max_inner):
            break
    if graph is None:
        return c["tomb"], c["suspect"], fl
    if graph.captured_now:
        dispatches.record_compile(graph.family)
    tomb, suspect = graph.carry_out(state.n_res)
    return tomb, suspect, fl


# -- audit trace builders (repro_torch.analysis) -----------------------------
#
# Each body runs once, eagerly, on a copy of the probe state, at the
# engine's update widths, as the reference traces its fused fns.
# ``fforward`` has no exemption: its sorts are stream or binding width and
# its scatters stream width.  ``fwave`` runs ``_od_step``, whose
# per-resource masks scatter arena-length index streams by design (the
# ``od`` family's exemption).

@register_auditable("fforward")
def _audit_fforward(engine, state):
    width = engine.delta_out
    st = TorchEngine.cloned(state)
    dev = st.spo.device
    carry = new_carry(st, torch.zeros((width, 3), dtype=I32, device=dev),
                      torch.zeros(width, dtype=torch.bool, device=dev))
    tables = round_tables(st.program, dev)
    plans = forward_plan_signature(st.program)
    yield "fforward", lambda: forward_round(
        carry, tables, plans, rewrite_cap=engine.delta_rewrite,
        bind_cap=engine.delta_bind, plan_out_cap=width)


@register_auditable("fwave", skip_passes=("NoArenaScatter",))
def _audit_fwave(engine, state):
    width = engine.delta_out
    st = TorchEngine.cloned(state)
    dev = st.spo.device
    k = {f: getattr(st, f) for f in WAVE_CONSTS[:6]}
    k["sizes"] = torch.zeros(st.n_res, dtype=I32, device=dev)
    c = dict(tomb=st.tomb, suspect=torch.zeros(st.n_res, dtype=torch.bool, device=dev),
             w=torch.zeros((), dtype=I32, device=dev),
             flags=torch.zeros(len(WAVE_FLAGS), dtype=I64, device=dev))
    tables = wave_tables(st.program, dev)
    plans = forward_plan_signature(st.program, tombstone=True)
    yield "fwave", lambda: delete_wave(
        c, k, tables, plans, bind_cap=engine.delta_bind, plan_out_cap=width,
        refl_cap=width)
