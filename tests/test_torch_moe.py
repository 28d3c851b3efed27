"""The port's mixture of experts (``repro_torch.models.moe`` and the MoE
branch of ``repro_torch.models.transformer``) against the reference's on the
CPU, with inputs made by numpy from a seed and the reference's weights
carried over by ``params_from_numpy``.

(a) ``moe_ffn`` alone, f32 and bf16: the router of zeros (the reference's
    initial one: every expert ties), a seeded router, a router that sends
    every token to one expert first (pairs drop), ``n_token_shards`` 1, 2
    and 3 on 16 tokens (3 steps down to 2), DeepSeek's routing (K 6 of E
    64, with a shared expert) and Qwen3's (K 8 of E 128) at d 64.  The
    reference's maps are read off its own calls (``jax.lax.top_k``,
    ``jnp.argsort``, ``jnp.where`` and ``jnp.take_along_axis`` wrapped for
    the call): the top k, the order, the slot of each sorted pair (which
    holds the kept/dropped split) and the slot-to-token map are equal as
    integers; the gates within 1e-6 and aux within 1e-6 of max(1, aux)
    (f32 means in another order); the outputs within 1e-5 of
    the largest in f32 and the LM tolerance below in bf16.
(b) The model on both MoE configs' ``REDUCED``, with the reference's router
    of zeros and with a seeded one: one ``_layer`` with and without a
    cache, ``forward``'s hidden state and aux, ``prefill`` logits and
    caches and teacher-forced ``decode_step``, ``decode_step_multipos``
    with an inactive slot, and ``ServeEngine`` against the reference's.

Near ties.  Inside a model the router's inputs are bf16 activations that
the two packages round at other places, so a token whose K-th and
(K+1)-th probabilities nearly tie can pick another expert.  Each MoE call's
probabilities and top k are compared token by token (the reference's are
recorded through a ``jax.debug.callback`` on ``jax.lax.top_k``): the
probabilities within ``PROB_ATOL``, and a token whose experts differ is a
flip, which passes only where the reference's K-th and (K+1)-th
probabilities lie within twice the largest difference between the two
packages' probabilities of that token, as they must if rounding alone
parted them; a flip at a wider margin is a fault.  A flip moves the
token's output, and through attention the later tokens', so the flips of
a free run after its first prove nothing: where a run has a flip, the
port runs again replaying the reference's top k (``RoutingLog(replay=)``),
its router's own choices are held to the rule call by call, and its
outputs to the tolerance.  The server: with ``eos_id=-1`` both servers
schedule alike, so their events (prefills and decode steps) pair up one to
one, layer by layer; a request is left out of the comparison from the
layer where its routing flipped at a near tie, or the event where its
token did (the reference's logits of the two tokens within
``2 * LOGIT_ATOL``).  In decode every slot's expert
capacity is its chunk's token count here (checked), so one slot's tokens
cannot move another's routing.

Tolerances are ``test_torch_lm.py``'s: logits and hidden states within 0.1
(bf16 units at |x| < 8), a block's output within 0.5 % of its largest
value, caches within 0.0625.  A model's aux within 0.2 % of the
reference's: the router's probabilities move with its bf16 inputs (a bf16
unit is 0.4 %), their mean over tokens by less.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import layers as jlayers, moe as jmoe, transformer as jlm  # noqa: E402
from repro.serve.engine import (  # noqa: E402
    Request as JRequest, ServeEngine as JServeEngine,
    decode_step_multipos as j_multipos,
)
from repro_torch.models import layers, moe, transformer as lm  # noqa: E402
from repro_torch.serve import Request, ServeEngine, decode_step_multipos  # noqa: E402

LOGIT_ATOL = 0.1
CACHE_ATOL = 0.0625
GATE_ATOL = 1e-6
PROB_ATOL = 1e-2
AUX_RTOL = 2e-3
MOE_CONFIGS = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")


def to_t(x) -> torch.Tensor:
    return lm.params_from_numpy(np.asarray(x), "cpu")


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def close(got: torch.Tensor, want, atol: float):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# the reference's routing, read off its calls
# ---------------------------------------------------------------------------

@pytest.fixture
def ref_top_k(monkeypatch):
    """Every ``jax.lax.top_k`` call of the reference, eager or traced, as
    (probs, top k) numpy arrays in call order."""
    calls = []
    real = jax.lax.top_k

    def top_k(x, k):
        vals, idx = real(x, k)
        jax.debug.callback(lambda p, i: calls.append((np.asarray(p), np.asarray(i))),
                           x, idx, ordered=True)
        return vals, idx

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return calls


@pytest.fixture
def ref_maps(monkeypatch, ref_top_k):
    """The reference ``moe_ffn``'s maps, eager: ``order`` (jnp.argsort),
    ``slot`` (the jnp.where that sends pairs past capacity to E*cap),
    ``slot_tok`` (the dispatch gather's index) and ``sorted_gate`` (the
    gates gathered in sorted order)."""
    maps = {"top_k": ref_top_k}
    real_argsort, real_where, real_take = jnp.argsort, jnp.where, jnp.take_along_axis

    def argsort(a, *args, **kw):
        out = real_argsort(a, *args, **kw)
        maps["order"] = np.asarray(out)
        return out

    def where(cond, *args):
        out = real_where(cond, *args)
        if len(args) == 2 and isinstance(args[1], int):
            maps["slot"] = np.asarray(out)
        return out

    def take_along_axis(arr, idx, axis):
        out = real_take(arr, idx, axis)
        if idx.ndim == 3:  # the dispatch: slot_tok[..., None]
            maps["slot_tok"] = np.asarray(idx[..., 0])
        elif jnp.issubdtype(arr.dtype, jnp.floating) and arr.ndim == 2:
            maps["sorted_gate"] = np.asarray(out)
        return out

    monkeypatch.setattr(jnp, "argsort", argsort)
    monkeypatch.setattr(jnp, "where", where)
    monkeypatch.setattr(jnp, "take_along_axis", take_along_axis)
    return maps


def flips(port_routes: list, ref_calls: list, rows=None) -> list:
    """The tokens whose top-k sets differ, call by call, as (call, token,
    margin, noise): the reference's gap between its K-th and (K+1)-th
    probabilities, and the largest difference between the two packages'
    probabilities of that token.  ``rows(call)`` (default: all) picks the
    tokens (a (C, Tl) mask) whose probabilities must agree within
    ``PROB_ATOL``; a flip elsewhere is not reported."""
    jax.effects_barrier()  # the reference's callbacks have all run
    assert len(port_routes) == len(ref_calls)
    out = []
    for n, (got, (probs, want)) in enumerate(zip(port_routes, ref_calls)):
        mask = np.ones(want.shape[:-1], bool) if rows is None else rows(n)
        noise = np.abs(got["probs"].numpy() - probs).max(-1)
        assert noise[mask].max(initial=0.0) <= PROB_ATOL, (n, noise.max())
        k = want.shape[-1]
        top = -np.sort(-probs, axis=-1)
        differ = (np.sort(got["gate_idx"].numpy(), -1) != np.sort(want, -1)).any(-1)
        for tok in zip(*np.nonzero(differ & mask)):
            out.append((n, tok, float(top[tok][k - 1] - top[tok][k]), float(noise[tok])))
    return out


def check_flips(found: list) -> None:
    """A flip is a near tie only if the reference's K-th and (K+1)-th
    probabilities lie within twice the token's noise: were the two sides
    apart by rounding alone, that holds (the swapped experts' order turned
    on a difference of at most 2 noise)."""
    for n, tok, margin, noise in found:
        assert margin <= 2 * noise, (n, tok, margin, noise)


def port_routed_as_reference(run, ref_calls: list):
    """``run()`` on the port.  Where the port's router picks the
    reference's experts in every call, that run's result and no flips.
    Else ``run()`` again replaying the reference's top k, its router's own
    top k recorded: every token where they differ must be a near tie
    (``check_flips``: with the routing held equal, the two sides differ by
    rounding alone), and the replayed result is returned with the flips.
    Flips of the free run after its first are consequences of the first,
    so only the replayed run is held to the rule."""
    with moe.routing_log(moe.RoutingLog(keep_calls=True)) as log:
        out = run()
    jax.effects_barrier()  # the reference's callbacks have all run
    if all(np.array_equal(np.sort(got["gate_idx"].numpy(), -1), np.sort(want, -1))
           for got, (_, want) in zip(log.routes, ref_calls, strict=True)):
        return out, []
    replay = [torch.from_numpy(i.astype(np.int64)) for _, i in ref_calls]
    with moe.routing_log(moe.RoutingLog(keep_calls=True, replay=replay)) as log:
        out = run()
    found = flips(log.routes, ref_calls)
    check_flips(found)
    return out, found


# ---------------------------------------------------------------------------
# (a) moe_ffn alone
# ---------------------------------------------------------------------------

# name, experts, top k, shared expert width (0: none), n_token_shards
FFN_CASES = [
    ("zeros", 8, 2, 0, 1),
    ("seeded", 8, 2, 0, 1),
    ("overload", 8, 2, 0, 1),
    ("seeded", 8, 3, 0, 2),
    ("seeded", 8, 3, 0, 3),        # 16 tokens: 3 chunks step down to 2
    ("zeros", 8, 3, 0, 3),
    ("seeded", 64, 6, 64, 1),      # DeepSeek's routing, a shared expert
    ("overload", 64, 6, 64, 1),
    ("seeded", 128, 8, 0, 1),      # Qwen3's routing
    ("zeros", 128, 8, 0, 1),
]


def _router(kind: str, d: int, e: int, rng) -> np.ndarray:
    if kind == "zeros":
        return np.zeros((d, e), np.float32)
    w = (rng.normal(size=(d, e)) / np.sqrt(d)).astype(np.float32)
    if kind == "overload":  # every token's first choice: expert 1
        w[:, 1] = 0.0
        w[0, 1] = 8.0
    return w


@pytest.mark.parametrize("kind,e,k,shared,shards", FFN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(ref_maps, kind, e, k, shared, shards, dtype):
    rng = np.random.default_rng(e * 10 + k + shards)
    b, s, d, f = 2, 8, 64, 32
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    if kind == "overload":
        x[..., 0] = np.abs(x[..., 0]) + 1.0  # expert 1 tops every token
    jx = jnp.asarray(x, jdt)
    router = _router(kind, d, e, rng)
    jw = [jnp.asarray(rng.normal(size=shape) * 0.2, jdt)
          for shape in ((e, d, f), (e, d, f), (e, f, d))]
    want, want_aux = jmoe.moe_ffn(jx, jnp.asarray(router), *jw, k,
                                  n_token_shards=shards)
    got, aux = moe.moe_ffn(to_t(jx), to_t(router), *map(to_t, jw), k,
                           n_token_shards=shards)

    c = moe.n_chunks(b * s, shards)
    xt = to_t(jx).reshape(c, b * s // c, d)
    r = moe.route(xt, to_t(router), k)
    jax.effects_barrier()
    (probs, top), = ref_maps["top_k"]
    np.testing.assert_array_equal(r.gate_idx.numpy(), top)
    np.testing.assert_array_equal(r.order.numpy(), ref_maps["order"])
    np.testing.assert_array_equal(r.slot.numpy(), ref_maps["slot"])
    np.testing.assert_array_equal(r.slot_tok.numpy(), ref_maps["slot_tok"])
    np.testing.assert_allclose(r.probs.numpy(), probs, atol=GATE_ATOL, rtol=0)
    sorted_gate = r.gate_vals.reshape(c, -1).gather(1, r.order)
    np.testing.assert_allclose(sorted_gate.numpy(), ref_maps["sorted_gate"],
                               atol=GATE_ATOL, rtol=0)
    assert abs(float(aux) - float(want_aux)) <= GATE_ATOL * max(1.0, float(want_aux))
    dropped = int((r.slot == e * r.cap).sum())
    if kind == "overload":
        assert dropped > 0  # the case exercises the capacity
    if kind == "zeros":  # every token ties: experts 0..K-1, lower index first
        assert (r.gate_idx == torch.arange(k)).all()
    assert c == (2 if shards == 3 else shards)

    if shared:
        ws = [rng.normal(size=shape) * 0.2 for shape in ((d, shared), (d, shared),
                                                          (shared, d))]
        jws = [jnp.asarray(w, jdt) for w in ws]
        want = want + jlayers.swiglu(jx, *jws)
        got = got + layers.swiglu(to_t(jx), *map(to_t, jws))
    assert got.dtype == to_t(want).dtype and got.shape == want.shape
    scale = float(jnp.abs(want.astype(jnp.float32)).max())
    close(got, want, 1e-5 * scale if dtype == "float32" else LOGIT_ATOL)


def test_capacity_and_chunks_follow_the_reference():
    """Python's round (half to even) in the capacity, the chunk count's
    step down, and the capacity never above the chunk's tokens."""
    assert moe.capacity(512, 6, 1.25, 64) == 64  # round(60) -> 64
    assert moe.capacity(16, 6, 1.25, 64) == 8
    assert moe.capacity(1, 6, 1.25, 64) == 1
    assert moe.capacity(4, 2, 1.25, 8) == 4
    assert moe.capacity(512, 8, 1.25, 128) == 40
    assert moe.capacity(10, 1, 2.0, 8) == 8  # max(8, round(2.5) == 2)
    assert [moe.n_chunks(16, c) for c in (1, 2, 3, 5, 16, 40)] == [1, 2, 2, 4, 16, 16]


def test_routing_log_counts_load_and_kept():
    """The log's load and kept pairs, summed over two calls, against the
    counts of the routing maps."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    router = torch.zeros(16, 8)
    router[0, 1] = 50.0
    ws = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
          for shape in ((8, 16, 4), (8, 16, 4), (8, 4, 16))]
    x[..., 0] = x[..., 0].abs() + 1.0
    with moe.routing_log() as log:
        moe.moe_ffn(x, router, *ws, 2)
        moe.moe_ffn(x, router, *ws, 2)
    r = moe.route(x.reshape(1, 16, 16), router, 2)
    assert log.calls == 2 and log.pairs == 2 * 32
    assert int(log.load[1]) == 2 * 16 and int(log.load.sum()) == 2 * 32
    kept = int((r.slot < 8 * r.cap).sum())
    assert int(log.kept.sum()) == 2 * kept and kept < 32  # expert 1 dropped pairs
    assert moe._active.logs == []


# ---------------------------------------------------------------------------
# (b) the model on the MoE configs' REDUCED
# ---------------------------------------------------------------------------

def _port_cfg(jcfg, **kw) -> lm.LMConfig:
    return lm.LMConfig(**dict(dataclasses.asdict(jcfg), **kw))


@pytest.fixture(scope="module", params=[(n, r) for n in MOE_CONFIGS
                                        for r in ("zeros", "seeded")],
                ids=lambda p: f"{p[0]}-{p[1]}_router")
def model(request):
    name, router = request.param
    jcfg = ref_arch(name).reduced
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    if router == "seeded":
        rng = np.random.default_rng(7)
        shape = jparams["layers"]["router"].shape
        jparams["layers"]["router"] = jnp.asarray(
            rng.normal(size=shape) / np.sqrt(jcfg.d_model), jnp.float32)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, params


def test_moe_params_carry_over(model):
    """The f32 router and the 4-d expert stacks cross ``params_from_numpy``
    bit for bit; ``init_params`` makes the same pytree, the router zeros."""
    jcfg, jparams, params = model
    for key, want in jparams["layers"].items():
        got = params["layers"][key]
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["e_gate"].dim() == 4
    ours = lm.init_params(torch.Generator().manual_seed(0), _port_cfg(jcfg),
                          device="cpu")
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                        ours) == shapes
    assert float(ours["layers"]["router"].abs().max()) == 0.0
    n = sum(t.numel() for t in [ours["embed"], ours["final_norm"],
                                *ours["layers"].values()])
    assert n == jcfg.param_count()


@pytest.mark.parametrize("cached", [False, True])
def test_moe_layer(model, ref_top_k, cached):
    jcfg, jparams, params = model
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(3)
    b, s, t = 2, 5, 12
    x = jnp.asarray(rng.normal(size=(b, s, jcfg.d_model)), jnp.bfloat16)
    jlp = jax.tree.map(lambda a: a[1], jparams["layers"])
    lp = lm.layer_params(params, 1)
    pos0 = 4 if cached else 0
    jc, js = jlayers.rope_angles(jnp.arange(pos0, pos0 + s), jcfg.d_head,
                                 jcfg.rope_theta)
    c, sn = to_t(jc), to_t(js)
    if cached:
        shape = (b, t, jcfg.n_kv, jcfg.d_head)
        kc = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
        vc = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
        want, waux, (wk, wv) = jlm._layer(jcfg, x, jlp, jc, js, pos0, kc, vc)
        run = lambda: lm._layer(cfg, to_t(x), lp, c, sn, pos0, to_t(kc), to_t(vc))  # noqa: E731
    else:
        want, waux, (wk, wv) = jlm._layer(jcfg, x, jlp, jc, js, 0)
        run = lambda: lm._layer(cfg, to_t(x), lp, c, sn, 0)  # noqa: E731
    (got, aux, (gk, gv)), _ = port_routed_as_reference(run, ref_top_k)
    scale = float(jnp.abs(want.astype(jnp.float32)).max())
    close(got, want, max(LOGIT_ATOL, 0.005 * scale))
    close(gk, wk, CACHE_ATOL)
    close(gv, wv, CACHE_ATOL)
    assert abs(float(aux) - float(waux)) <= AUX_RTOL * float(waux)


def test_moe_forward(model, ref_top_k):
    jcfg, jparams, params = model
    tokens = np.random.default_rng(5).integers(2, jcfg.vocab, (2, 7)).astype(np.int32)
    want, waux = jlm.forward(jparams, jcfg, jnp.asarray(tokens))
    (got, aux), _ = port_routed_as_reference(
        lambda: lm.forward(params, _port_cfg(jcfg), torch.from_numpy(tokens)),
        ref_top_k)
    close(got, want, LOGIT_ATOL)
    assert abs(float(aux) - float(waux)) <= AUX_RTOL * float(waux)
    assert float(aux) > 0.0


@pytest.mark.parametrize("impl", ["xla_chunked", "flash"])
def test_moe_prefill_and_decode(model, ref_top_k, impl):
    """Prefill logits and caches, then four teacher-forced decode steps on
    an arena of 16 rows (fed the reference's greedy tokens)."""
    jcfg, jparams, params = model
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    cfg = _port_cfg(jcfg)
    prompt = np.random.default_rng(4).integers(2, jcfg.vocab, (1, 9)).astype(np.int32)
    jlogits, jcache = jlm.prefill(jparams, jcfg, jnp.asarray(prompt))
    (logits, cache), _ = port_routed_as_reference(
        lambda: lm.prefill(params, cfg, torch.from_numpy(prompt)), ref_top_k)
    close(logits, jlogits, LOGIT_ATOL)
    for key in ("k", "v"):
        close(cache[key], jcache[key], CACHE_ATOL)

    t = 16
    jarena = {k: jnp.zeros((jcfg.n_layers, 1, t, jcfg.n_kv, jcfg.d_head),
                           jnp.bfloat16).at[:, :, :9].set(jcache[k]) for k in jcache}
    arena = lm.init_cache(cfg, 1, t, device="cpu")
    for key in arena:
        arena[key][:, :, :9] = cache[key]
    tok = int(jnp.argmax(jlogits[0, -1]))
    for pos in range(9, 13):
        ref_top_k.clear()
        jlogits, jarena = jlm.decode_step(jparams, jcfg, jarena,
                                          jnp.asarray([tok], jnp.int32), jnp.int32(pos))

        def step(arena=arena, pos=pos, tok=tok):  # on a copy: it may run twice
            copy = {k: v.clone() for k, v in arena.items()}
            return lm.decode_step(params, cfg, copy, torch.tensor([tok]), pos)

        (logits, arena), _ = port_routed_as_reference(step, ref_top_k)
        close(logits, jlogits, LOGIT_ATOL)
        tok = int(jnp.argmax(jlogits[0]))  # the reference's token feeds both
    for key in ("k", "v"):
        close(arena[key], jarena[key], CACHE_ATOL)


def test_moe_decode_multipos_with_an_inactive_slot(model, ref_top_k):
    """One batched step on a seeded arena, slot 1 inactive (position 0, a
    stale token): it routes with the others and takes expert capacity."""
    jcfg, jparams, params = model
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(6)
    b, t = 4, 20
    shape = (jcfg.n_layers, b, t, jcfg.n_kv, jcfg.d_head)
    jcache = {k: jnp.asarray(rng.normal(size=shape), jnp.bfloat16) for k in ("k", "v")}
    tokens = rng.integers(2, jcfg.vocab, b).astype(np.int32)
    positions = np.asarray([5, 0, 19, 11], np.int32)
    want, jnew = j_multipos(jparams, jcfg, jcache, jnp.asarray(tokens),
                            jnp.asarray(positions))

    def run():
        cache = {k: to_t(v) for k, v in jcache.items()}
        return decode_step_multipos(params, cfg, cache, torch.from_numpy(tokens),
                                    torch.from_numpy(positions))

    (got, new), _ = port_routed_as_reference(run, ref_top_k)
    with moe.routing_log() as log:
        run()
    assert log.pairs == jcfg.n_layers * b * jcfg.top_k  # the inactive slot routed
    close(got, want, LOGIT_ATOL)
    for key in ("k", "v"):
        close(new[key], jnew[key], CACHE_ATOL)


def test_moe_serve_engine_matches_reference(model, ref_top_k):
    """Six requests through four slots on both servers: the scheduling
    events (a prefill or a batched decode step, each L MoE calls and one
    sampling call) pair up; routing flips are near ties, logits within
    ``LOGIT_ATOL`` and tokens equal, but for near ties (above), after
    which the request is not compared."""
    jcfg, jparams, params = model
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(2, jcfg.vocab, int(n)).tolist()
               for n in rng.integers(3, 12, 6)]
    assert moe.capacity(4, jcfg.top_k, jcfg.capacity_factor, jcfg.n_experts) == 4

    def serve(engine_cls, request_cls, params, to_np_logits, **kw):
        eng = engine_cls(params, cfg if engine_cls is ServeEngine else jcfg,
                         n_slots=4, max_len=32, eos_id=-1, **kw)
        events, sample = [], eng.sample
        prefills = iter(range(len(prompts)))

        def recorded(logits):
            arr = to_np_logits(logits)
            uids = ([next(prefills)] if arr.ndim == 1 else
                    [r.uid if r is not None else None for r in eng.slot_req])
            events.append((uids, arr.reshape(len(uids), -1)))
            return sample(logits)

        eng.sample = recorded
        for i, p in enumerate(prompts):
            eng.submit(request_cls(uid=i, prompt=p, max_new=6))
        return {r.uid: r.out for r in eng.run()}, events

    want, jevents = serve(JServeEngine, JRequest, jparams,
                          lambda x: np.asarray(x, np.float32))
    with moe.routing_log(moe.RoutingLog(keep_calls=True)) as log:
        got, events = serve(ServeEngine, Request, params, to_np, device="cpu")
    assert [u for u, _ in events] == [u for u, _ in jevents]
    n_layers = jcfg.n_layers
    assert log.calls == n_layers * len(events)

    parted: set = set()

    def rows(call):  # the tokens of requests not parted: (1, S) or (1, slots)
        uids = events[call // n_layers][0]
        keep = np.asarray([u is not None and u not in parted for u in uids])
        return np.broadcast_to(keep.reshape(1, -1),
                               log.routes[call]["gate_idx"].shape[:-1])

    for n, (uids, arr) in enumerate(events):
        # layer by layer: a token that flipped leaves the comparison, since
        # its later layers (and a prefill's later tokens) follow from it
        for call in range(n * n_layers, (n + 1) * n_layers):
            found = flips(log.routes[call:call + 1], ref_top_k[call:call + 1],
                          rows=lambda _, call=call: rows(call))
            check_flips(found)
            for _, (_, t), _, _ in found:
                parted.add(uids[t] if len(uids) > 1 else uids[0])
        jarr = jevents[n][1]
        for row, uid in enumerate(uids):
            if uid is None or uid in parted:
                continue
            np.testing.assert_allclose(arr[row], jarr[row], atol=LOGIT_ATOL, rtol=0)
            a, b = int(np.argmax(jarr[row])), int(np.argmax(arr[row]))
            if a != b:  # a near tie: the reference's two logits within 2 atol
                assert jarr[row][a] - jarr[row][b] <= 2 * LOGIT_ATOL, uid
                parted.add(uid)
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for uid in set(want) - parted:
        assert got[uid] == want[uid], uid
    assert all(len(out) == 6 for out in got.values())
