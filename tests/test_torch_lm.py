"""The port's LM (``repro_torch.models``) against the reference's
(``repro.models``) on the CPU, with the reference's weights carried over by
``params_from_numpy``.

(a) The flash kernel's plain version against the reference's Pallas kernel
    in interpret mode (``repro.kernels.ops.flash_attention``): GQA g=3 at
    D 64, ragged S/T, a decode row at an offset, causal and not, f32 and
    bf16.  Tolerances are the reference's own for its kernel: 2e-5 in f32,
    2e-2 in bf16 (one bf16 rounding of outputs of magnitude up to 4).
(b) The building blocks and the chunked attention path.
(c) One decoder block with and without a cache, ``prefill`` logits and
    caches and ``decode_step`` logits over several steps, on ``REDUCED``
    and on SmolLM-135M's full widths at 2 layers (9 heads over 3 KV heads,
    d_head 64, vocab 49,152), with both attention paths.  The decode steps
    are teacher-forced: both packages are fed the reference's greedy
    tokens, since bf16 logits have near-ties that the two round apart.

Activations are bf16 in both packages and the two round their matmuls at
other places, so the model-level tolerance is in bf16 units: logits and
hidden states within 0.1 absolute (about three units in the last place at
the largest logits of these random models, |x| < 8) and within 0.5 % of
the largest value otherwise; the caches within 0.0625 (K/V values < 8).
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
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as jlayers, transformer as jlm  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers, transformer as lm  # noqa: E402

LOGIT_ATOL = 0.1
CACHE_ATOL = 0.0625


def to_t(x) -> torch.Tensor:
    return lm.params_from_numpy(np.asarray(x), "cpu")


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def close(got: torch.Tensor, want, atol: float, rtol: float = 0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# (a) flash attention: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # b, s, t, h, kv, d, causal, q_offset
    (1, 24, 24, 9, 3, 64, True, 0),    # SmolLM's heads: GQA g=3, D 64
    (2, 17, 33, 6, 2, 16, True, 0),    # ragged S and T
    (2, 1, 40, 9, 3, 64, True, 29),    # a decode row at an offset
    (1, 5, 12, 4, 4, 8, True, 7),      # several rows at an offset
    (2, 17, 33, 6, 3, 32, False, 0),   # not causal
]


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,q_offset", FLASH_CASES)
@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 2e-5), (jnp.bfloat16, 2e-2)])
def test_flash_plain_matches_pallas(b, s, t, h, kv, d, causal, q_offset, dtype, atol):
    rng = np.random.default_rng(s * 100 + t)
    q = jnp.asarray(rng.normal(size=(b, s, h, d)), dtype)
    k = jnp.asarray(rng.normal(size=(b, t, kv, d)), dtype)
    v = jnp.asarray(rng.normal(size=(b, t, kv, d)), dtype)
    want = jops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    got = ops.flash_attention(to_t(q), to_t(k), to_t(v), causal=causal,
                              q_offset=q_offset)
    assert got.dtype == to_t(want).dtype and got.shape == want.shape
    close(got, want, atol)


def test_flash_rejects_bad_shapes():
    q = torch.zeros(1, 4, 6, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 4, 4, 16), torch.zeros(1, 4, 4, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 3, 16),
                            q_offset=-1)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())


# ---------------------------------------------------------------------------
# (b) building blocks
# ---------------------------------------------------------------------------

def test_rms_norm_and_swiglu():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 5, 48)), jnp.bfloat16)
    scale = jnp.asarray(rng.normal(size=(48,)), jnp.float32)
    want = jlayers.rms_norm(x, scale)
    close(layers.rms_norm(to_t(x), to_t(scale)), want, atol=0, rtol=1e-2)
    ws = [jnp.asarray(rng.normal(size=shape) * 0.2, jnp.bfloat16)
          for shape in ((48, 96), (48, 96), (96, 48))]
    want = jlayers.swiglu(x, *ws)
    got = layers.swiglu(to_t(x), *[to_t(w) for w in ws])
    close(got, want, atol=0.02 * float(jnp.abs(want.astype(jnp.float32)).max()))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    pos = np.asarray([0, 1, 5, 700, 1023], np.int32)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), 64, theta)
    c, s = layers.rope_angles(torch.from_numpy(pos), 64, theta)
    close(c, jc, atol=1e-5)
    close(s, js, atol=1e-5)
    x = jnp.asarray(rng.normal(size=(5, 9, 64)), jnp.bfloat16)  # (S, H, D)
    want = jlayers.apply_rope(x, jc, js)
    close(layers.apply_rope(to_t(x), c, s), want, atol=0.02)


@pytest.mark.parametrize("offset", ["scalar", "per_slot"])
@pytest.mark.parametrize("chunk", [16, 1024])
def test_chunked_attention(offset, chunk):
    """The plain-torch chunked path, with KV padding (t = 37 over chunks of
    16) and per-slot offsets (continuous batching)."""
    rng = np.random.default_rng(2)
    b, s, t, h, kv, d = 3, 1 if offset == "per_slot" else 6, 37, 9, 3, 64
    q = jnp.asarray(rng.normal(size=(b, s, h, d)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(b, t, kv, d)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(b, t, kv, d)), jnp.bfloat16)
    if offset == "scalar":
        j_off, t_off = 20, 20
    else:
        j_off = jnp.asarray([0, 17, 36], jnp.int32)
        t_off = torch.tensor([0, 17, 36], dtype=torch.int32)
    want = jlayers.gqa_attention(q, k, v, q_offset=j_off, chunk=chunk)
    got = layers.gqa_attention(to_t(q), to_t(k), to_t(v), q_offset=t_off, chunk=chunk)
    close(got, want, atol=2e-2)
    if offset == "scalar":  # the flash dispatch and the oracle: the same function
        flash = layers.gqa_attention(to_t(q), to_t(k), to_t(v), q_offset=t_off,
                                     impl="flash")
        close(flash, want, atol=3e-2)
        naive = layers.naive_attention(to_t(q), to_t(k), to_t(v), q_offset=t_off)
        close(naive, jlayers.naive_attention(q, k, v, q_offset=j_off), atol=2e-2)


# ---------------------------------------------------------------------------
# (c) the model on carried weights
# ---------------------------------------------------------------------------

def _full2():
    return dataclasses.replace(ref_arch("smollm-135m").config, n_layers=2)


# SmolLM reduced and at full width; the other dense configs reduced (Qwen2:
# QKV bias, G 2; StarCoder2: G 2)
MODELS = {
    "reduced": lambda: ref_arch("smollm-135m").reduced,
    "full_width_2_layers": _full2,
    "qwen2_reduced": lambda: ref_arch("qwen2-1.5b").reduced,
    "starcoder2_reduced": lambda: ref_arch("starcoder2-15b").reduced,
}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    jcfg = MODELS[request.param]()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, params


def _port_cfg(jcfg, **kw) -> lm.LMConfig:
    return lm.LMConfig(**dict(dataclasses.asdict(jcfg), **kw))


LM_CONFIGS = ("qwen3-moe-235b-a22b", "deepseek-moe-16b", "qwen2-1.5b",
              "smollm-135m", "starcoder2-15b")


def test_config_copies_match_the_reference():
    for name in (*LM_CONFIGS, "fm", "gatedgcn", "pna", "egnn", "dimenet", "sameas_rew"):
        ours, theirs = get_arch(name), ref_arch(name)
        assert (ours.name, ours.family, ours.source) == \
            (theirs.name, theirs.family, theirs.source)
        for attr in ("config", "reduced"):
            assert dataclasses.asdict(getattr(ours, attr)) == \
                dataclasses.asdict(getattr(theirs, attr))
        assert [dataclasses.asdict(s) for s in ours.shapes] == \
            [dataclasses.asdict(s) for s in theirs.shapes]
    for name in LM_CONFIGS:
        for attr in ("config", "reduced"):
            ours, theirs = getattr(get_arch(name), attr), getattr(ref_arch(name), attr)
            assert ours.param_count() == theirs.param_count()
            assert ours.active_param_count() == theirs.active_param_count()
    assert get_arch("smollm-135m").config.param_count() == 134_515_008
    assert get_arch("deepseek-moe-16b").config.param_count() == 16_669_853_696
    assert get_arch("deepseek-moe-16b").config.active_param_count() == 2_621_032_448
    assert type(get_arch("egnn").config).__module__ == "repro_torch.models.gnn.egnn"
    assert type(get_arch("dimenet").reduced).__module__ == "repro_torch.models.gnn.dimenet"
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    assert get_arch("smollm_135m") is get_arch("smollm-135m")
    assert get_arch("qwen2_1p5b") is get_arch("qwen2-1.5b")
    moe_cfg = _port_cfg(ref_arch("qwen3-moe-235b-a22b").reduced)
    params = lm.init_params(torch.Generator(), moe_cfg, device="cpu")
    assert params["layers"]["e_gate"].shape == (2, 8, 64, 32)
    assert "w_gate" not in params["layers"]


@pytest.mark.parametrize("cached", [False, True])
def test_layer(model, cached):
    jcfg, jparams, params = model
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(3)
    b, s, t = 2, 5, 12
    x = jnp.asarray(rng.normal(size=(b, s, jcfg.d_model)), jnp.bfloat16)
    jlp = jax.tree.map(lambda a: a[1], jparams["layers"])
    pos0 = 4 if cached else 0
    jc, js = jlayers.rope_angles(jnp.arange(pos0, pos0 + s), jcfg.d_head, jcfg.rope_theta)
    c, sn = to_t(jc), to_t(js)
    if cached:
        shape = (b, t, jcfg.n_kv, jcfg.d_head)
        kc = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
        vc = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
        want, _, (wk, wv) = jlm._layer(jcfg, x, jlp, jc, js, pos0, kc, vc)
        got, _, (gk, gv) = lm._layer(cfg, to_t(x), lm.layer_params(params, 1), c, sn,
                                     pos0, to_t(kc), to_t(vc))
    else:
        want, _, (wk, wv) = jlm._layer(jcfg, x, jlp, jc, js, 0)
        got, _, (gk, gv) = lm._layer(cfg, to_t(x), lm.layer_params(params, 1), c, sn, 0)
    scale = float(jnp.abs(want.astype(jnp.float32)).max())
    close(got, want, atol=max(LOGIT_ATOL, 0.005 * scale))
    close(gk, wk, atol=CACHE_ATOL)
    close(gv, wv, atol=CACHE_ATOL)


@pytest.mark.parametrize("impl", ["xla_chunked", "flash"])
def test_prefill_and_decode(model, impl):
    """Prefill logits and caches, then four teacher-forced decode steps on a
    cache arena of 16 rows (the scalar-offset path: flash with
    ``impl='flash'``)."""
    jcfg, jparams, params = model
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    cfg = _port_cfg(jcfg)
    prompt = np.random.default_rng(4).integers(2, jcfg.vocab, (1, 9)).astype(np.int32)
    jlogits, jcache = jlm.prefill(jparams, jcfg, jnp.asarray(prompt))
    logits, cache = lm.prefill(params, cfg, torch.from_numpy(prompt))
    close(logits, jlogits, atol=LOGIT_ATOL)
    for key in ("k", "v"):
        close(cache[key], jcache[key], atol=CACHE_ATOL)

    t = 16
    jarena = {k: jnp.zeros((jcfg.n_layers, 1, t, jcfg.n_kv, jcfg.d_head),
                           jnp.bfloat16).at[:, :, :9].set(jcache[k]) for k in jcache}
    arena = lm.init_cache(cfg, 1, t, device="cpu")
    for key in arena:
        arena[key][:, :, :9] = cache[key]
    tok = int(jnp.argmax(jlogits[0, -1]))
    for pos in range(9, 13):
        jlogits, jarena = jlm.decode_step(jparams, jcfg, jarena,
                                          jnp.asarray([tok], jnp.int32), jnp.int32(pos))
        logits, arena = lm.decode_step(params, cfg, arena, torch.tensor([tok]), pos)
        close(logits, jlogits, atol=LOGIT_ATOL)
        tok = int(jnp.argmax(jlogits[0]))  # the reference's token feeds both
    for key in ("k", "v"):
        close(arena[key], jarena[key], atol=CACHE_ATOL)


def test_forward_hidden(model):
    jcfg, jparams, params = model
    tokens = np.random.default_rng(5).integers(2, jcfg.vocab, (2, 7)).astype(np.int32)
    want, _ = jlm.forward(jparams, jcfg, jnp.asarray(tokens))
    got, aux = lm.forward(params, _port_cfg(jcfg), torch.from_numpy(tokens))
    close(got, want, atol=LOGIT_ATOL)
    assert float(aux) == 0.0


# ---------------------------------------------------------------------------
# (d) training: the loss and its gradients, remat, the routing log
# ---------------------------------------------------------------------------

# bf16 activations and gradients in both packages, rounded at other places:
# the loss within 1e-3 relative (measured at most 2.1e-4) and each gradient
# leaf within 5 % of its largest reference value (measured at most 2.7 %,
# DeepSeek's attn_norm; 1-2 % for most leaves: a few bf16 units)
LOSS_RTOL = 1e-3
GRAD_REL = 5e-2
TRAIN_MODELS = ("smollm-135m", "deepseek-moe-16b", "qwen3-moe-235b-a22b")


def _grads(params, cfg, tokens):
    """The port's loss and gradient leaves (torch's flatten order)."""
    flat, spec = torch.utils._pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss = lm.loss_fn(torch.utils._pytree.tree_unflatten(leaves, spec), cfg,
                      torch.from_numpy(tokens[:, :-1]), torch.from_numpy(tokens[:, 1:]))
    return loss.detach(), torch.autograd.grad(loss, leaves), spec


@pytest.mark.parametrize("name", TRAIN_MODELS)
def test_loss_and_grads_match_reference(name):
    """The reduced dense and MoE LMs (the MoE router the reference's zeros,
    so every token routes alike in both), ``attn_impl="xla_chunked"`` and
    remat on, as the reference trains."""
    from repro_torch.ckpt.checkpoint import _flatten

    jcfg = ref_arch(name).reduced
    assert jcfg.remat and jcfg.attn_impl == "xla_chunked"
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 17)).astype(np.int32)
    jloss, jgrads = jax.jit(lambda p, t, l: jax.value_and_grad(jlm.loss_fn)(p, jcfg, t, l))(
        jparams, tokens[:, :-1], tokens[:, 1:])
    loss, grads, spec = _grads(params, _port_cfg(jcfg), tokens)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    ours = _flatten(torch.utils._pytree.tree_unflatten(list(grads), spec))
    theirs = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [k for k, _ in ours] == [jax.tree_util.keystr(p) for p, _ in theirs]
    dtypes = {k: p.dtype for k, p in _flatten(params)}
    for (key, g), (_, jg) in zip(ours, theirs):
        assert g.dtype == dtypes[key]
        want = np.asarray(jg.astype(jnp.float32))
        np.testing.assert_allclose(to_np(g), want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("name", ["smollm-135m", "deepseek-moe-16b"])
def test_remat_leaves_the_numbers_unchanged(name):
    """Remat off, on a layer at a time, and on in groups of two: the same
    loss and the same gradient bits."""
    jcfg = ref_arch(name).reduced
    params = lm.init_params(torch.Generator().manual_seed(0), _port_cfg(jcfg), device="cpu")
    if "router" in params["layers"]:  # a seeded router: tokens route apart
        params["layers"]["router"] = torch.randn(params["layers"]["router"].shape,
                                                 generator=torch.Generator().manual_seed(1))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 13)).astype(np.int32)
    runs = [_grads(params, _port_cfg(jcfg, remat=remat, remat_group=group), tokens)
            for remat, group in ((False, 1), (True, 1), (True, 2))]
    for loss, grads, _ in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(grads, runs[0][1], strict=True):
            assert torch.equal(a, b)


def test_routing_log_under_remat():
    """MoE ``REDUCED`` with a seeded router: a log active over a training
    step with remat sees each MoE call once, and a replayed log is spent
    once (the backward's recompute repeats the forward's routing with the
    logs hidden); the gradients equal those without remat under the same
    replay."""
    from repro_torch.models import moe

    jcfg = ref_arch("deepseek-moe-16b").reduced
    params = lm.init_params(torch.Generator().manual_seed(0), _port_cfg(jcfg), device="cpu")
    params["layers"]["router"] = torch.randn(params["layers"]["router"].shape,
                                             generator=torch.Generator().manual_seed(1))
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 13)).astype(np.int32)
    with moe.routing_log(moe.RoutingLog(keep_calls=True)) as log:
        loss, grads, _ = _grads(params, _port_cfg(jcfg), tokens)
    assert log.calls == jcfg.n_layers and len(log.routes) == jcfg.n_layers
    replay = [r["gate_idx"] for r in log.routes]
    # a replay of other experts than the router's: the recompute must follow it
    replay = [(r + 1) % jcfg.n_experts for r in replay]
    out = {}
    for remat in (True, False):
        with moe.routing_log(moe.RoutingLog(replay=replay)) as rlog:
            out[remat] = _grads(params, _port_cfg(jcfg, remat=remat), tokens)
        assert rlog.calls == jcfg.n_layers
    assert torch.equal(out[True][0], out[False][0])
    assert not torch.equal(out[True][0], loss)
    for a, b in zip(out[True][1], out[False][1], strict=True):
        assert torch.equal(a, b)
