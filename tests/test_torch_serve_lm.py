"""The port's LM server (``repro_torch.serve``): continuous batching with
per-slot positions must reproduce one-at-a-time greedy decoding, and its
batched decode step must match the reference's ``decode_step_multipos``.

Token streams are compared only within the port: torch's and XLA's CPU
bf16 matmuls round apart, so greedy streams of the two packages can part at
a near-tie.  Across packages the test holds logits and caches, on the same
carried weights and the same tokens.
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
from repro.models import transformer as jlm  # noqa: E402
from repro.serve.engine import decode_step_multipos as j_multipos  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.serve import Request, ServeEngine, decode_step_multipos  # noqa: E402


def tiny():
    cfg = get_arch("smollm-135m").reduced
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, params


def greedy_reference(params, cfg, prompt, n_new):
    """Sequential reference: prefill + single-sequence decode_step."""
    logits, cache = lm.prefill(params, cfg, torch.tensor([prompt]))
    max_len = len(prompt) + n_new + 1
    arena = lm.init_cache(cfg, 1, max_len, device="cpu")
    for key in ("k", "v"):
        arena[key][:, :, :len(prompt)] = cache[key]
    out = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, arena = lm.decode_step(params, cfg, arena, torch.tensor([out[-1]]), pos)
        out.append(int(torch.argmax(logits[0])))
        pos += 1
    return out


def test_engine_matches_sequential_greedy():
    """Exact: the batched step (two slots, per-slot offsets, an arena of 32
    rows) and the sequential one (one row, a scalar offset, an arena of
    prompt + n_new + 1 rows) compute each row with the same ops on the same
    values, and masked keys add exact zeros to the softmax sums."""
    cfg, params = tiny()
    prompts = [[5, 9, 2], [7, 7], [1, 2, 3, 4]]
    n_new = 6
    refs = [greedy_reference(params, cfg, p, n_new) for p in prompts]

    eng = ServeEngine(params, cfg, n_slots=2, max_len=32, eos_id=-1, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new=n_new))
    done = eng.run()
    assert len(done) == 3
    by_uid = {r.uid: r.out for r in done}
    for i, ref in enumerate(refs):
        assert by_uid[i] == ref, f"req {i}: {by_uid[i]} != {ref}"
    st = eng.stats
    assert (st.prefills, st.prefill_tokens) == (3, 9)
    assert st.decode_tokens == 3 * (n_new - 1)


def test_more_requests_than_slots_all_finish():
    cfg, params = tiny()
    eng = ServeEngine(params, cfg, n_slots=2, max_len=24, eos_id=-1, device="cpu")
    for i in range(5):
        eng.submit(Request(uid=i, prompt=[i + 1, i + 2], max_new=4))
    done = eng.run()
    assert sorted(r.uid for r in done) == list(range(5))
    assert all(len(r.out) == 4 for r in done)


def test_eos_eviction_frees_slot():
    cfg, params = tiny()
    eng0 = ServeEngine(params, cfg, n_slots=1, max_len=24, eos_id=-1, device="cpu")
    eng0.submit(Request(uid=0, prompt=[3, 1], max_new=3))
    first = eng0.run()[0].out[0]

    eng = ServeEngine(params, cfg, n_slots=1, max_len=24, eos_id=first, device="cpu")
    eng.submit(Request(uid=0, prompt=[3, 1], max_new=8))
    eng.submit(Request(uid=1, prompt=[4, 4], max_new=2))
    done = eng.run()
    assert done[0].uid == 0 and len(done[0].out) == 1  # stopped at EOS
    assert done[1].uid == 1 and len(done[1].out) == 2


def test_flash_engine_serves_with_the_same_scheduler():
    """With ``attn_impl='flash'`` the prefills take the flash path (its
    plain version on the CPU) and the batched decode the chunked one."""
    cfg, params = tiny()
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    eng = ServeEngine(params, cfg, n_slots=3, max_len=40, eos_id=-1, device="cpu")
    for i in range(4):
        eng.submit(Request(uid=i, prompt=list(range(2, 4 + 3 * i)), max_new=5))
    done = eng.run()
    assert sorted(r.uid for r in done) == [0, 1, 2, 3]
    assert all(len(r.out) == 5 for r in done)


@pytest.mark.parametrize("which", ["reduced", "full_width_2_layers"])
def test_batched_decode_matches_reference_multipos(which):
    """One batched step on a seeded arena, with per-slot positions that
    include an inactive slot at 0 and a slot at the arena's last row (the
    write start clamps there as ``dynamic_update_slice`` does).  Logits
    within 0.1 (bf16, |logit| < 8), caches within 0.0625."""
    jcfg = ref_arch("smollm-135m").reduced
    if which != "reduced":
        jcfg = dataclasses.replace(ref_arch("smollm-135m").config, n_layers=2)
    jparams = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    cfg = lm.LMConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(6)
    b, t = 4, 20
    shape = (jcfg.n_layers, b, t, jcfg.n_kv, jcfg.d_head)
    jcache = {k: jnp.asarray(rng.normal(size=shape), jnp.bfloat16) for k in ("k", "v")}
    cache = {k: lm.params_from_numpy(np.asarray(v), "cpu") for k, v in jcache.items()}
    tokens = rng.integers(2, jcfg.vocab, b).astype(np.int32)
    positions = np.asarray([5, 0, 19, 11], np.int32)
    want, jnew = j_multipos(jparams, jcfg, jcache, jnp.asarray(tokens),
                            jnp.asarray(positions))
    got, new = decode_step_multipos(params, cfg, cache, torch.from_numpy(tokens),
                                    torch.from_numpy(positions))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=0.1)
    for key in ("k", "v"):
        np.testing.assert_allclose(new[key].float().numpy(),
                                   np.asarray(jnew[key], np.float32), atol=0.0625)
