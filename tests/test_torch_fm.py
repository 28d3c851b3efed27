"""The port's FM (``repro_torch.models.recsys``) against the reference's
(``repro.models.recsys``) on the CPU, with the reference's weights carried
over by ``params_from_numpy``.

Everything is f32; the two packages sum in other orders, so values agree
to rtol 1e-5 (atol 1e-6 for terms near 0), the reference's own tolerance
for its fused kernel.  The FM interaction's plain version is held against
the reference's Pallas kernel in interpret mode on the reference's own
sweep (``tests/test_kernels.py``), with that sweep's tolerances.
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
from repro.models import recsys as jfm  # noqa: E402
from repro_torch.core.uf import merge_pairs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import recsys as fm  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _cfgs():
    reduced = ref_arch("fm").reduced
    # the full config's fields and width over a small table
    wide = dataclasses.replace(ref_arch("fm").config, rows_per_field=1000)
    return {"reduced": reduced, "criteo_widths": wide}


@pytest.fixture(scope="module", params=["reduced", "criteo_widths"])
def model(request):
    jcfg = _cfgs()[request.param]
    jparams = jfm.init_params(jax.random.PRNGKey(0), jcfg)
    # non-zero first-order weights and bias, so every term is exercised
    rng = np.random.default_rng(0)
    jparams["w1"] = jnp.asarray(rng.normal(size=(jcfg.n_rows,)) * 0.1, jnp.float32)
    jparams["bias"] = jnp.asarray(0.25, jnp.float32)
    params = fm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, params


def _batch(cfg, b, seed):
    ids = np.random.default_rng(seed).integers(0, cfg.rows_per_field, (b, cfg.n_fields))
    return ids.astype(np.int32)


def _port_cfg(jcfg, **kw):
    return fm.FMConfig(**dict(dataclasses.asdict(jcfg), **kw))


def _rho(cfg, seed):
    """A representative map merging seeded pairs inside each field, made by
    the port's own union-find (``merge_pairs``, its plain version here)."""
    rng = np.random.default_rng(seed)
    n_pairs = cfg.rows_per_field // 3
    field = rng.integers(0, cfg.n_fields, n_pairs)
    a, b = (rng.integers(0, cfg.rows_per_field, (2, n_pairs))
            + field * cfg.rows_per_field)
    pairs = torch.from_numpy(np.stack([a, b], axis=1).astype(np.int32))
    rep = torch.arange(cfg.n_rows, dtype=torch.int32)
    return merge_pairs(rep, pairs, torch.ones(n_pairs, dtype=torch.bool))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("with_rho", [False, True])
def test_forward_and_serve_step(model, use_pallas, with_rho):
    jcfg, jparams, params = model
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    cfg = _port_cfg(jcfg)
    ids = _batch(cfg, 37, 1)
    jbatch, batch = {"ids": jnp.asarray(ids)}, {"ids": torch.from_numpy(ids)}
    if with_rho:
        rho = _rho(cfg, 2)
        jbatch["rho"], batch["rho"] = jnp.asarray(rho.numpy()), rho
    for jfn, fn in ((jfm.forward, fm.forward), (jfm.serve_step, fm.serve_step)):
        want = np.asarray(jfn(jparams, jcfg, jbatch))
        got = fn(params, cfg, batch)
        assert got.dtype == torch.float32 and got.shape == (37,)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_retrieval_scores(model, use_pallas):
    jcfg, jparams, params = model
    ids = _batch(jcfg, 1, 3)
    cand = np.random.default_rng(4).integers(0, jcfg.n_rows, 50).astype(np.int32)
    want = np.asarray(jfm.retrieval_scores(jparams, jcfg, jnp.asarray(ids),
                                           jnp.asarray(cand)))
    got = fm.retrieval_scores(params, _port_cfg(jcfg, use_pallas=use_pallas),
                              torch.from_numpy(ids), torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_field_bags_go_through_embedding_bag(model, monkeypatch):
    """Under ``use_pallas`` the first-order term is one bag of the (V, 1)
    weights per row and the retrieval query one bag of the table; without
    it neither calls the kernel."""
    jcfg, _, params = model
    calls = []
    real = ops.embedding_bag

    def spy(ids, table):
        calls.append((tuple(ids.shape), tuple(table.shape)))
        return real(ids, table)

    monkeypatch.setattr(ops, "embedding_bag", spy)
    ids = torch.from_numpy(_batch(jcfg, 5, 8))
    cand = torch.arange(10, dtype=torch.int32)
    for use_pallas in (False, True):
        cfg = _port_cfg(jcfg, use_pallas=use_pallas)
        fm.serve_step(params, cfg, {"ids": ids})
        fm.retrieval_scores(params, cfg, ids[:1], cand)
    f, k = jcfg.n_fields, jcfg.embed_dim
    assert calls == [((5, f), (jcfg.n_rows, 1)), ((1, f), (jcfg.n_rows, k))]


@pytest.mark.parametrize("b,f,k", [(3, 5, 4), (300, 39, 10), (1024, 26, 16)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fm_interact_plain_matches_pallas(b, f, k, dtype):
    rng = np.random.default_rng(b + f + k)
    x = jnp.asarray(rng.normal(size=(b, f, k)), dtype)
    want = jops.fm_interact(x)
    got = ops.fm_interact(fm.params_from_numpy(np.asarray(x), "cpu"))
    want_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    assert got.shape == (b,) and got.dtype == want_dtype
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        rtol=1e-5 if dtype == jnp.float32 else 5e-2, atol=1e-2,
    )


def test_sameas_rho_unifies_ids():
    """The reference's rho test (tests/test_arch_smoke.py): two IDs merged
    by rho produce identical scores, with the jnp and the kernel path."""
    jcfg = ref_arch("fm").reduced
    params = fm.params_from_numpy(
        jax.tree.map(np.asarray, jfm.init_params(jax.random.PRNGKey(0), jcfg)), "cpu")
    rho = torch.arange(jcfg.n_rows, dtype=torch.int32)
    rho[7] = 3  # merge row 7 into row 3 of field 0
    ids_a = torch.full((1, jcfg.n_fields), 5, dtype=torch.int32)
    ids_b = ids_a.clone()
    ids_a[0, 0], ids_b[0, 0] = 7, 3
    for use_pallas in (False, True):
        cfg = _port_cfg(jcfg, use_pallas=use_pallas)
        sa = fm.forward(params, cfg, {"ids": ids_a, "rho": rho})
        sb = fm.forward(params, cfg, {"ids": ids_b, "rho": rho})
        assert torch.equal(sa, sb)
        unmerged = fm.forward(params, cfg, {"ids": ids_a})
        assert not torch.equal(unmerged, sb)


def test_merged_rows_score_the_same():
    """Every member of a rho clique scores as its representative."""
    jcfg = _cfgs()["criteo_widths"]
    cfg = _port_cfg(jcfg, use_pallas=True)
    params = fm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rho = _rho(cfg, 5)
    merged = torch.nonzero(rho != torch.arange(cfg.n_rows)).flatten()
    assert merged.numel() > 0
    members = merged[:cfg.n_fields]
    field = members // cfg.rows_per_field
    ids = torch.from_numpy(_batch(cfg, members.numel(), 6))
    rep_ids = ids.clone()
    rows = torch.arange(members.numel())
    ids[rows, field] = (members % cfg.rows_per_field).to(torch.int32)
    rep_ids[rows, field] = (rho[members].long() % cfg.rows_per_field).to(torch.int32)
    a = fm.serve_step(params, cfg, {"ids": ids, "rho": rho})
    b = fm.serve_step(params, cfg, {"ids": rep_ids, "rho": rho})
    assert torch.equal(a, b)


def test_loss_and_grads_match_reference(model):
    """``loss_fn`` on ``recsys_batch`` (``use_pallas=False``, the
    reference's autodiff path), and the gradient of the table, the
    first-order weights and the bias: f32, within rtol 1e-5 of the loss
    and 1e-5 of each leaf's largest gradient (sums in another order)."""
    from repro.data.pipeline import recsys_batch

    jcfg, jparams, params = model
    batch = recsys_batch(3, 64, jcfg.n_fields, jcfg.rows_per_field)
    jloss, jgrads = jax.value_and_grad(jfm.loss_fn)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = fm.loss_fn(leaves, _port_cfg(jcfg), {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for key, g in zip(leaves, grads):
        want = np.asarray(jgrads[key])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + 1e-12, err_msg=key)
