"""The port's training machinery on the CPU, case for case with the
reference's ``test_train_loop.py``, ``test_checkpoint.py`` and
``test_compression.py``, plus what crosses packages:

  * the Trainer: kill/restart bit-identical (``torch.equal`` on every
    leaf, on a linear model and on GatedGCN), the loss falls, the NaN
    guard, persistent NaNs abort, the straggler hook (a scripted clock in
    place of ``repro_torch.train.loop.time``) and the heartbeat;
  * checkpoints: round trip, retention, a crashed tmp dir, a structure
    mismatch, the async writer and its snapshot isolation, and a
    checkpoint written by either package restored by the other (a GNN
    training state and a bf16 LM), the same keys and bit-equal leaves;
  * compression: the quantiser's bound (hypothesis), round half to even
    as ``jnp.round``, error feedback, wire bytes 4x, the exchange over
    gloo at world 2 (``launch.mesh.spawn``), SGD parity;
  * ``adamw_update`` and ``clip_by_global_norm`` against the reference's
    on the same numpy gradients: within 1e-6 relative in f32 (measured
    at most 1.2e-7), bf16 parameters within one bf16 unit.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import dataclasses  # noqa: E402
import os  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.ckpt import restore_checkpoint as jrestore, save_checkpoint as jsave  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import transformer as jlm  # noqa: E402
from repro.models.gnn import gatedgcn as jgatedgcn  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.ckpt.checkpoint import _flatten  # noqa: E402
from repro_torch.ckpt import (  # noqa: E402
    CheckpointManager, latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.graphs import graph_to, random_graph  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models.gnn import gatedgcn  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm  # noqa: E402
from repro_torch.optim.compression import (  # noqa: E402
    compress_with_feedback, compressed_grad_exchange, dequantize_int8, init_residuals,
    quantize_int8, wire_bytes,
)
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.train import loop  # noqa: E402


def _equal_trees(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# the Trainer (test_train_loop.py)
# ---------------------------------------------------------------------------

def make_parts(tmp_path, n_steps=30, ckpt_every=10, lr=1e-2, poison_step=None,
               async_ckpt=False):
    def init_params():
        g = torch.Generator().manual_seed(0)
        return {"w": torch.randn((8, 4), generator=g) * 0.1, "b": torch.zeros(4)}

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return torch.mean((pred - batch["y"]) ** 2)

    def batch_fn(step):
        rng = np.random.default_rng(100 + step)
        x = rng.normal(size=(16, 8)).astype(np.float32)
        w_true = np.linspace(-1, 1, 32).reshape(8, 4).astype(np.float32)
        y = x @ w_true
        if poison_step is not None and step == poison_step:
            x = x * np.nan
        return {"x": x, "y": y}

    cfg = TrainConfig(
        n_steps=n_steps,
        ckpt_dir=str(tmp_path),
        ckpt_every=ckpt_every,
        async_ckpt=async_ckpt,
        lr=lr,
        log_every=0,
        heartbeat_path=str(tmp_path / "heartbeat"),
    )
    return loss_fn, init_params, batch_fn, cfg


def gnn_parts(tmp_path, n_steps=30):
    """GatedGCN (reduced) on one random graph, a fresh train mask a step;
    the async writer."""
    cfg = get_arch("gatedgcn").reduced
    graph = graph_to(random_graph(np.random.default_rng(0), 40, 160, cfg.d_in,
                                  cfg.n_classes), "cpu")

    def init_params():
        return gatedgcn.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def loss_fn(params, batch):
        return gatedgcn.loss_fn(params, cfg, batch)

    def batch_fn(step):
        mask = np.random.default_rng(step).random(40) < 0.5
        return dict(graph, train_mask=mask.astype(np.float32))

    tcfg = TrainConfig(n_steps=n_steps, ckpt_dir=str(tmp_path), ckpt_every=10,
                       async_ckpt=True, lr=1e-2, log_every=0)
    return loss_fn, init_params, batch_fn, tcfg


@pytest.mark.parametrize("model", ["linear", "gatedgcn"])
def test_kill_restart_is_bit_identical(tmp_path, model):
    parts = make_parts if model == "linear" else gnn_parts
    loss_fn, init_params, batch_fn, cfg = parts(tmp_path / "a")
    ref = Trainer(loss_fn, init_params(), batch_fn, cfg)
    ref_losses = ref.run()
    ref.close()

    # interrupted run: train to 17 (checkpoint lands at 10), "crash", restart
    loss_fn, init_params, batch_fn, cfg = parts(tmp_path / "b")
    t1 = Trainer(loss_fn, init_params(), batch_fn, cfg)
    t1.run(until=17)  # checkpoints at 10 and (final) 17
    t1.close()
    del t1

    t2 = Trainer(loss_fn, init_params(), batch_fn, cfg)
    assert t2.resume()
    assert t2.step == 17
    losses2 = t2.run()
    t2.close()
    assert ref_losses[17:] == losses2
    _equal_trees(ref.params, t2.params)  # end state identical
    _equal_trees(ref.opt, t2.opt)


def test_loss_decreases(tmp_path):
    loss_fn, init_params, batch_fn, cfg = make_parts(tmp_path, n_steps=60)
    t = Trainer(loss_fn, init_params(), batch_fn, cfg)
    losses = t.run()
    assert np.mean(losses[-10:]) < 0.2 * np.mean(losses[:10])
    assert len(t.step_walls) == 60


def test_nan_guard_skips_update(tmp_path):
    loss_fn, init_params, batch_fn, cfg = make_parts(tmp_path, n_steps=20, poison_step=5)
    t = Trainer(loss_fn, init_params(), batch_fn, cfg)
    seen = {}
    real_step = t._train_step

    def spy(batch):
        before = (t.params, t.opt)
        out = real_step(batch)
        seen[t.step] = (before, (t.params, t.opt))
        return out

    t._train_step = spy
    losses = t.run()
    assert not np.isfinite(losses[5])
    (p0, o0), (p1, o1) = seen[5]
    _equal_trees(p0, p1)  # the poisoned step kept params and moments
    _equal_trees(o0, o1)
    assert np.isfinite(losses[6])  # recovered: params were not poisoned
    assert np.isfinite(losses[-1])
    assert t.nan_skips == 0


def test_persistent_nan_aborts(tmp_path):
    def loss_fn(params, batch):
        return torch.tensor(float("nan")) * torch.sum(params["w"])

    _, init_params, batch_fn, cfg = make_parts(tmp_path, n_steps=20)
    t = Trainer(loss_fn, init_params(), batch_fn, cfg)
    with pytest.raises(FloatingPointError):
        t.run()
    assert t.step == cfg.max_nan_skips  # aborted at the sixth non-finite loss


class _Clock:
    """``time`` for the loop: ``perf_counter`` advances 10 ms a call, and
    ``stall`` seconds more once; ``time`` is a fixed wall clock."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 0.01
        return self.now

    def time(self):
        return 1.7e9

    def stall(self, seconds):
        self.now += seconds


def test_straggler_hook_and_heartbeat(tmp_path, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(loop, "time", clock)
    loss_fn, init_params, batch_fn, cfg = make_parts(tmp_path, n_steps=12)
    events = []

    def slow_batch(step):
        if step == 8:
            clock.stall(0.5)
        return batch_fn(step)

    t = Trainer(loss_fn, init_params(), slow_batch, cfg,
                on_straggler=lambda s, dt: events.append((s, dt)))
    t.run()
    assert [s for s, _ in events] == [8], events
    assert t.straggler_events == events
    hb = open(cfg.heartbeat_path).read().split()
    assert int(hb[0]) == 11 and float(hb[1]) == 1.7e9  # last step heartbeat


# ---------------------------------------------------------------------------
# checkpoints (test_checkpoint.py)
# ---------------------------------------------------------------------------

def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((8, 16), generator=g),
        "b": torch.arange(16, dtype=torch.bfloat16),
        "nested": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def test_roundtrip(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 3, t, aux={"next_step": 3})
    out, aux, step = restore_checkpoint(str(tmp_path), t)
    assert step == 3 and aux["next_step"] == 3
    _equal_trees(t, out)
    assert out["b"].dtype == torch.bfloat16


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = tree()
    for s in (1, 5, 9):
        mgr.save(s, t)
    assert latest_step(str(tmp_path)) == 9
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_000000005", "step_000000009"]  # keep=2


def test_crashed_tmp_dir_is_ignored(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 2, t)
    # a writer that died mid-flight leaves a tmp dir — must not be visible
    os.makedirs(tmp_path / "step_000000007.tmp-9999")
    assert latest_step(str(tmp_path)) == 2
    _, _, step = restore_checkpoint(str(tmp_path), t)
    assert step == 2


def test_structure_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(str(tmp_path), {"other": torch.zeros(3)})


def test_async_writer(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = tree()
    for s in range(4):
        mgr.save(s, t, aux={"next_step": s})
    mgr.wait()
    assert latest_step(str(tmp_path)) == 3
    _, aux, _ = restore_checkpoint(str(tmp_path), t)
    assert aux["next_step"] == 3
    mgr.close()


def test_async_snapshot_isolation(tmp_path):
    """The async save must snapshot values at call time, not write time,
    also when the tensor is then changed in place."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    v = {"x": torch.zeros(4)}
    mgr.save(0, v)
    v["x"].add_(100.0)
    mgr.wait()
    out, _, _ = restore_checkpoint(str(tmp_path), v)
    assert torch.equal(out["x"], torch.zeros(4))
    mgr.close()


def _random_like(jtree, seed):
    """The reference tree with every leaf random (its dtype kept)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)).astype(a.dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else jnp.full(a.shape, 17, a.dtype), jtree)


def _states():
    """A GatedGCN training state (params and AdamW moments, f32, the step
    int32) and a bf16 LM's parameters, in the reference's trees."""
    jg = jgatedgcn.init_params(jax.random.PRNGKey(0), ref_arch("gatedgcn").reduced)
    gnn = {"params": jg, "opt": jadamw.adamw_init(jg)}
    lm = jlm.init_params(jax.random.PRNGKey(1), ref_arch("smollm-135m").reduced)
    return {"gnn": _random_like(gnn, 0), "lm_bf16": _random_like(lm, 1)}


@pytest.mark.parametrize("which", ["gnn", "lm_bf16"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_crosses_packages(tmp_path, which, writer):
    jtree = _states()[which]
    ttree = params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    if which == "lm_bf16":
        assert ttree["layers"]["wq"].dtype == torch.bfloat16
    if writer == "port":
        save_checkpoint(str(tmp_path), 4, ttree, aux={"next_step": 4})
        zeros = jax.tree.map(jnp.zeros_like, jtree)
        out, aux, step = jrestore(str(tmp_path), zeros)
        got = jax.tree_util.tree_flatten_with_path(out)[0]
        want = jax.tree_util.tree_flatten_with_path(jtree)[0]
        for (kp, a), (_, b) in zip(got, want, strict=True):
            assert a.dtype == b.dtype, jax.tree_util.keystr(kp)
            np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                          np.asarray(b).reshape(-1).view(np.uint8))
    else:
        jsave(str(tmp_path), 4, jtree, aux={"next_step": 4})
        zeros = pytree.tree_map(torch.zeros_like, ttree)
        out, aux, step = restore_checkpoint(str(tmp_path), zeros)
        _equal_trees(out, ttree)
    assert (aux, step) == ({"next_step": 4}, 4)


def test_checkpoint_keys_are_the_references(tmp_path):
    """The manifest keys are ``jax.tree_util.keystr`` in JAX's order, for a
    tree built in another insertion order than sorted."""
    jtree = _states()["gnn"]
    ttree = params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    shuffled = {"opt": ttree["opt"], "params": dict(reversed(list(ttree["params"].items())))}
    save_checkpoint(str(tmp_path / "a"), 0, shuffled)
    jsave(str(tmp_path / "b"), 0, jtree)
    import json
    ka = json.load(open(tmp_path / "a" / "step_000000000" / "manifest.json"))
    kb = json.load(open(tmp_path / "b" / "step_000000000" / "manifest.json"))
    assert ka["keys"] == kb["keys"] and ka["dtypes"] == kb["dtypes"]
    assert ka["shapes"] == kb["shapes"]
    assert "['params']['layers'][0]['A'][0]" in ka["keys"]
    out, _, _ = restore_checkpoint(str(tmp_path / "a"), shuffled)
    assert list(out["params"]) == list(shuffled["params"])  # the target's order
    _equal_trees(out, shuffled)


# ---------------------------------------------------------------------------
# compression (test_compression.py)
# ---------------------------------------------------------------------------

@settings(max_examples=50, deadline=None)
@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False), min_size=1, max_size=64))
def test_quantize_bounded_error(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6  # half-ulp of the int8 grid
    jq, js = jcomp.quantize_int8(jnp.asarray(vals, jnp.float32))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_round_half_to_even_as_jnp():
    """Halves of the int8 grid round to even in both packages."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.5])
    q, _ = quantize_int8(x)  # scale 1: q = round(x)
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, 4]
    jq, _ = jcomp.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_error_feedback_recovers_bias():
    """A constant small gradient must not be lost: with error feedback the
    average dequantised update converges to the true gradient."""
    g = torch.full((32,), 1e-4)
    g[0] = 1.0  # tiny vs a 1.0 outlier
    e = torch.zeros_like(g)
    total = torch.zeros_like(g)
    n = 64
    for _ in range(n):
        (q, s), e = compress_with_feedback(g, e)
        total = total + dequantize_int8(q, s)
    # error-feedback bound: |avg - g| <= grid/(2n) = (1/127)/(2*64) ~ 6e-5
    torch.testing.assert_close(total / n, g, rtol=0, atol=1.5e-4)


def test_wire_bytes_4x():
    params = {"a": torch.zeros((128, 128)), "b": torch.zeros(77)}
    comp, full = wire_bytes(params)
    assert full / comp > 3.9
    assert (comp, full) == jcomp.wire_bytes({"a": jnp.zeros((128, 128)), "b": jnp.zeros(77)})
    assert pytree.tree_leaves(init_residuals(params))[0].dtype == torch.float32


def _exchange_rank(rank: int, world: int, out_dir: str) -> None:
    g = torch.stack([torch.linspace(-1, 1, 64), torch.linspace(0, 2, 64)])[rank]
    mean, new_e = compressed_grad_exchange({"g": g}, {"g": torch.zeros(64)})
    torch.save({"mean": mean["g"], "e": new_e["g"]}, os.path.join(out_dir, f"{rank}.pt"))


def test_gloo_exchange_world_2(tmp_path):
    """Two ranks exchange compressed grads over gloo; each rank's mean
    matches the f32 mean within the int8 grid and equals the other's."""
    spawn(_exchange_rank, 2, (str(tmp_path),), store_path=str(tmp_path / "store"),
          timeout_s=60, threads=1)
    outs = [torch.load(tmp_path / f"{r}.pt") for r in range(2)]
    g = torch.stack([torch.linspace(-1, 1, 64), torch.linspace(0, 2, 64)])
    for r, o in enumerate(outs):
        torch.testing.assert_close(o["mean"], g.mean(0), rtol=0, atol=1e-2)
        (_, _), e = compress_with_feedback(g[r], torch.zeros(64))
        assert torch.equal(o["e"], e)
    assert torch.equal(outs[0]["mean"], outs[1]["mean"])


def test_sgd_convergence_parity():
    """SGD on a quadratic with compressed grads converges like exact SGD."""
    w_true = torch.from_numpy(np.random.default_rng(0).normal(size=16).astype(np.float32))
    w_exact = torch.zeros(16)
    w_comp = torch.zeros(16)
    e = torch.zeros(16)
    lr = 0.2
    for _ in range(80):
        w_exact = w_exact - lr * (w_exact - w_true)
        (q, s), e = compress_with_feedback(w_comp - w_true, e)
        w_comp = w_comp - lr * dequantize_int8(q, s)
    assert float(torch.linalg.norm(w_exact - w_true)) < 1e-3
    assert float(torch.linalg.norm(w_comp - w_true)) < 1e-2


# ---------------------------------------------------------------------------
# AdamW against the reference
# ---------------------------------------------------------------------------

def _pairs(ours, theirs):
    """The two trees' leaves paired by their keys (JAX's order)."""
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [k for k, _ in _flatten(ours)] == [jax.tree_util.keystr(p) for p, _ in flat]
    return [(o, t) for (_, o), (_, t) in zip(_flatten(ours), flat)]


def _adam_tree(rng):
    return {
        "w": rng.normal(size=(8, 4)).astype(np.float32),
        "layers": [{"A": (rng.normal(size=(4, 4)).astype(np.float32),
                          np.zeros(4, np.float32))} for _ in range(2)],
        "emb": rng.normal(size=(6, 3)).astype(np.float32),
    }


def test_adamw_matches_reference_on_shared_grads():
    """Three steps on the same numpy gradients (one step clipped at
    ``max_norm``, a bf16 leaf): params, moments, step and the global norm."""
    rng = np.random.default_rng(0)
    p0 = _adam_tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    jp["emb"] = jp["emb"].astype(jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jst, tst = jadamw.adamw_init(jp), adamw_init(tp)
    for i, scale in enumerate((0.01, 10.0, 0.3)):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32), p0)
        jg = jax.tree.map(jnp.asarray, g)
        jg["emb"] = jg["emb"].astype(jnp.bfloat16)
        tg = params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")
        jp, jst, jgn = jadamw.adamw_update(jp, jg, jst, lr=1e-2)
        tp, tst, tgn = adamw_update(tp, tg, tst, lr=1e-2)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        assert tst["step"].dtype == torch.int32
        for ours, theirs in ((tp, jp), (tst["mu"], jst["mu"]), (tst["nu"], jst["nu"])):
            for o, t in _pairs(ours, theirs):
                t = np.asarray(t.astype(jnp.float32))
                if o.dtype == torch.bfloat16:
                    np.testing.assert_allclose(o.float().numpy(), t, rtol=2 ** -7, atol=0)
                else:
                    np.testing.assert_allclose(o.numpy(), t, rtol=1e-6, atol=1e-9)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    g = _adam_tree(rng)
    for max_norm in (0.5, 1e3):
        jc, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
        tc, tn = clip_by_global_norm(params_from_numpy(g, "cpu"), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for o, t in _pairs(tc, jc):
            np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=1e-6, atol=1e-9)
