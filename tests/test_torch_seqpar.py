"""The reference's training-memory layout in the port's LM train path.

* Sequence-parallel residuals: in the reference's train cells
  (``repro.launch.workloads``) the activation between layers is split by
  sequence over ``model`` where ``model`` divides the sequence
  (``seq_ok``), so the residual saved at each remat boundary is a block.
  Here the port's train cell (``launch.workloads.build_cell``) runs on
  fake tensors as rank 0 of (data 2, model 2) in a ``fake`` group
  (``dryrun.fake_group``), under a ``saved_tensors_hooks`` census of what
  autograd keeps for the backward: each layer group's residual, the input
  the group's checkpoint saves, is (B / 2, S / 2, D) at seq 16, and whole,
  (B / 2, 15, D), at seq 15.  The collectives over ``model`` are then the
  all-gather and reduce-scatter pairs.  (The values: the LM, FSDP and MoE
  cases of ``test_torch_shard_train.py`` against the reference's cells.)
* Chunk-level recompute: under grad each KV chunk of ``attention_state``
  runs under a checkpoint (the reference's ``jax.checkpoint`` of its scan
  body), so nothing of a chunk's (B, KV, G, S, chunk) score blocks is kept
  past the chunk, and the gradients of q, k and v equal the reference's
  ``jax.grad`` of ``gqa_attention`` (``xla_chunked``) within ``GRAD_RTOL``
  of the largest gradient (f32 sums in another order).
* The dry run's peak of a reduced LM train step at a fixed sequence does
  not grow as the KV chunk count grows (it fell with more chunks: the
  blocks of one chunk at a time), and what a layer adds to it grows with
  the sequence by one residual's bytes a token, no more: a chunk's
  checkpoint that held a tensor of its layer by closure (the roped q, say)
  would keep it alive to the backward, a second (B, S, D)-sized tensor a
  layer, which the layer-group checkpoint cannot drop.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch.dryrun import _fake_inputs, count_step, fake_group  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.workloads import build_cell, value_and_grad  # noqa: E402
from repro_torch.models import layers  # noqa: E402

GRAD_RTOL = 1e-5  # of the largest |gradient|: f32 sums in another order
BATCH = 4


def _reduced(arch: str, **over):
    spec = get_arch(arch)
    return dataclasses.replace(spec, config=dataclasses.replace(spec.reduced, **over))


def _census(arch: str, seq: int) -> tuple:
    """The shapes and dtypes autograd saves in one loss of the train cell
    at (data 2, model 2), rank 0, and the model axis's collectives."""
    spec = _reduced(arch)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        wl = build_cell(spec, ShapeSpec("t", "train", dict(global_batch=BATCH, seq_len=seq)),
                        mesh)
        with FakeTensorMode():
            params, _, tokens, labels = _fake_inputs(wl)
            mesh.reset_counts()
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                value_and_grad(wl.loss, params, tokens, labels)
        calls = {k: v for k, v in mesh.calls.items() if k.startswith("model:")}
    return spec.config, saved, calls


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "smollm-135m", "deepseek-moe-16b"])
@pytest.mark.parametrize("seq", [16, 15])
def test_layer_residuals_are_sequence_blocks(arch, seq):
    cfg, saved, calls = _census(arch, seq)
    d, b = cfg.d_model, BATCH // 2
    # what the forward keeps outside the layer checkpoints: each group's
    # input residual (in order, first), then the final norm's and the
    # loss's tensors
    residuals = [s for s, dt in saved if dt == torch.bfloat16 and len(s) == 3 and s[-1] == d]
    groups = cfg.n_layers // (cfg.remat_group if cfg.n_layers % cfg.remat_group == 0 else 1)
    assert len(residuals) >= groups, saved
    want = (b, seq // 2, d) if seq % 2 == 0 else (b, seq, d)
    assert residuals[:groups] == [want] * groups, (residuals, saved)
    if seq % 2 == 0:
        # every 3-D activation kept is a block: the gathered sequence lives
        # only inside a checkpoint (the logits' input is kept 2-D)
        assert all(s[1] == seq // 2 for s in residuals), residuals
        assert calls.get("model:all_gather") and calls.get("model:reduce_scatter"), calls
    else:
        assert all(s[1] == seq for s in residuals), residuals
        # wo's and the FFN's partial sums all-reduced, each layer forward
        assert calls["model:all_reduce"] >= 2 * cfg.n_layers, calls


def _qkv(seed: int, b=2, s=64, h=6, kv=2, dh=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, n, dh)).astype(np.float32) for n in (h, kv, kv)]


def test_attention_keeps_no_score_block_past_its_chunk():
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(0))
    s, chunk = q.shape[1], 16
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = layers.gqa_attention(q, k, v, causal=True, chunk=chunk)
    blocks = [sh for sh in saved if sh[-2:] == (s, chunk)]
    assert not blocks, blocks
    # what is kept: each chunk's queries, carries and keys/values, the
    # output's inputs
    assert len(saved) <= 6 * (s // chunk) + 4, saved
    out.sum().backward()
    with torch.no_grad():  # grad off: the plain loop, the same values
        again = layers.gqa_attention(q, k, v, causal=True, chunk=chunk)
    assert torch.equal(again, out.detach())


@pytest.mark.parametrize("causal", [True, False])
def test_attention_grads_equal_reference(causal):
    qn, kn, vn = _qkv(1)
    ct = np.random.default_rng(2).standard_normal(qn.shape).astype(np.float32)
    chunk = 16  # 4 chunks of the 64 keys

    def jloss(q, k, v):
        out = jlayers.gqa_attention(q, k, v, causal=causal, chunk=chunk, impl="xla_chunked")
        return jnp.sum(out * ct)

    want = jax.grad(jloss, argnums=(0, 1, 2))(qn, kn, vn)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (qn, kn, vn))
    out = layers.gqa_attention(q, k, v, causal=causal, chunk=chunk)
    (out * torch.from_numpy(ct)).sum().backward()
    for name, got, w in zip("qkv", (q.grad, k.grad, v.grad), want):
        w = np.asarray(w)
        err = float(np.abs(got.numpy() - w).max()) / float(np.abs(w).max())
        print(f"d{name}: {err:.3g} of the largest")
        assert err <= GRAD_RTOL, (name, err)


PEAK_BATCH = 2


@functools.lru_cache(maxsize=None)
def _peak(chunk: int, layers: int, seq: int) -> int:
    """The dry run's peak bytes of one train step of the reduced SmolLM."""
    spec = _reduced("smollm-135m", attn_chunk=chunk, n_layers=layers)
    with fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"))
        wl = build_cell(spec, ShapeSpec("t", "train", dict(global_batch=PEAK_BATCH,
                                                            seq_len=seq)), mesh)
        return count_step(wl, mesh)["memory"]["peak_bytes"]


def test_dryrun_peak_does_not_grow_with_chunks():
    peaks = [_peak(c, 2, 256) for c in (256, 128, 64, 32)]  # 1, 2, 4 and 8 chunks
    print("peaks", peaks)
    assert all(b <= a for a, b in zip(peaks, peaks[1:])), peaks


def test_dryrun_peak_grows_a_layer_by_its_residual():
    # at 2 and 3 layers of 8 chunks and then 4, where the layers' backward
    # sets the peak: a layer's parameters and moments add the same at
    # either sequence, its residual B x D bf16 a token (and the step a few
    # f32 a token); a second activation kept a layer would add as much again
    d = get_arch("smollm-135m").reduced.d_model
    short, long = 128, 256
    grew = [_peak(32, 3, s) - _peak(32, 2, s) for s in (short, long)]
    residual = PEAK_BATCH * (long - short) * d * 2
    print("a layer adds", grew, "residual bytes of the extra tokens", residual)
    assert grew[1] - grew[0] <= 1.5 * residual, (grew, residual)
