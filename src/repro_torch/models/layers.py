"""Transformer building blocks: RMSNorm, RoPE, GQA attention (chunked
online-softmax, or the flash kernel), SwiGLU.

The port of ``repro.models.layers``: pure functions over tensors, bf16
activations and f32 norm accumulations, with the reference's order of
dtype casts (``rms_norm`` scales after the cast to the activation type,
``swiglu`` applies silu in f32 and casts back).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops

DTYPE = torch.bfloat16
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope_angles(positions: torch.Tensor, d_head: int, theta: float = 1e6):
    """positions (...,) -> (cos, sin) each (..., d_head//2), f32."""
    half = d_head // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., n_heads, d_head); cos/sin broadcastable to (..., 1, d_head//2)."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_in, w_out):
    g = x @ w_gate.to(x.dtype)
    u = x @ w_in.to(x.dtype)
    return (F.silu(g.float()).to(x.dtype) * u) @ w_out.to(x.dtype)


def _is_scalar(q_offset) -> bool:
    return not (isinstance(q_offset, torch.Tensor) and q_offset.dim() >= 1)


def gqa_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, T, KV, Dh)
    v: torch.Tensor,  # (B, T, KV, Dh)
    causal: bool = True,
    q_offset: int | torch.Tensor = 0,
    chunk: int = 1024,
    impl: str = "xla_chunked",
) -> torch.Tensor:
    """GQA attention with the reference's dispatch.

    ``impl="flash"`` with a scalar ``q_offset`` calls the flash kernel
    (:func:`repro_torch.kernels.ops.flash_attention`); otherwise the chunked
    online-softmax path runs as plain torch ops over KV chunks with running
    (max, denominator, accumulator), with a scalar offset or per-slot
    offsets (B,) (continuous batching).  Like the reference's XLA path, it
    rounds the scores to the input type before scaling and the
    probabilities to it before the PV product.
    """
    if impl == "flash" and _is_scalar(q_offset):
        return ops.flash_attention(q, k, v, causal=causal, q_offset=int(q_offset))
    _, l, acc = attention_state(q, k, v, causal=causal, q_offset=q_offset, chunk=chunk)
    return attention_out(l, acc, q.dtype)


def attention_state(q, k, v, causal: bool = True, q_offset=0, chunk: int = 1024,
                    k_offset: int = 0):
    """The chunked online softmax of :func:`gqa_attention` over the keys
    ``k``/``v`` (B, T, KV, Dh), which sit at positions ``k_offset + t`` (a
    sequence block of a longer cache): its running max ``m`` and
    denominator ``l``, each (B, KV, G, S), and its accumulator ``acc`` (B,
    S, KV, G, Dh), all f32.  States over disjoint blocks of keys merge by
    rescaling to their common max; :func:`attention_out` finishes one.
    Under grad each chunk's step runs under ``torch.utils.checkpoint``."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, dh)

    n_chunks = max(1, (t + chunk - 1) // chunk)
    pad = n_chunks * chunk - t
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kc = k.reshape(b, n_chunks, chunk, kv, dh)
    vc = v.reshape(b, n_chunks, chunk, kv, dh)
    dev = q.device
    per_slot = not _is_scalar(q_offset)
    if causal:
        off = q_offset.to(dev) if per_slot else q_offset
        q_pos = (off[:, None] if per_slot else off) + torch.arange(s, device=dev)

    def step(qg, m, l, acc, kb, vb, c: int):
        scores = torch.einsum("bskgd,btkd->bkgst", qg, kb).float()
        scores = scores / (dh**0.5)
        k_pos = c * chunk + torch.arange(chunk, device=dev)
        valid = k_pos < t
        if k_offset:
            k_pos = k_pos + k_offset
        if causal and per_slot:
            mask = valid[None, None, :] & (q_pos[:, :, None] >= k_pos[None, None, :])
            scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
        elif causal:
            mask = valid[None, :] & (q_pos[:, None] >= k_pos[None, :])
            scores = torch.where(mask, scores, NEG_INF)
        else:
            scores = torch.where(valid, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bskgd", p.to(qg.dtype), vb).float()
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
        return m_new, l, acc

    # under grad, each chunk's step is checkpointed (the reference's
    # jax.checkpoint of its scan body): the backward keeps the carries and
    # recomputes one chunk's (B, KV, G, S, chunk) blocks at a time.  Every
    # tensor enters the step as an argument: a checkpoint keeps its
    # function, and so its closure, until its backward, beyond an
    # enclosing checkpoint's reach
    remat = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    m = torch.full((b, kv, g, s), -float("inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, kv, g, dh), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        if remat:
            m, l, acc = torch.utils.checkpoint.checkpoint(
                step, qg, m, l, acc, kc[:, c], vc[:, c], c, use_reentrant=False,
                preserve_rng_state=False)
        else:
            m, l, acc = step(qg, m, l, acc, kc[:, c], vc[:, c], c)
    return m, l, acc


def attention_out(l: torch.Tensor, acc: torch.Tensor, dtype) -> torch.Tensor:
    """The attention output (B, S, H, Dh) in ``dtype`` of a (merged)
    :func:`attention_state`."""
    b, s, kv, g, dh = acc.shape
    out = acc / torch.clamp_min(l.permute(0, 3, 1, 2)[..., None], 1e-30)
    return out.reshape(b, s, kv * g, dh).to(dtype)


def naive_attention(q, k, v, causal=True, q_offset=0):
    """Reference quadratic attention (oracle for the chunked version)."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / (dh**0.5)
    if causal:
        q_pos = q_offset + torch.arange(s, device=q.device)
        mask = q_pos[:, None] >= torch.arange(t, device=q.device)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype), v)
    return out.reshape(b, s, h, dh)
