"""Decoder-only LM (dense or MoE): GQA (+ optional QKV bias), RoPE, SwiGLU
dense FFN or DeepSeek/Qwen-style MoE (optional shared experts), tied
embeddings.  The port of ``repro.models.transformer``:

  * ``loss_fn``     — training loss over (tokens, labels),
  * ``forward``     — full-sequence hidden states (layers under
    ``torch.utils.checkpoint`` with ``cfg.remat``, a checkpoint a group
    of ``cfg.remat_group`` layers),
  * ``prefill``     — full-sequence forward building a KV cache,
  * ``decode_step`` — one new token against a static-size KV cache.

Parameters keep the reference's pytree: ``{"embed", "final_norm",
"layers": {name: (L, ...) stacked tensor}}``, so a reference checkpoint
carries over through :func:`params_from_numpy`.  The layers run as a loop
over the stacked tensors.  Training runs with ``attn_impl="xla_chunked"``,
as the reference's: the flash kernel has no backward.

Sharded training: ``param_shardings`` is the reference's layout (heads,
FFN, experts and vocab over ``model``; with ``cfg.fsdp`` also a free
dimension over the data axes), and ``forward``/``loss_fn`` with a
``mesh`` run on each rank's blocks of it, its batch rows of the data
axes: q/k/v, gate and in column-parallel, o and out row-parallel with a
sum over ``model``; the tied embedding vocab-parallel (a masked lookup,
then the sum) and so the cross entropy (max, log-sum-exp and the label
logit reduced over ``model``); the loss a mean over the data axes.  A
rank attends over its whole heads where ``model`` divides both head
counts, and otherwise gathers the q/k/v columns over ``model`` first.
Under FSDP each layer's weights are all-gathered inside the layer loop
(their gradients reduce-scattered).  The gradients a rank gets are its
blocks' partial sums over the data axes (the optimizer's ZeRO-1 step sums
them).

Sharded serving (the prefill and decode cells of
:mod:`repro_torch.launch.workloads`): ``prefill`` with a ``mesh`` runs the
same blocks and hands each model rank its sequence block of every KV head
(an all-to-all over ``model`` turns head columns into sequence blocks, or
the block is cut from the gathered heads); ``decode_step`` with a ``mesh``
gathers every head's q, k and v over ``model``, attends over the rank's
block of the cache (:func:`~repro_torch.models.layers.attention_state`),
merges the partial softmax states over ``model`` (their max, then the
rescaled sums) and applies this rank's columns of ``wo``.  Its logits are
vocab-parallel, as the prefill's are.

Where the reference returns a fresh cache (JAX arrays are immutable),
``decode_step`` and ``_layer`` write the new K/V into the given cache in
place and return it: the arena is the largest tensor of a server.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.compat import pytree
from repro_torch.core import collectives as coll
from repro_torch.device import resolve
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.sharding import NamedSharding, PartitionSpec as P, ShapeDtype

from .layers import (DTYPE, apply_rope, attention_out, attention_state, gqa_attention,
                     rms_norm, rope_angles, swiglu)
from .moe import moe_ffn, remat_contexts


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 1e6
    # MoE (0 experts = dense)
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    attn_chunk: int = 1024
    attn_impl: str = "xla_chunked"  # "flash" = the hand-written CUDA kernel
    # recompute each group of remat_group layers in the backward (forward)
    remat: bool = True
    remat_group: int = 1
    # sharding fields, kept so that the reference's configs carry over
    n_token_shards: int = 1
    dp_axes: tuple = ()
    ep_axis: str | None = None
    fsdp: bool = False

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        d, l = self.d_model, self.n_layers
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv * self.d_head
        attn += self.n_heads * self.d_head * d
        if self.is_moe:
            ffn = 3 * d * self.d_expert * (self.n_experts + self.n_shared)
            ffn += d * self.n_experts  # router
        else:
            ffn = 3 * d * self.d_ff
        return l * (attn + ffn + 2 * d) + self.vocab * d + d

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv * self.d_head
        attn += self.n_heads * self.d_head * d
        ffn = 3 * d * self.d_expert * (self.top_k + self.n_shared) + d * self.n_experts
        return l * (attn + ffn + 2 * d) + self.vocab * d + d


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: LMConfig,
                device: str | torch.device = "cuda") -> dict:
    """Random weights drawn from ``gen`` (on its own device), placed on
    ``device``: normal / sqrt(fan_in) in f32, stored in bf16; norms are
    ones in f32; an MoE router is zeros in f32, as the reference's.  The
    expert stacks are drawn a layer at a time, so that the f32 draw of a
    whole stack never lies in memory.  The draws differ from
    ``jax.random``'s; tests carry the reference's weights with
    :func:`params_from_numpy` instead."""
    device = resolve(device, "init_params")

    def norm(shape, fan_in):
        x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        return (x * fan_in**-0.5).to(DTYPE).to(device)

    def norm_by_layer(shape, fan_in):
        out = torch.empty(shape, dtype=DTYPE, device=device)
        for i in range(shape[0]):
            out[i] = norm(shape[1:], fan_in)
        return out

    d, l = cfg.d_model, cfg.n_layers
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv * cfg.d_head
    embed = norm((cfg.vocab, d), d)
    layer = {
        "attn_norm": torch.ones((l, d), dtype=torch.float32, device=device),
        "wq": norm((l, d, hq), d),
        "wk": norm((l, d, hkv), d),
        "wv": norm((l, d, hkv), d),
        "wo": norm((l, hq, d), hq),
        "ffn_norm": torch.ones((l, d), dtype=torch.float32, device=device),
    }
    if cfg.qkv_bias:
        layer["bq"] = torch.zeros((l, hq), dtype=DTYPE, device=device)
        layer["bk"] = torch.zeros((l, hkv), dtype=DTYPE, device=device)
        layer["bv"] = torch.zeros((l, hkv), dtype=DTYPE, device=device)
    if cfg.is_moe:
        e, fe = cfg.n_experts, cfg.d_expert
        layer["router"] = torch.zeros((l, d, e), dtype=torch.float32, device=device)
        layer["e_gate"] = norm_by_layer((l, e, d, fe), d)
        layer["e_in"] = norm_by_layer((l, e, d, fe), d)
        layer["e_out"] = norm_by_layer((l, e, fe, d), fe)
        if cfg.n_shared:
            fs = fe * cfg.n_shared
            layer["s_gate"] = norm((l, d, fs), d)
            layer["s_in"] = norm((l, d, fs), d)
            layer["s_out"] = norm((l, fs, d), fs)
    else:
        layer["w_gate"] = norm((l, d, cfg.d_ff), d)
        layer["w_in"] = norm((l, d, cfg.d_ff), d)
        layer["w_out"] = norm((l, cfg.d_ff, d), cfg.d_ff)
    return {
        "embed": embed,
        "final_norm": torch.ones((d,), dtype=torch.float32, device=device),
        "layers": layer,
    }


def param_shapes(cfg: LMConfig) -> dict:
    """The global :class:`~repro_torch.launch.sharding.ShapeDtype` of each
    parameter of :func:`init_params`, without the data."""
    f32 = torch.float32
    d, l = cfg.d_model, cfg.n_layers
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv * cfg.d_head
    layer = {
        "attn_norm": ((l, d), f32), "wq": ((l, d, hq), DTYPE),
        "wk": ((l, d, hkv), DTYPE), "wv": ((l, d, hkv), DTYPE),
        "wo": ((l, hq, d), DTYPE), "ffn_norm": ((l, d), f32),
    }
    if cfg.qkv_bias:
        layer.update(bq=((l, hq), DTYPE), bk=((l, hkv), DTYPE), bv=((l, hkv), DTYPE))
    if cfg.is_moe:
        e, fe = cfg.n_experts, cfg.d_expert
        layer.update(router=((l, d, e), f32), e_gate=((l, e, d, fe), DTYPE),
                     e_in=((l, e, d, fe), DTYPE), e_out=((l, e, fe, d), DTYPE))
        if cfg.n_shared:
            fs = fe * cfg.n_shared
            layer.update(s_gate=((l, d, fs), DTYPE), s_in=((l, d, fs), DTYPE),
                         s_out=((l, fs, d), DTYPE))
    else:
        layer.update(w_gate=((l, d, cfg.d_ff), DTYPE), w_in=((l, d, cfg.d_ff), DTYPE),
                     w_out=((l, cfg.d_ff, d), DTYPE))
    return {"embed": ShapeDtype((cfg.vocab, d), DTYPE),
            "final_norm": ShapeDtype((d,), f32),
            "layers": {k: ShapeDtype(*v) for k, v in layer.items()}}


def param_shardings(cfg: LMConfig, mesh, dp=("pod", "data"), tp="model") -> dict:
    """:class:`~repro_torch.launch.sharding.NamedSharding` tree matching
    ``init_params``, the reference's: heads, FFN, experts and vocab over
    ``tp``; norms and the router replicated.  With ``cfg.fsdp`` the
    tensors are also split over the data axes on a free dimension (the
    ZeRO-1 choice)."""
    dp = tuple(a for a in dp if a in mesh.axis_names)

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    layer = {
        "attn_norm": ns(None, None),
        "wq": ns(None, None, tp),
        "wk": ns(None, None, tp),
        "wv": ns(None, None, tp),
        "wo": ns(None, tp, None),
        "ffn_norm": ns(None, None),
    }
    if cfg.qkv_bias:
        layer["bq"] = ns(None, tp)
        layer["bk"] = ns(None, tp)
        layer["bv"] = ns(None, tp)
    if cfg.is_moe:
        layer["router"] = ns(None, None, None)
        layer["e_gate"] = ns(None, tp, None, None)
        layer["e_in"] = ns(None, tp, None, None)
        layer["e_out"] = ns(None, tp, None, None)
        if cfg.n_shared:
            layer["s_gate"] = ns(None, None, tp)
            layer["s_in"] = ns(None, None, tp)
            layer["s_out"] = ns(None, tp, None)
    else:
        layer["w_gate"] = ns(None, None, tp)
        layer["w_in"] = ns(None, None, tp)
        layer["w_out"] = ns(None, tp, None)
    out = {
        "embed": ns(tp, None),  # vocab-parallel
        "final_norm": ns(None),
        "layers": layer,
    }
    if cfg.fsdp and dp:
        from repro_torch.optim.adamw import _zero1_sharding  # the same free-dim logic

        out = pytree.tree_map(lambda sh, shp: _zero1_sharding(sh, shp.shape, mesh, dp),
                              out, param_shapes(cfg))
    return out


def params_from_numpy(tree, device: str | torch.device):
    """The reference's parameter pytree, as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's tensors on
    ``device``.  bf16 arrays (numpy dtype ``bfloat16`` from ml_dtypes) pass
    through their 16-bit pattern.  Dicts, lists and tuples keep their
    structure (the GNNs' MLPs are lists of ``(w, b)`` tuples).  ``device``
    has no default."""
    device = resolve(device, "params_from_numpy")
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    arr = np.array(tree)  # a writable copy; torch.from_numpy needs one
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer tensors (views)."""
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _write_cache(cache: torch.Tensor, new: torch.Tensor, q_offset) -> None:
    """Write ``new`` (B, s, KV, Dh) into ``cache`` (B, T, KV, Dh) at
    position ``q_offset`` (scalar, or (B,) per slot), in place.  Like
    ``jax.lax.dynamic_update_slice``, the start is clamped to [0, T - s] so
    that the update fits."""
    b, s = new.shape[:2]
    t = cache.shape[1]
    new = new.to(cache.dtype)
    if isinstance(q_offset, torch.Tensor) and q_offset.dim() >= 1:
        start = q_offset.reshape(b).to(device=cache.device, dtype=torch.int64)
        rows = start.clamp(0, t - s)[:, None] + torch.arange(s, device=cache.device)
        cache[torch.arange(b, device=cache.device)[:, None], rows] = new
    else:
        start = min(max(int(q_offset), 0), t - s)
        cache[:, start:start + s] = new


def _qkv(cfg: LMConfig, h, lp) -> tuple:
    """q, k and v of the normed input ``h`` (this rank's columns under a
    mesh), with the QKV bias where the config has one."""
    q = h @ lp["wq"].to(h.dtype)
    k = h @ lp["wk"].to(h.dtype)
    v = h @ lp["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(h.dtype)
        k = k + lp["bk"].to(h.dtype)
        v = v + lp["bv"].to(h.dtype)
    return q, k, v


def _layer(cfg: LMConfig, x, lp, cos, sin, q_offset, k_cache=None, v_cache=None):
    """One decoder block.  If k_cache/v_cache (B,T,KV,Dh) are given, the new
    K/V are written into them at ``q_offset`` first (in place) and
    attention runs over the whole (masked) cache; returns (x', aux,
    (k_out, v_out)) where k_out is the updated cache (or the fresh K/V when
    no cache)."""
    b, s, d = x.shape
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = _qkv(cfg, h, lp)
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, s, cfg.n_kv, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv, cfg.d_head)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if k_cache is not None:
        _write_cache(k_cache, k, q_offset)
        _write_cache(v_cache, v, q_offset)
        k, v = k_cache.to(k.dtype), v_cache.to(v.dtype)
        k_new, v_new = k_cache, v_cache
    else:
        k_new, v_new = k, v
    attn = gqa_attention(
        q, k, v, causal=True, q_offset=q_offset, chunk=cfg.attn_chunk,
        impl=cfg.attn_impl,
    )
    x = x + attn.reshape(b, s, -1) @ lp["wo"].to(x.dtype)

    h = rms_norm(x, lp["ffn_norm"])
    if cfg.is_moe:
        out, aux = moe_ffn(
            h, lp["router"], lp["e_gate"], lp["e_in"], lp["e_out"],
            cfg.top_k, cfg.capacity_factor,
            n_token_shards=cfg.n_token_shards,
            dp_axes=cfg.dp_axes, ep_axis=cfg.ep_axis,
        )
        if cfg.n_shared:
            out = out + swiglu(h, lp["s_gate"], lp["s_in"], lp["s_out"])
    else:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        out = swiglu(h, lp["w_gate"], lp["w_in"], lp["w_out"])
    return x + out, aux, (k_new, v_new)


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"].to(DTYPE)[tokens.to(torch.int64)]


def forward(params, cfg: LMConfig, tokens: torch.Tensor, mesh=None):
    """tokens (B, S) -> hidden (B, S, D), aux loss sum.

    With ``cfg.remat`` and grad mode on, each group of ``cfg.remat_group``
    layers (one layer when the group does not divide the depth, as in the
    reference) runs under ``torch.utils.checkpoint``: the backward
    recomputes the group, with the MoE calls routed as in the forward.
    With ``mesh``, ``params`` are this rank's blocks of
    :func:`param_shardings` and ``tokens`` its rows."""
    tp = None if mesh is None else _TP(cfg, mesh)
    s = tokens.shape[1]
    x = _embed(params, tokens) if tp is None else tp.embed(params, tokens)
    cos, sin = rope_angles(torch.arange(s, device=x.device), cfg.d_head, cfg.rope_theta)
    g = cfg.remat_group if cfg.remat_group > 1 and cfg.n_layers % cfg.remat_group == 0 else 1

    def group(x, first):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(first, first + g):
            if tp is None:
                x, a, _ = _layer(cfg, x, layer_params(params, i), cos, sin, q_offset=0)
            else:
                x, a = tp.layer(x, tp.layer_params(params, i), cos, sin)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for first in range(0, cfg.n_layers, g):
        if cfg.remat and torch.is_grad_enabled():
            x, a = torch.utils.checkpoint.checkpoint(
                group, x, first, use_reentrant=False, context_fn=remat_contexts)
        else:
            x, a = group(x, first)
        aux = aux + a
    final_norm = params["final_norm"] if tp is None else tp.whole(params, "final_norm")
    return rms_norm(x, final_norm), aux


def logits_of(params, hidden):
    return hidden @ params["embed"].to(hidden.dtype).T


def loss_fn(params, cfg: LMConfig, tokens: torch.Tensor, labels: torch.Tensor,
            mesh=None):
    """Mean next-token cross entropy of ``labels`` (B, S) plus 0.01 times
    the MoE load-balancing loss: the reference's log-sum-exp, shifted by
    the row maximum (held constant in the backward), in f32.  With
    ``mesh``, over this rank's blocks and rows (vocab-parallel; the mean
    over every data rank's rows)."""
    hidden, aux = forward(params, cfg, tokens, mesh)
    if mesh is None:
        logits, lo = logits_of(params, hidden).float(), 0
    else:
        tp = _TP(cfg, mesh)
        embed = tp.whole(params, "embed")
        logits = (coll.grad_all_reduce(hidden, mesh, tp.tp) @ embed.to(hidden.dtype).T).float()
        lo = tp.m * embed.shape[0]
    m = logits.max(dim=-1, keepdim=True).values.detach()
    if mesh is not None:
        m = coll.all_reduce_raw(m, mesh, tp.tp, "max") if tp.tp else m
    sum_exp = torch.exp(logits - m).sum(dim=-1)
    vocab = torch.arange(lo, lo + logits.shape[-1], device=logits.device)
    onehot = labels.to(logits.device)[..., None] == vocab
    label_logit = torch.where(onehot, logits, 0.0).sum(dim=-1)
    if mesh is not None:
        sum_exp = coll.all_reduce(sum_exp, mesh, tp.tp)
        label_logit = coll.all_reduce(label_logit, mesh, tp.tp)
    ce = (torch.log(sum_exp) + m[..., 0] - label_logit).mean()
    if mesh is not None and tp.d_ranks > 1:  # the mean of the data ranks' means
        ce = coll.all_reduce(ce * (1.0 / tp.d_ranks), mesh, tp.dp)
    return ce + 0.01 * aux


class _TP:
    """One rank's view of the layout of :func:`param_shardings` on a mesh:
    the model axis ``tp`` (None without one) and this rank's index ``m``
    along it of ``n_tp``, the data axes ``dp`` and their ranks."""

    def __init__(self, cfg: LMConfig, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.tp = "model" if "model" in mesh.axis_names else None
        self.dp = data_axes(mesh)
        self.n_tp = mesh.shape[self.tp] if self.tp else 1
        self.m = mesh.coords[self.tp] if self.tp else 0
        self.d_ranks = 1
        for a in self.dp:
            self.d_ranks *= mesh.shape[a]
        self.shardings = param_shardings(cfg, mesh, dp=self.dp)
        self.whole_heads = cfg.n_heads % self.n_tp == 0 and cfg.n_kv % self.n_tp == 0

    # -- FSDP: the data-axis split undone inside the step ----------------------
    def _unsplit(self, t: torch.Tensor, ents: tuple) -> torch.Tensor:
        for dim, e in enumerate(ents):
            dpa = tuple(a for a in (e or ()) if a in self.dp)
            if dpa:
                t = coll.all_gather_dim(t, self.mesh, dpa, dim)
        return t

    def whole(self, params, name: str) -> torch.Tensor:
        """A top-level parameter with its data-axis split gathered."""
        t = params[name]
        return self._unsplit(t, self.shardings[name].entries(t.dim()))

    def layer_params(self, params, i: int) -> dict:
        """Layer ``i``'s blocks along ``model``, gathered over the data axes
        where FSDP split them; a stack split along its layers is summed
        from its owner (the gradient back to it)."""
        out = {}
        for k, stack in params["layers"].items():
            ents = self.shardings["layers"][k].entries(stack.dim())
            lead = tuple(a for a in (ents[0] or ()) if a in self.dp)
            if lead:
                per = stack.shape[0]
                # the owner's slice, zeros elsewhere; every rank's piece stays
                # in the graph, so every rank joins the backward's sum
                mine = float(self.mesh.axis(lead).index == i // per)
                piece = coll.grad_all_reduce(
                    coll.all_reduce(stack[i % per] * mine, self.mesh, lead), self.mesh, lead)
            else:
                piece = stack[i]
            out[k] = self._unsplit(piece, ents[1:])
        return out

    # -- the vocab-parallel embedding ---------------------------------------------
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        table = self.whole(params, "embed").to(DTYPE)
        if self.n_tp == 1:
            return table[tokens.to(torch.int64)]
        v = table.shape[0]
        ids = tokens.to(torch.int64) - self.m * v
        mine = (ids >= 0) & (ids < v)
        rows = torch.where(mine[..., None], table[ids.clamp(0, v - 1)], 0.0)
        return coll.all_reduce(rows, self.mesh, self.tp)

    # -- the tensor-parallel decoder block ----------------------------------------
    def _swiglu(self, h, w_gate, w_in, w_out):
        out = swiglu(coll.grad_all_reduce(h, self.mesh, self.tp), w_gate, w_in, w_out)
        return coll.all_reduce(out, self.mesh, self.tp)

    def layer(self, x, lp, cos, sin, kv: bool = False):
        """One decoder block on this rank's blocks; with ``kv`` also the
        layer's K/V (B, S, KV heads, Dh): this rank's heads where ``model``
        divides the head counts, else every head."""
        cfg, mesh, tp = self.cfg, self.mesh, self.tp
        b, s, _ = x.shape
        h = rms_norm(x, lp["attn_norm"])
        hp = coll.grad_all_reduce(h, mesh, tp)  # into the column-parallel q, k, v
        q, k, v = _qkv(cfg, hp, lp)
        if self.whole_heads:
            n_q, n_kv = cfg.n_heads // self.n_tp, cfg.n_kv // self.n_tp
        else:  # a head split across ranks: every rank attends over all heads
            q, k, v = (coll.all_gather_dim(t, mesh, tp, 2) for t in (q, k, v))
            n_q, n_kv = cfg.n_heads, cfg.n_kv
        q = apply_rope(q.reshape(b, s, n_q, cfg.d_head), cos, sin)
        k = apply_rope(k.reshape(b, s, n_kv, cfg.d_head), cos, sin)
        v = v.reshape(b, s, n_kv, cfg.d_head)
        attn = gqa_attention(q, k, v, causal=True, q_offset=0, chunk=cfg.attn_chunk,
                             impl=cfg.attn_impl).reshape(b, s, -1)
        if not self.whole_heads:
            cols = lp["wo"].shape[0]
            attn = attn[..., self.m * cols:(self.m + 1) * cols]
        x = x + coll.all_reduce(attn @ lp["wo"].to(x.dtype), mesh, tp)
        x, aux = self._ffn(x, lp)
        return (x, aux, (k, v)) if kv else (x, aux)

    def _ffn(self, x, lp):
        """The FFN half of a block (dense or MoE), its residual added."""
        cfg, mesh, tp = self.cfg, self.mesh, self.tp
        h = rms_norm(x, lp["ffn_norm"])
        if cfg.is_moe:
            out, aux = moe_ffn(
                h, lp["router"], lp["e_gate"], lp["e_in"], lp["e_out"],
                cfg.top_k, cfg.capacity_factor, n_token_shards=cfg.n_token_shards,
                dp_axes=cfg.dp_axes, ep_axis=tp, mesh=mesh)
            if cfg.n_shared:
                out = out + self._swiglu(h, lp["s_gate"], lp["s_in"], lp["s_out"])
        else:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            out = self._swiglu(h, lp["w_gate"], lp["w_in"], lp["w_out"])
        return x + out, aux

    # -- serving: the KV cache split by sequence over ``model`` --------------------
    def seq_block(self, kv: torch.Tensor) -> torch.Tensor:
        """(2, B, S, heads, Dh) K/V of :meth:`layer` -> this rank's sequence
        block of every KV head (2, B, S / model, KV, Dh): an all-to-all over
        ``model`` turns head columns into sequence blocks; where the heads
        were gathered, the block is cut out."""
        sb = kv.shape[2] // self.n_tp
        if self.whole_heads:
            return coll.all_to_all_raw(kv, self.mesh, self.tp, split_dim=2, concat_dim=3)
        return kv[:, :, self.m * sb:(self.m + 1) * sb].contiguous()

    def decode_layer(self, x, lp, cos, sin, pos: int, k_cache, v_cache):
        """One decoder block for one new token a row against this rank's
        sequence block of the cache (B, T / model, KV, Dh), which starts at
        position ``m * T / model``.  Every rank takes every head's q, k and v
        (gathered over ``model``), the rank whose block holds ``pos`` writes
        the new K/V, each attends over its block, and the partial softmax
        states merge over ``model`` (their max, then the rescaled sums)
        before this rank's columns of ``wo``."""
        cfg, mesh, tp = self.cfg, self.mesh, self.tp
        b = x.shape[0]
        h = rms_norm(x, lp["attn_norm"])
        q, k, v = (coll.all_gather_raw(t, mesh, tp, 2) if tp else t
                   for t in _qkv(cfg, h, lp))
        q = apply_rope(q.reshape(b, 1, cfg.n_heads, cfg.d_head), cos, sin)
        k = apply_rope(k.reshape(b, 1, cfg.n_kv, cfg.d_head), cos, sin)
        v = v.reshape(b, 1, cfg.n_kv, cfg.d_head)
        sb = k_cache.shape[1]
        lo = self.m * sb
        if lo <= pos < lo + sb:
            _write_cache(k_cache, k, pos - lo)
            _write_cache(v_cache, v, pos - lo)
        kc, vc = k_cache.to(k.dtype), v_cache.to(v.dtype)
        if cfg.attn_impl == "flash":
            if self.n_tp > 1:
                raise NotImplementedError(
                    "a decode step over a cache split by sequence merges softmax "
                    "states; the flash kernel returns no log-sum-exp (ROADMAP)")
            attn = gqa_attention(q, kc, vc, causal=True, q_offset=pos, chunk=cfg.attn_chunk,
                                 impl="flash")
        else:
            m, l, acc = attention_state(q, kc, vc, causal=True, q_offset=pos,
                                        chunk=cfg.attn_chunk, k_offset=lo)
            if self.n_tp > 1:
                top = coll.all_reduce_raw(m, mesh, tp, "max")
                scale = torch.exp(m - top)
                l = coll.all_reduce_raw(l * scale, mesh, tp)
                acc = coll.all_reduce_raw(acc * scale.permute(0, 3, 1, 2)[..., None], mesh, tp)
            attn = attention_out(l, acc, q.dtype)
        attn = attn.reshape(b, 1, -1)
        cols = lp["wo"].shape[0]
        attn = attn[..., self.m * cols:(self.m + 1) * cols]
        x = x + coll.all_reduce(attn @ lp["wo"].to(x.dtype), mesh, tp)
        return self._ffn(x, lp)[0]

    def logits(self, params, hidden):
        """Vocab-parallel logits: this rank's vocab columns."""
        return hidden @ self.whole(params, "embed").to(hidden.dtype).T


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    device = resolve(device, "init_cache")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=DTYPE, device=device),
            "v": torch.zeros(shape, dtype=DTYPE, device=device)}


def prefill(params, cfg: LMConfig, tokens: torch.Tensor, mesh=None):
    """Full forward that also returns the per-layer KV cache (L,B,S,..);
    runs where ``params`` and ``tokens`` lie.

    With ``mesh`` (the serving cell), ``params`` are this rank's blocks of
    :func:`param_shardings` and ``tokens`` its rows of the data axes; the
    logits of the last position come out vocab-parallel (this rank's
    columns) and the cache as this rank's sequence block over ``model`` of
    every KV head (L, B, S / model, KV, Dh): the reference's output
    shardings."""
    if mesh is not None:
        return _prefill_sharded(params, cfg, tokens, mesh)
    b, s = tokens.shape
    x = _embed(params, tokens)
    cos, sin = rope_angles(torch.arange(s, device=x.device), cfg.d_head, cfg.rope_theta)
    shape = (cfg.n_layers, b, s, cfg.n_kv, cfg.d_head)
    cache = {"k": torch.empty(shape, dtype=DTYPE, device=x.device),
             "v": torch.empty(shape, dtype=DTYPE, device=x.device)}
    for i in range(cfg.n_layers):
        x, _, (k, v) = _layer(cfg, x, layer_params(params, i), cos, sin, q_offset=0)
        cache["k"][i] = k
        cache["v"][i] = v
    hidden = rms_norm(x, params["final_norm"])
    return logits_of(params, hidden[:, -1:, :]), cache


def _prefill_sharded(params, cfg: LMConfig, tokens: torch.Tensor, mesh):
    tp = _TP(cfg, mesh)
    b, s = tokens.shape
    if s % tp.n_tp:
        raise ValueError(f"{s} positions do not split over {tp.n_tp} model ranks")
    x = tp.embed(params, tokens)
    cos, sin = rope_angles(torch.arange(s, device=x.device), cfg.d_head, cfg.rope_theta)
    shape = (cfg.n_layers, b, s // tp.n_tp, cfg.n_kv, cfg.d_head)
    cache = {"k": torch.empty(shape, dtype=DTYPE, device=x.device),
             "v": torch.empty(shape, dtype=DTYPE, device=x.device)}
    for i in range(cfg.n_layers):
        x, _, (k, v) = tp.layer(x, tp.layer_params(params, i), cos, sin, kv=True)
        kv = tp.seq_block(torch.stack([k, v]))
        cache["k"][i] = kv[0]
        cache["v"][i] = kv[1]
    hidden = rms_norm(x, tp.whole(params, "final_norm"))
    return tp.logits(params, hidden[:, -1:, :]), cache


def decode_step(params, cfg: LMConfig, cache: dict, token: torch.Tensor, pos,
                mesh=None):
    """One decode step: token (B,), pos a scalar int (current length).

    The cache has static length T; entries at >= pos are masked by
    causality (q_offset = pos).  Writes the new K/V into ``cache`` in place;
    returns (logits (B,V), cache).

    With ``mesh`` (the serving cell), ``params`` are this rank's blocks,
    ``token`` its rows of the data axes and ``cache`` its sequence block over
    ``model`` (:func:`prefill`'s layout); the logits come out
    vocab-parallel.  ``pos`` is a host int on every rank.
    """
    pos = int(pos)
    if mesh is not None:
        tp = _TP(cfg, mesh)
        x = tp.embed(params, token)[:, None, :]
        cos, sin = rope_angles(torch.tensor([pos], device=x.device), cfg.d_head,
                               cfg.rope_theta)
        for i in range(cfg.n_layers):
            x = tp.decode_layer(x, tp.layer_params(params, i), cos, sin, pos,
                                cache["k"][i], cache["v"][i])
        hidden = rms_norm(x, tp.whole(params, "final_norm"))
        return tp.logits(params, hidden)[:, 0, :], cache
    x = _embed(params, token)[:, None, :]  # (B,1,D)
    cos, sin = rope_angles(torch.tensor([pos], device=x.device), cfg.d_head,
                           cfg.rope_theta)
    for i in range(cfg.n_layers):
        x, _, _ = _layer(cfg, x, layer_params(params, i), cos, sin, q_offset=pos,
                         k_cache=cache["k"][i], v_cache=cache["v"][i])
    hidden = rms_norm(x, params["final_norm"])
    return logits_of(params, hidden)[:, 0, :], cache
