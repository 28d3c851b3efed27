"""The card's LM gradients against the CPU's, for one tree of this repository.

    python tools/lm_grad_gap.py [--src TREE]

``TREE`` is a checkout of this repository (``.``, the default, or an
unpacked ``git archive`` of another commit); the script imports that
tree's ``repro_torch``.  It takes the reduced SmolLM config with 4 KV
chunks of 16 keys (``chip_smoke.py`` phase 10 (e)'s check) and, for each
of ``SEEDS`` parameter seeds, the loss and gradients of ``loss_fn`` on
phase 10 (e)'s two batches of 2 x 64 tokens, on the card and on the CPU,
once with the parameters as stored (bf16) and once cast to f32.  It prints
one JSON line: for each seed and dtype, the loss's relative gap, the
largest gradient gap over a leaf's largest CPU value, and a SHA-256 of
the card's and of the CPU's gradient bytes (equal digests on two trees:
the same gradients, bit for bit); with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys
from pathlib import Path

SEEDS = 4
CHUNK, BATCH, SEQ, BATCHES = 16, 2, 64, 2


def grads(loss_fn, params: dict, batch: dict, device: str):
    """The loss and gradient leaves of ``loss_fn`` at ``params`` on ``device``."""
    import torch
    from torch.utils import _pytree as pytree

    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().to(device).requires_grad_(True) for p in flat]
    tokens, labels = (torch.from_numpy(batch[k]).to(device) for k in ("tokens", "labels"))
    loss = loss_fn(pytree.tree_unflatten(leaves, spec), tokens, labels)
    out = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g.cpu()
                         for p, g in zip(leaves, out)]


def digest(leaves: list) -> str:
    import torch

    h = hashlib.sha256()
    for g in leaves:
        h.update(g.contiguous().view(-1).view(torch.uint8).numpy())
    return h.hexdigest()[:16]


def gaps(seed: int, f32: bool) -> dict:
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models import transformer as lm

    cfg = dataclasses.replace(get_arch("smollm-135m").reduced, attn_chunk=CHUNK)
    params = lm.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    if f32:
        params = pytree.tree_map(lambda t: t.float(), params)

    def loss_fn(p, tokens, labels):
        return lm.loss_fn(p, cfg, tokens, labels)

    loss_gap = grad_gap = 0.0
    card_all, host_all = [], []
    for b in range(BATCHES):
        batch = lm_batch(b, BATCH, SEQ, cfg.vocab)
        loss, card = grads(loss_fn, params, batch, "cuda")
        host_loss, host = grads(loss_fn, params, batch, "cpu")
        loss_gap = max(loss_gap, abs(loss - host_loss) / max(abs(host_loss), 1e-30))
        for g, h in zip(card, host):
            scale = float(h.abs().max())
            if scale > 0:
                grad_gap = max(grad_gap, float((g.float() - h.float()).abs().max()) / scale)
        card_all += card
        host_all += host
    return dict(seed=seed, dtype="float32" if f32 else "stored", loss_rel_gap=loss_gap,
                grad_gap_of_leaf_max=grad_gap, card_sha=digest(card_all),
                cpu_sha=digest(host_all))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=".")
    args = ap.parse_args()
    tree = Path(args.src).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    runs = [gaps(seed, f32) for seed in range(SEEDS) for f32 in (False, True)]
    print(json.dumps(dict(tree=str(tree), card=card, runs=runs)), flush=True)


if __name__ == "__main__":
    main()
