"""The memory and wall of an LM training step of one tree of this repository.

    python tools/lm_train_peak.py [--src TREE] [--batch 16] [--seq 4096]
        [--steps 3] [--count | --measure]

``TREE`` is a checkout of this repository (``.``, the default, for this
one, or an unpacked ``git archive`` of another commit); the script imports
that tree's ``repro_torch``, so each tree runs its own model.  It takes
SmolLM-135M's full config (every layer, the config's chunked attention, remat
on) at ``batch`` x ``seq`` tokens, one data rank's share of ``train_4k``
by default, and prints one JSON line:

* unless ``--measure``: ``dryrun_peak_bytes``, the dry run's count of one
  step of the train cell at a (1, 1) mesh (``launch.dryrun.count_step``
  on fake tensors, on the CPU: loss, gradients and the AdamW update,
  inputs included);
* unless ``--count``, on the card (the step ``build_cell`` runs at a
  (1, 1) mesh, which is the unsharded one: ``value_and_grad`` of
  ``loss_fn`` and ``adamw_update``) from seeded random weights and
  ``data.pipeline.lm_batch`` batches: ``losses``, ``step_walls_s`` (each
  ending in the loss's read), ``max_memory_allocated`` over the steps
  (the parameters and moments, allocated before, included), and each
  step's peak split at the gradient of ``forward``'s hidden: before it
  the forward and the loss head (``head_peaks``), after it the backward
  through the layers (``layers_backward_peaks``), where the KV chunks'
  blocks are recomputed; with the card's name and power limit.

To compare two commits, run both trees in one call on the same card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ARCH = "smollm-135m"


def count(arch: str, batch: int, seq: int) -> int:
    """The dry run's peak bytes of one train step at a (1, 1) mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import count_step, fake_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.workloads import build_cell

    spec = get_arch(arch)
    shape = ShapeSpec(f"train_{batch}x{seq}", "train", dict(global_batch=batch, seq_len=seq))
    with fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"))
        return int(count_step(build_cell(spec, shape, mesh), mesh)["memory"]["peak_bytes"])


def measure(arch: str, batch: int, seq: int, steps: int) -> dict:
    """``steps`` training steps on the card: losses, walls, peaks."""
    import torch

    from repro_torch.compat import pytree
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch.workloads import value_and_grad
    from repro_torch.models import transformer as lm
    from repro_torch.optim import adamw_init, adamw_update

    cfg = get_arch(arch).config
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw_init(params)
    forward = lm.forward
    head_peaks = []

    def marked_forward(*args, **kw):
        """``lm.forward`` whose hidden, when its gradient arrives, closes
        the peak of the forward and the loss head and starts the layers'
        backward's."""
        hidden, aux = forward(*args, **kw)

        def split(grad):
            head_peaks.append(int(torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()

        if hidden.requires_grad:
            hidden.register_hook(split)
        return hidden, aux

    def loss(p, tokens, labels):
        return lm.loss_fn(p, cfg, tokens, labels)

    losses, walls, layer_peaks, peaks = [], [], [], []
    for step in range(steps):
        b = lm_batch(step, batch, seq, cfg.vocab)
        tokens, labels = (torch.from_numpy(b[k]).cuda() for k in ("tokens", "labels"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lm.forward = marked_forward  # loss_fn calls it by its module name
        try:
            value, grads = value_and_grad(loss, params, tokens, labels)
        finally:
            lm.forward = forward
        torch.cuda.synchronize()
        layer_peaks.append(int(torch.cuda.max_memory_allocated()))
        with torch.no_grad():
            params, opt, _ = adamw_update(params, grads, opt)
        del grads
        losses.append(float(value))
        walls.append(time.perf_counter() - t0)
        peaks.append(max(head_peaks[-1], int(torch.cuda.max_memory_allocated())))
    return dict(losses=losses, step_walls_s=walls, max_memory_allocated=max(peaks),
                step_peaks=peaks, head_peaks=head_peaks, layers_backward_peaks=layer_peaks,
                params=sum(int(t.numel()) for t in pytree.tree_leaves(params)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=".")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3)
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--count", action="store_true", help="the dry run's count alone")
    what.add_argument("--measure", action="store_true", help="the card's run alone")
    args = ap.parse_args()
    tree = Path(args.src).resolve()
    sys.path.insert(0, str(tree / "src"))

    rec = dict(tree=str(tree), arch=ARCH, batch=args.batch, seq=args.seq)
    if not args.measure:
        rec["dryrun_peak_bytes"] = count(ARCH, args.batch, args.seq)
    if not args.count:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no card: pass --count to count on the CPU")
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        rec.update(measure(ARCH, args.batch, args.seq, args.steps))
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
