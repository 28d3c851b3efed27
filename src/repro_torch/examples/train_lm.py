"""Train an assigned-architecture LM with the fault-tolerant trainer.

Default runs the REDUCED smollm config for 300 steps (checkpointing every
50; kill it mid-run and re-invoke: it resumes from the newest checkpoint
with identical losses).  ``--arch`` selects any assigned LM config;
``--full`` uses the full (paper-exact) config, the one the dry run counts
on the production mesh.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
"""

import argparse
import os
import tempfile

import torch

from repro_torch.compat import pytree
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import lm_batch
from repro_torch.models import transformer as lm
from repro_torch.train import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    cfg = spec.config if args.full else spec.reduced
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device=args.device)
    n_params = sum(int(v.numel()) for v in pytree.tree_leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, "
          f"batch {args.batch} x seq {args.seq}, {args.steps} steps")

    def loss_fn(p, batch):
        return lm.loss_fn(p, cfg, batch["tokens"], batch["labels"])

    def batch_fn(step):
        return lm_batch(step, args.batch, args.seq, cfg.vocab)

    trainer = Trainer(
        loss_fn, params, batch_fn,
        TrainConfig(
            n_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=50,
            lr=1e-3, log_every=20,
            heartbeat_path=f"{args.ckpt_dir}/heartbeat",
        ),
    )
    if trainer.resume():
        print(f"resumed from checkpoint at step {trainer.step}")
    losses = trainer.run()
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    trainer.close()


if __name__ == "__main__":
    main()
