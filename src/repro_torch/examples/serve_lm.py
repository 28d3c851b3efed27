"""Serve a small LM with continuously-batched requests.

Submits a burst of prompts against a 4-slot KV arena: the engine prefills
into free slots, decodes all active slots in one step per tick, and
back-fills slots as sequences finish (:mod:`repro_torch.serve.engine`).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--requests 12] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import transformer as lm
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device=args.device)
    eng = ServeEngine(params, cfg, n_slots=args.slots, max_len=64, eos_id=-1,
                      device=args.device)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(2, 8))
        prompt = rng.integers(2, cfg.vocab, plen).tolist()
        eng.submit(Request(uid=i, prompt=prompt, max_new=args.max_new))

    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in done)
    print(f"{len(done)} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s on {eng.device})")
    for r in done[:4]:
        print(f"  req {r.uid}: prompt {r.prompt} -> {r.out}")


if __name__ == "__main__":
    main()
