"""The port's REW engine against the reference's ``JaxEngine`` on seeded
random programs — the shape of ``tests/test_engine_jax.py``'s hypothesis
test: up to 6 facts and 2 rules of 1-2 atoms over 6 constants, 2
variables and sameAs.  They reach what the generator profiles do not:
cartesian joins, intra-atom equalities, constant heads, prefix-index joins
and rule rewriting by rho.  Exact comparison of the triple set, rho and the
six counters, or the same contradiction."""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core import rules as jrules  # noqa: E402
from repro.core.engine_jax import JaxEngine  # noqa: E402
from repro.core.materialise import Contradiction as RefContradiction  # noqa: E402
from repro.core.triples import pack  # noqa: E402
from repro_torch.core import rules  # noqa: E402
from repro_torch.core.engine import Contradiction, TorchEngine  # noqa: E402
from repro_torch.core.terms import DIFFERENT_FROM, SAME_AS  # noqa: E402

N_RES = 9
CONSTS = list(range(3, N_RES))
PREDS = CONSTS + [SAME_AS]
VARS = [-1, -2]
COUNTERS = ("derivations", "rule_applications", "merged_resources",
            "reflexive_added", "rounds", "triples_total")


def _program(rng):
    out = []
    for _ in range(rng.integers(0, 3)):
        body = [
            (int(rng.choice(CONSTS + VARS)), int(rng.choice(PREDS)),
             int(rng.choice(CONSTS + VARS)))
            for _ in range(rng.integers(1, 3))
        ]
        body_vars = [t for a in body for t in a if t < 0]
        so = CONSTS + body_vars if body_vars else CONSTS
        head = (int(rng.choice(so)), int(rng.choice(PREDS + [DIFFERENT_FROM])),
                int(rng.choice(so)))
        out.append((head, tuple(body)))
    return out


@pytest.mark.parametrize("seed", range(16))
def test_random_program_matches_reference(seed):
    rng = np.random.default_rng(seed)
    facts = np.asarray([
        (rng.choice(CONSTS), rng.choice(PREDS), rng.choice(CONSTS))
        for _ in range(rng.integers(1, 7))
    ], np.int32)
    spec = _program(rng)
    ref_program = jrules.Program([jrules.Rule(h, b) for h, b in spec])
    program = rules.Program([rules.Rule(h, b) for h, b in spec])

    ref_eng = JaxEngine(N_RES, capacity=512, bind_cap=512, out_cap=512,
                        rewrite_cap=512, fuse_rounds=False)
    eng = TorchEngine(N_RES, capacity=512, bind_cap=512, out_cap=512,
                      rewrite_cap=512, device="cpu", fuse_rounds=False)
    try:
        spo, rep, stats = ref_eng.materialise(facts, ref_program)
    except RefContradiction:
        with pytest.raises(Contradiction):
            eng.materialise(facts, program)
        return
    pspo, prep, pstats = eng.materialise(facts, program)
    assert set(pack(pspo).tolist()) == set(pack(spo).tolist())
    np.testing.assert_array_equal(prep, rep)
    for k in COUNTERS:
        assert getattr(pstats, k) == getattr(stats, k), k
