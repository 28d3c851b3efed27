"""The port's REW slice against the reference's ``JaxEngine`` on reduced
generator profiles: the same triple set, rho and six counters, exactly.

The reference runs with ``fuse_rounds=False`` (the host round loop the port
mirrors) and ``use_kernel=False``: its argsort gives the same stable order
as its Pallas dedup kernel, which is too slow in interpret mode at these
widths.  The port's plain versions run here; ``chip_smoke.py`` runs its
kernels on the card.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core.engine_jax import JaxEngine  # noqa: E402
from repro.core.triples import pack  # noqa: E402
from repro.data.generator import generate as jgenerate  # noqa: E402
from repro_torch.core.engine import TorchEngine, index_invariant_report  # noqa: E402
from repro_torch.data.generator import PROFILES, generate  # noqa: E402

COUNTERS = ("derivations", "rule_applications", "merged_resources",
            "reflexive_added", "rounds", "triples_total")


def _reduced(name):
    kw = dict(PROFILES[name])
    kw["n_groups"] = min(kw["n_groups"], 40)
    kw["n_plain"] = min(kw["n_plain"], 800)
    if name == "uobm_like":  # the reference alone takes ~40 s at its default
        kw.update(hometown_groups=2, hometown_size=8)
    return kw


@pytest.mark.parametrize("name", ["claros_like", "dbpedia_like", "opencyc_like",
                                  "merge_like", "uobm_like"])
def test_slice_matches_reference(name):
    kw = _reduced(name)
    facts, program, dic = generate(**kw)
    jfacts, jprogram, jdic = jgenerate(**kw)
    np.testing.assert_array_equal(facts, jfacts)
    assert dic.n_resources == jdic.n_resources

    spo, rep, stats = JaxEngine(jdic.n_resources, fuse_rounds=False).materialise(
        jfacts, jprogram
    )
    eng = TorchEngine(dic.n_resources, device="cpu", fuse_rounds=False)
    state = eng.materialise_state(facts, program)
    pspo, prep = eng.state_triples(state), eng.state_rep(state)

    assert set(pack(pspo).tolist()) == set(pack(spo).tolist())
    np.testing.assert_array_equal(prep[prep], prep)  # state_rep is compressed
    np.testing.assert_array_equal(prep, rep)
    for k in COUNTERS:
        assert getattr(state.stats, k) == getattr(stats, k), k
    assert state.stats.triples_explicit == stats.triples_explicit
    assert index_invariant_report(state) == []
