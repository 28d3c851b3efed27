"""Incremental add and delete of the port against ``JaxEngine``, event by
event, on the profile shapes.

The four profile shapes of ``tests/test_fused.py``, a cut ``merge_like``
(entity-constant rules: updates re-merge onto rule constants, so the
forward side's merge-targeted plans run), a cut ``claros_like`` and two
seeded random programs with random update streams, each under the default
engine (the fused rounds and waves, targeted rederivation) and the host
loops (``fuse_rounds=False``).  After the base run and after every event
the port equals the reference exactly: the eight state arrays, the explicit
set, the rewritten program, the round counter and every ``MatStats``
counter but the wall (the retry counters net of the base run); its phase
labels are the reference's; and the state equals a from-scratch run of its
explicit set (the same rho and normal-form store).
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import pytest  # noqa: E402

from incremental_cases import (  # noqa: E402
    COMBOS, assert_from_scratch, assert_same_state, run_stream,
)

STREAMS = list(COMBOS) + ["merge_like", "claros_small", "random-0", "random-1"]


@pytest.mark.parametrize("name", STREAMS)
def test_stream_matches_reference_and_from_scratch(name):
    """The default engine (fused rounds and waves, targeted rederivation)."""
    caps = 1 << 10 if name in ("merge_like", "claros_small") else 1 << 9
    updates, stats = 0, None
    for tag, te, ts, js, base, got, want, prog in run_stream(name, caps=caps):
        if tag == "contradiction":
            break
        assert_same_state(ts, js, base, f"{name} {tag}")
        assert got == want, f"{name} {tag}: phase labels"
        assert_from_scratch(te, ts, ts.n_res, ts.base_program, f"{name} {tag}")
        updates += tag != "base"
        stats = ts.stats
    assert updates == 4
    # the streams reach the delete path's splits and rederivation, and
    # merge_like the forward side's merge-targeted plans
    assert stats.overdeleted and stats.suspects_split
    if not name.startswith("random"):
        assert stats.rederive_targeted
    if name == "merge_like":
        assert stats.remerge_targeted
