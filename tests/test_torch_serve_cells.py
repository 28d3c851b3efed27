"""The serving and engine cells against the reference's, on the CPU.

The port runs ``repro_torch.launch.workloads.build_cell(...).step`` in 4
gloo processes (a (data 2, model 2) mesh and a (1, 1) mesh of the first
rank); the reference runs ``repro.launch.workloads.build_cell(...).step``
jitted with its shardings on 4 fake CPU devices in one subprocess beside
them (``tests/serve_dist_cases.py``).  Both start from the same seeded
weights and inputs.

* LM prefill, then three decode steps across the boundary of the two
  model ranks' cache blocks, for a head split across ranks
  (``smollm-reduced``, 3 heads over model 2: the q/k/v columns gathered),
  whole heads (``qwen2-reduced``: the cache's head columns exchanged into
  sequence blocks by an all-to-all) and an MoE (``deepseek-moe-reduced``):
  the logits of every step and the gathered cache equal the reference's
  sharded cells within ``K_TOL`` times the gap between the reference's
  own sharded and unsharded runs, plus a floor at bf16 rounding (one unit
  in the last place at the largest value), and the port's unsharded
  functions within ``K_TOL`` times the larger of that gap and the gap
  between the two packages' unsharded runs, plus the same floor; the gaps
  are printed.
* FM serve and retrieval (1,000 candidates, padded to 1,024): the same
  rule, with a floor at f32 rounding.
* One engine round at the reduced caps: every output and flag equal to
  the reference's shard by shard (device r against rank r), no overflow.
* At a (1, 1) mesh every cell equals the port's unsharded functions bit
  for bit.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package imports them by their old names
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from serve_dist_cases import (DECODE_POS, ENGINE_OUT, LM_ARCHS, run_port,  # noqa: E402
                              start_reference)
from train_dist_cases import load, wait_reference  # noqa: E402

K_TOL = 8.0
FLOOR_BF16, FLOOR_F32 = 2.0**-8, 1e-6  # relative to the largest value
LM_OUTS = ["pre"] + [f"dec{i}" for i in range(len(DECODE_POS))] + ["k", "v"]


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_cells")
    proc = start_reference(root / "ref")
    try:
        run_port(root / "port")
    except BaseException:
        proc.kill()
        raise
    wait_reference(proc)
    return root


def _gap(a, b) -> float:
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _hold(label, q, rs, ru, ps, pu, floor):
    """The port's sharded run ``ps`` against the reference's sharded ``rs``
    and the port's unsharded ``pu``, within K_TOL times the reference's own
    gap (and the packages' unsharded gap) plus ``floor``."""
    g = dict(rs_ru=_gap(rs, ru), pu_ru=_gap(pu, ru), ps_rs=_gap(ps, rs), ps_pu=_gap(ps, pu))
    tol_ref = K_TOL * g["rs_ru"] + floor
    tol_un = K_TOL * max(g["rs_ru"], g["pu_ru"]) + floor
    print(f"{label} {q}: reference sharded vs unsharded {g['rs_ru']:.3g}, port vs reference "
          f"unsharded {g['pu_ru']:.3g}; port sharded vs reference sharded {g['ps_rs']:.3g} "
          f"(limit {tol_ref:.3g}), vs port unsharded {g['ps_pu']:.3g} (limit {tol_un:.3g})")
    assert g["ps_rs"] <= tol_ref, (label, q, g)
    assert g["ps_pu"] <= tol_un, (label, q, g)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode_match_reference(out, arch):
    ref = load(out / "ref" / f"lm-{arch}.npz")
    ps = load(out / "port" / f"lm-{arch}-d2m2.npz")
    pu = load(out / "port" / f"lm-{arch}-d2m2-un.npz")
    for q in LM_OUTS:
        assert ps[q].shape == ref[q].shape, (q, ps[q].shape, ref[q].shape)
        _hold(arch, q, ref[q], ref[f"u_{q}"], ps[q], pu[q], FLOOR_BF16)


@pytest.mark.parametrize("kind", ["serve", "retrieval"])
def test_fm_serving_matches_reference(out, kind):
    ref = load(out / "ref" / "fm.npz")
    ps = load(out / "port" / "fm-d2m2.npz")[kind]
    pu = load(out / "port" / "fm-d2m2-un.npz")[kind]
    assert ps.shape == ref[kind].shape == ((64,) if kind == "serve" else (1024,))
    _hold("fm", kind, ref[kind], ref[f"u_{kind}"], ps, pu, FLOOR_F32)


@pytest.mark.parametrize("rank", range(4))
def test_engine_round_equals_reference_shard_by_shard(out, rank):
    ref = load(out / "ref" / "engine.npz")
    got = load(out / "port" / f"engine-d2m2.r{rank}.npz")
    names = set(ENGINE_OUT) | {k.split(":")[0] for k in ref}
    assert names == set(got), sorted(names ^ set(got))
    for name in sorted(names):
        want = ref[f"{name}:{rank}"]
        assert got[name].shape == want.shape, (name, got[name].shape, want.shape)
        assert np.array_equal(got[name], want), name
    assert not any(got[k].any() for k in ("ov_rewrite", "ov_store", "ov_route", "ov_pair"))
    assert got["n_new"][0] > 0 and got["rep_changed"]


@pytest.mark.parametrize("cell", [f"lm-{a}" for a in LM_ARCHS] + ["fm", "engine"])
def test_one_rank_is_bit_equal_to_unsharded(out, cell):
    if cell == "engine":
        got = load(out / "port" / "engine-d1m1.r0.npz")
    else:
        got = load(out / "port" / f"{cell}-d1m1.npz")
    want = load(out / "port" / f"{cell}-d1m1-un.npz")
    assert got.keys() == want.keys()
    for k in got:  # the cell lays a rank's scalar flags out as one row
        assert np.array_equal(got[k].reshape(want[k].shape), want[k]), (cell, k)
