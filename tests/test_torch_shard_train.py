"""Sharded training against the reference's sharded train cells, rank by rank.

The port runs ``repro_torch.launch.workloads.build_cell(...).step`` in 4
gloo processes on the CPU (meshes of their first 1, 2 or 4 ranks); the
reference runs ``repro.launch.workloads.build_cell(...).step`` jitted with
its shardings under ``jax.set_mesh`` on 4 fake CPU devices, in two
subprocesses beside them (``tests/train_dist_cases.py``).  Both start from
the same seeded weights and batch.

* One step per family: dense LM with whole heads (``qwen2-reduced``, also
  with FSDP: its layer stacks split over data by layer, its embedding by
  column) and a head split across ranks (``smollm-reduced``, 3 heads over
  model 2), MoE
  with experts over model (``deepseek-moe-reduced`` at (data 2, model 2)
  and (pod 2, data 1, model 2)), GatedGCN and PNA at (data 4) and (data 2,
  model 2), DimeNet and the FM at (data 2, model 2): the loss, the global
  norm, the gathered parameters and moments equal the reference's sharded
  step within ``K_TOL`` times the gap between the reference's own sharded
  and unsharded steps (plus a floor at f32 rounding), and equal the port's
  unsharded step within ``K_TOL`` times the larger of that gap and the
  gap between the two packages' unsharded steps (the port's unsharded
  MoE step can route a near tie the other way); the gaps are printed.  The
  MoE routing equals the reference's as integers, but for tokens at a near
  tie of their K-th and (K+1)-th experts.  Each rank's blocks are the
  gathered tensors' blocks at its coordinate.
* At a (1, 1) mesh the sharded step equals the port's unsharded step bit
  for bit.
* Elastic restore: the (data 2, model 2) step's state, saved by the
  sharded checkpoint, restores at (data 1, model 2) and at one rank with
  the saved blocks, and the next step equals the unsharded next step (bit
  for bit at one rank, else within the first step's bound against the
  unsharded step); the reference's own sharded checkpoint restores
  into the port's blocks at every coordinate.
* ``Trainer(mesh=, cell=)`` on an LM at (data 1, model 2) and GatedGCN at
  (data 2, model 2), killed after 3 steps and resumed, repeats the
  uninterrupted run's losses, parameters and moments bit for bit, and the
  uninterrupted run equals the cell's own step run as often on the same
  batches bit for bit, the first step's global norm included (the
  Trainer takes the cell's update: ZeRO-1 for the LM, the plain update on
  whole gradients for the GNN).
* ``compressed_grad_exchange`` over a 2-rank pod group equals the
  reference's ``shard_map`` exchange (``tests/test_compression.py``).
"""

import numpy as np
import pytest
import torch

from train_dist_cases import (ELASTIC, ONE_RANK_CASES, STEP_CASES, TRAINER_CASES,
                              TRAINER_KILL, TRAINER_STEPS, case_batch, case_params, load, run_port,
                              spec_and_shape, start_reference, tree_part, wait_reference)
from repro_torch.ckpt import restore_checkpoint
from repro_torch.launch.mesh import Mesh, coords_of
from repro_torch.launch.sharding import local_block, place
from repro_torch.launch.workloads import build_cell

# a tolerance is K_TOL times the gap it is measured against, plus a floor at
# f32 rounding (the reference's GNN steps are bit-equal sharded and not)
K_TOL = 8.0
FLOOR_SCALAR, FLOOR_TREE = 1e-6, 1e-5
CASES = {c: (a, s, ax) for c, a, s, ax in STEP_CASES}


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_train")
    procs = [start_reference(root / "ref", part) for part in ("steps_lm", "steps_rest")]
    try:
        run_port(root / "port", ["steps", "one_rank", "elastic", "trainer", "compression"])
    except BaseException:
        for p in procs:
            p.kill()
        raise
    for p in procs:
        wait_reference(p)
    return root


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _tree_gap(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float(np.abs(a[k] - b[k]).max()) / max(float(np.abs(b[k]).max()), 1e-30)
               for k in b)


def gaps(out, case: str) -> dict:
    """For the loss, the norm, the parameters and both moments: the gap of
    the reference's sharded step to its unsharded one (rs-ru), of the
    port's unsharded to the reference's unsharded (pu-ru), and of the
    port's sharded step to the reference's sharded (ps-rs) and to its own
    unsharded (ps-pu)."""
    ref = load(out / "ref" / f"{case}.npz")
    port = load(out / "port" / f"{case}.r0.npz")
    un = load(out / "port" / f"{case}.un.npz")
    res = {}
    for q in ("loss", "gn"):
        res[q] = dict(rs_ru=_rel(ref[q], ref[f"{q}_un"]), pu_ru=_rel(un[q], ref[f"{q}_un"]),
                      ps_rs=_rel(port[q], ref[q]), ps_pu=_rel(port[q], un[q]))
    for q, uq in (("p", "pu"), ("mu", "muu"), ("nu", "nuu")):
        rs, ru = tree_part(ref, f"{q}:"), tree_part(ref, f"{uq}:")
        ps, pu = tree_part(port, f"{q}:"), tree_part(un, f"{q}:")
        res[q] = dict(rs_ru=_tree_gap(rs, ru), pu_ru=_tree_gap(pu, ru),
                      ps_rs=_tree_gap(ps, rs), ps_pu=_tree_gap(ps, pu))
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_reference_and_unsharded(out, case):
    for q, g in gaps(out, case).items():
        floor = FLOOR_SCALAR if q in ("loss", "gn") else FLOOR_TREE
        tol_ref = K_TOL * g["rs_ru"] + floor
        tol_un = K_TOL * max(g["rs_ru"], g["pu_ru"]) + floor
        print(f"{case} {q}: reference sharded vs unsharded {g['rs_ru']:.3g}, port vs "
              f"reference unsharded {g['pu_ru']:.3g}; port sharded vs reference sharded "
              f"{g['ps_rs']:.3g} (limit {tol_ref:.3g}), vs port unsharded {g['ps_pu']:.3g} "
              f"(limit {tol_un:.3g})")
        assert g["ps_rs"] <= tol_ref, (case, q, g)
        assert g["ps_pu"] <= tol_un, (case, q, g)


MOE_TIE = 0.05  # a token's K-th and (K+1)-th probabilities this close (relative) tie
MOE_MAX_FLIPS = 0.05  # of the tokens of a layer


def _flips(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """(chunk, token) pairs whose set of experts differs."""
    return np.argwhere((np.sort(got, -1) != np.sort(want, -1)).any(-1))


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("deepseek")])
def test_moe_routing_equals_reference(out, case):
    """Each layer's routing over the global batch (the data ranks' chunks in
    order) against the reference call that it matches best (the reference
    records the forward and the remat recompute, in no fixed order): the
    set of experts each token goes to, as integers.  The order within a
    token's top k, on which no dispatch map depends, may differ, and a
    token may take another K-th expert only where the port's own K-th and
    (K+1)-th probabilities tie within ``MOE_TIE`` (the reference's sharded
    and unsharded steps flip such tokens between themselves too), for at
    most ``MOE_MAX_FLIPS`` of a layer's tokens."""
    _, shape, axes = CASES[case]
    mesh = Mesh(axes, shape)
    ref = load(out / "ref" / f"{case}.npz")
    ref_routes = [v for k, v in ref.items() if k.startswith("route")]
    per_rank = [load(out / "port" / f"{case}.r{r}.npz") for r in range(mesh.size)]
    data_ranks = [r for r in range(mesh.size) if coords_of(mesh, r)["model"] == 0]
    layers = sorted(k[5:] for k in per_rank[0] if k.startswith("route"))
    assert layers, "the port recorded no routing"
    for i in layers:
        got = np.concatenate([per_rank[r][f"route{i}"] for r in data_ranks])
        probs = np.concatenate([per_rank[r][f"probs{i}"] for r in data_ranks])
        flips = min((_flips(got, want) for want in ref_routes), key=len)
        k = got.shape[-1]
        for c, t in flips:
            top = np.sort(probs[c, t])[::-1]
            assert (top[k - 1] - top[k]) / top[k - 1] < MOE_TIE, (case, i, c, t, top)
        print(f"{case} layer {i}: {len(flips)} of {got.shape[0] * got.shape[1]} tokens "
              "take another K-th expert at a near tie")
        assert len(flips) <= MOE_MAX_FLIPS * got.shape[0] * got.shape[1]
        for r in range(mesh.size):  # the model ranks of a chunk route alike
            np.testing.assert_array_equal(per_rank[r][f"route{i}"],
                                          per_rank[r ^ 1][f"route{i}"])


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_blocks(out, case):
    """A rank's parameter and moment blocks are the gathered tensors' blocks
    at its coordinate of the cell's shardings."""
    arch, shape, axes = CASES[case]
    mesh = Mesh(axes, shape)
    spec, sshape = spec_and_shape("repro_torch", arch)
    cell = build_cell(spec, sshape, mesh)
    full = load(out / "port" / f"{case}.r0.npz")
    from repro_torch.ckpt.checkpoint import _flatten

    psh = dict(_flatten(cell.in_shardings[0]))
    msh = dict(_flatten(cell.in_shardings[1]["mu"]))
    for r in range(mesh.size):
        got = load(out / "port" / f"{case}.r{r}.npz")
        c = coords_of(mesh, r)
        for k, v in tree_part(got, "blk:").items():
            np.testing.assert_array_equal(v, local_block(full[f"p:{k}"], psh[k], c))
        for k, v in tree_part(got, "mublk:").items():
            np.testing.assert_array_equal(v, local_block(full[f"mu:{k}"], msh[k], c))


def _assert_bit_equal(a: dict, b: dict, tag: str) -> None:
    for key in ("loss", "gn"):
        assert a[key].tobytes() == b[key].tobytes(), (tag, key)
    for q in ("p", "mu", "nu"):
        ta, tb = tree_part(a, f"{q}:"), tree_part(b, f"{q}:")
        assert ta.keys() == tb.keys()
        for k in tb:
            assert ta[k].tobytes() == tb[k].tobytes(), (tag, q, k)


@pytest.mark.parametrize("case", [c for c, *_ in ONE_RANK_CASES])
def test_one_rank_is_bit_equal_to_unsharded(out, case):
    _assert_bit_equal(load(out / "port" / f"{case}.r0.npz"),
                      load(out / "port" / f"{case}.un.npz"), case)


def _unsharded_next_step(saved: dict):
    """The port's unsharded step from the elastic case's saved state."""
    from repro_torch.launch.workloads import value_and_grad
    from repro_torch.models import transformer as lm
    from repro_torch.optim import adamw_update

    arch = CASES[ELASTIC][0]
    spec, _ = spec_and_shape("repro_torch", arch)
    shapes = lm.param_shapes(spec.config)
    from repro_torch.ckpt.checkpoint import _flatten, _unflatten

    keys = [k for k, _ in _flatten(shapes)]
    dtypes = [v.dtype for _, v in _flatten(shapes)]

    def tree(prefix, dtype=None):
        return _unflatten(shapes, iter(torch.from_numpy(saved[f"{prefix}:{k}"]).to(
            dtype or dt) for k, dt in zip(keys, dtypes)))

    params = tree("p")
    opt = {"mu": tree("mu", torch.float32), "nu": tree("nu", torch.float32),
           "step": torch.ones((), dtype=torch.int32)}
    tokens, labels = (torch.from_numpy(a) for a in case_batch(arch))
    value, grads = value_and_grad(lambda p: lm.loss_fn(p, spec.config, tokens, labels),
                                  params)
    with torch.no_grad():
        p, o, gn = adamw_update(params, grads, opt)
    return value, gn, {k: v.float().numpy() for k, v in _flatten(p)}


def test_elastic_restore_across_meshes(out):
    saved = load(out / "port" / f"{ELASTIC}.r0.npz")
    loss1, gn1, p1 = _unsharded_next_step(saved)
    arch = CASES[ELASTIC][0]
    spec, sshape = spec_and_shape("repro_torch", arch)
    g = gaps(out, ELASTIC)
    for shape, tag in (((1, 2), "data1,model2"), ((1, 1), "data1,model1")):
        mesh = Mesh(("data", "model"), shape)
        cell = build_cell(spec, sshape, mesh)
        from repro_torch.ckpt.checkpoint import _flatten

        psh = dict(_flatten(cell.in_shardings[0]))
        msh = dict(_flatten(cell.in_shardings[1]["mu"]))
        for r in range(mesh.size):
            got = load(out / "port" / f"elastic-{tag}.r{r}.npz")
            c = coords_of(mesh, r)
            assert int(got["step"]) == 1
            for k, v in tree_part(got, "rblk:").items():
                np.testing.assert_array_equal(v, local_block(saved[f"p:{k}"], psh[k], c))
            for k, v in tree_part(got, "rmublk:").items():
                np.testing.assert_array_equal(v, local_block(saved[f"mu:{k}"], msh[k], c))
        got = load(out / "port" / f"elastic-{tag}.r0.npz")
        p = tree_part(got, "p:")
        if mesh.size == 1:
            assert float(got["loss"]) == float(loss1) and float(got["gn"]) == float(gn1)
            assert all(np.array_equal(p[k], p1[k]) for k in p1)
        else:
            def tol(q, floor):  # the first step's bound against the unsharded step
                return K_TOL * max(g[q]["rs_ru"], g[q]["pu_ru"]) + floor

            assert _rel(got["loss"], loss1) <= tol("loss", FLOOR_SCALAR)
            assert _rel(got["gn"], gn1) <= tol("gn", FLOOR_SCALAR)
            assert _tree_gap(p, p1) <= tol("p", FLOOR_TREE)


def test_reference_checkpoint_restores_into_port_blocks(out):
    """The reference's sharded step state, saved by ``repro.ckpt``, restores
    into the port's blocks at every coordinate of (data 2, model 2)."""
    ref = load(out / "ref" / f"{ELASTIC}.npz")
    arch, shape, axes = CASES[ELASTIC]
    spec, sshape = spec_and_shape("repro_torch", arch)
    from repro_torch.ckpt.checkpoint import _flatten

    for r in range(4):
        mesh = Mesh(axes, shape, rank=r)
        cell = build_cell(spec, sshape, mesh)
        shardings = {"params": cell.in_shardings[0], "opt": cell.in_shardings[1]}
        target = {"params": place(case_params(arch), cell.in_shardings[0], "cpu"),
                  "opt": cell.init_opt("cpu")}
        state, aux, step = restore_checkpoint(str(out / "ref" / "jax_ckpt"), target,
                                              shardings=shardings)
        assert step == 1 and aux == {"next_step": 1} and int(state["opt"]["step"]) == 1
        for q, tree, shs in (("p", state["params"], shardings["params"]),
                             ("mu", state["opt"]["mu"], shardings["opt"]["mu"]),
                             ("nu", state["opt"]["nu"], shardings["opt"]["nu"])):
            sh = dict(_flatten(shs))
            for k, v in _flatten(tree):
                want = local_block(ref[f"{q}:{k}"], sh[k], mesh.coords)
                np.testing.assert_array_equal(v.float().numpy(), want, err_msg=f"{q} {k}")


TRAINER_RANKS = {c: int(np.prod(shape)) for c, _a, shape, _ax in TRAINER_CASES}


@pytest.mark.parametrize("case", sorted(TRAINER_RANKS))
def test_trainer_resumes_bit_for_bit(out, case):
    for r in range(TRAINER_RANKS[case]):
        got = load(out / "port" / f"trainer-{case}.r{r}.npz")
        assert len(got["full"]) == TRAINER_STEPS and len(got["cut"]) == TRAINER_KILL
        np.testing.assert_array_equal(np.concatenate([got["cut"], got["resumed"]]),
                                      got["full"])
        full, resumed = tree_part(got, "full:"), tree_part(got, "resumed:")
        assert full.keys() == resumed.keys()
        for k in full:
            assert full[k].tobytes() == resumed[k].tobytes(), k


@pytest.mark.parametrize("case", sorted(TRAINER_RANKS))
def test_trainer_runs_the_cells_step(out, case):
    for r in range(TRAINER_RANKS[case]):
        got = load(out / "port" / f"trainer-{case}.r{r}.npz")
        np.testing.assert_array_equal(got["full"], got["cell"])
        # the norm too: a GNN gradient summed over data ranks changes it
        # alone (a clipped update is the same for a power-of-2 multiple)
        np.testing.assert_array_equal(got["trainer_gn"], got["cell_gn"][0])
        full, cell = tree_part(got, "full:"), tree_part(got, "cell:")
        assert full.keys() == cell.keys()
        for k in full:
            assert full[k].tobytes() == cell[k].tobytes(), k


def test_compression_matches_shard_map(out):
    ref = load(out / "ref" / "compression.npz")
    for r in range(2):
        got = load(out / "port" / f"compression.r{r}.npz")
        np.testing.assert_allclose(got["mean"], ref["mean"][r], rtol=0, atol=1e-7)
        np.testing.assert_allclose(got["residual"], ref["residual"][r], rtol=0, atol=1e-7)
