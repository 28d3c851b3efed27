"""The port's shardings against the reference's, spec by spec and block by
block (``repro_torch.launch.sharding``, ``launch.mesh``).

The reference runs in one subprocess on 8 fake CPU devices
(``tests/train_dist_cases.py``, part "specs"): its ``PartitionSpec``s from
the parameters' shapes alone, and the shard each device holds after
``jax.device_put``.  The port needs no process group here: its specs come
from an abstract mesh, its blocks from ``local_block`` at each coordinate.

* every LM config (full and reduced, with and without FSDP), the FM and the
  four GNNs, on (data 2, model 2), (pod 2, data 1, model 2) and (pod 2,
  data 2, model 2): ``param_shardings`` and ``opt_state_shardings`` (the
  ZeRO-1 moments) equal the reference's, entry for entry;
* a tensor split over an axis tuple (pod-major), over two dimensions,
  replicated along an axis, and over all three axes at once: each
  coordinate's block equals JAX's shard at that coordinate; a dimension
  the axes do not divide raises on both sides.
"""

import dataclasses
import json

import numpy as np
import pytest

from train_dist_cases import (BLOCK_CASES, SPEC_MESHES, load, mesh_key, norm_spec,
                              spec_cases, start_reference, wait_reference)
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import Mesh, abstract_mesh, coords_of, data_axes, mesh_size
from repro_torch.launch.sharding import NamedSharding, P, local_block, shard_shape
from repro_torch.launch.workloads import build_gnn_cell
from repro_torch.models import recsys, transformer as lm
from repro_torch.optim import opt_state_shardings


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("shard_specs")
    wait_reference(start_reference(out, "specs"))
    return dict(specs=json.loads((out / "specs.json").read_text()),
                blocks=load(out / "blocks.npz"))


def _port_specs(shardings, shapes) -> dict:
    flat_s = dict(_flatten(shardings))
    return {k: norm_spec(flat_s[k].spec, len(v.shape)) for k, v in _flatten(shapes)}


def port_specs(mshape, axes, arch, which, fsdp) -> dict:
    mesh = abstract_mesh(mshape, axes)
    dp = data_axes(mesh)
    spec = get_arch(arch)
    cfg = getattr(spec, which)
    if spec.family == "lm":
        cfg = dataclasses.replace(cfg, fsdp=fsdp)
        shapes = lm.param_shapes(cfg)
        psh = lm.param_shardings(cfg, mesh, dp=dp)
        osh = opt_state_shardings(psh, shapes, mesh, dp=dp)
    elif spec.family == "recsys":
        shapes = recsys.param_shapes(cfg)
        psh = recsys.param_shardings(cfg, mesh)
        osh = opt_state_shardings(psh, shapes, mesh, dp=dp)
    else:
        cell = build_gnn_cell(dataclasses.replace(spec, config=cfg),
                              spec.shape("full_graph_sm"), mesh)
        psh, osh = cell.in_shardings[0], cell.in_shardings[1]
        shapes = cell.input_specs[0]
    return dict(params=_port_specs(psh, shapes), mu=_port_specs(osh["mu"], shapes),
                nu=_port_specs(osh["nu"], shapes), step=norm_spec(osh["step"].spec, 0))


CASES = [(m, c) for m in SPEC_MESHES for c in spec_cases()]


@pytest.mark.parametrize("mesh,case", CASES,
                         ids=[f"{mesh_key(*m)}-{a}-{w}-{'fsdp' if f else 'tp'}"
                              for m, (a, w, f) in CASES])
def test_specs_equal_reference(ref, mesh, case):
    key = f"{mesh_key(*mesh)}|{case[0]}|{case[1]}|{case[2]}"
    want = json.loads(ref["specs"][key])
    got = port_specs(*mesh, *case)
    assert got == want


def test_zero1_moments_split_the_data_axes():
    """A spot check of what the spec cases compare: on (pod 2, data 2,
    model 2) Qwen3-MoE's expert moments add ("pod", "data") on the first
    free dimension the data axes divide (not the 94 layers: d_model); FSDP
    parameters keep theirs."""
    got = port_specs((2, 2, 2), ("pod", "data", "model"), "qwen3-moe-235b-a22b", "config",
                     False)
    assert got["params"]["['layers']['e_gate']"] == [None, ["model"], None, None]
    assert got["mu"]["['layers']['e_gate']"] == [None, ["model"], ["pod", "data"], None]
    assert got["mu"]["['final_norm']"] == [["pod", "data"]]
    fsdp = port_specs((2, 2, 2), ("pod", "data", "model"), "qwen3-moe-235b-a22b", "config",
                      True)
    assert fsdp["mu"] == fsdp["params"]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_blocks_equal_jax_shards(ref, case):
    name, shape, mshape, axes, spec = case
    mesh = abstract_mesh(mshape, axes)
    sh = NamedSharding(mesh, P(*spec))
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    blocks = ref["blocks"]
    if f"{name}:error" in blocks:
        with pytest.raises(ValueError, match="does not split"):
            local_block(x, sh, coords_of(mesh, 0))
        return
    for r in range(mesh.size):
        c = coords_of(mesh, r)
        want = blocks[f"{name}:{','.join(str(c[a]) for a in axes)}"]
        got = local_block(x, sh, c)
        assert got.shape == shard_shape(shape, sh)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} at {c}")


def test_mesh_layout_and_checks():
    """Rank r sits at the row-major coordinate of r; a spec names known
    axes in mesh order, each once; an abstract mesh has no groups."""
    mesh = abstract_mesh((2, 1, 2), ("pod", "data", "model"))
    assert [coords_of(mesh, r) for r in range(4)] == [
        dict(pod=p, data=0, model=m) for p in (0, 1) for m in (0, 1)]
    assert mesh_size(mesh) == 4 and data_axes(mesh) == ("pod", "data")
    for bad in ((("data", "pod"),), ("model", "model"), ("expert",)):
        with pytest.raises(ValueError):
            NamedSharding(mesh, P(*bad)).entries(2)
    with pytest.raises(ValueError):
        mesh.axis("model")
    ranked = Mesh(("data", "model"), (2, 2), rank=3)
    assert ranked.coords == dict(data=1, model=1)
    np.testing.assert_array_equal(
        local_block(np.arange(8).reshape(4, 2), NamedSharding(ranked, P("data"))),
        [[4, 5], [6, 7]])
