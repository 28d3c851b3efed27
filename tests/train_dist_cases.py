"""Shared by the sharded-training differentials (``tests/test_torch_shard_*.py``).

Two sides run each case and write ``.npz`` files that the tests compare:

* the reference: ``repro.launch.workloads.build_cell(...).step`` jitted
  with its in/out shardings under ``jax.set_mesh`` on fake CPU devices, in
  subprocesses (``python tests/train_dist_cases.py OUT PART``;
  ``XLA_FLAGS`` gives it the devices before jax is imported, and the jax
  0.9 shim is set before ``repro`` is), and the same step unsharded on one
  device (the gap between the two sets each comparison's tolerance);
* the port: ``repro_torch.launch.workloads.build_cell(...).step`` on 4
  gloo processes (:func:`run_port`, through ``repro_torch.launch.mesh.spawn``),
  each rank on its blocks, and the port's unsharded step (cases dealt out
  over the ranks).

Both sides make every input from the same numpy seed (:func:`case_params`,
:func:`case_batch`), so no arrays cross between them before the tests
compare.  This module imports neither jax nor ``repro`` at its top: the
port's processes import it too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600

# (case, arch, mesh shape, mesh axes)
STEP_CASES = [
    ("qwen2-d2m2", "qwen2-1.5b", (2, 2), ("data", "model")),
    ("qwen2fsdp-d2m2", "qwen2-1.5b+fsdp", (2, 2), ("data", "model")),
    ("smollm-d2m2", "smollm-135m", (2, 2), ("data", "model")),
    ("deepseek-d2m2", "deepseek-moe-16b", (2, 2), ("data", "model")),
    ("deepseek-p2d1m2", "deepseek-moe-16b", (2, 1, 2), ("pod", "data", "model")),
    ("gatedgcn-d4", "gatedgcn", (4,), ("data",)),
    ("gatedgcn-d2m2", "gatedgcn", (2, 2), ("data", "model")),
    ("pna-d4", "pna", (4,), ("data",)),
    ("pna-d2m2", "pna", (2, 2), ("data", "model")),
    ("dimenet-d2m2", "dimenet", (2, 2), ("data", "model")),
    ("fm-d2m2", "fm", (2, 2), ("data", "model")),
]
# the port alone at a (1, 1) mesh: equal to its unsharded step bit for bit
ONE_RANK_CASES = [
    ("qwen2-d1m1", "qwen2-1.5b", (1, 1), ("data", "model")),
    ("deepseek-d1m1", "deepseek-moe-16b", (1, 1), ("data", "model")),
    ("gatedgcn-d1m1", "gatedgcn", (1, 1), ("data", "model")),
    ("dimenet-d1m1", "dimenet", (1, 1), ("data", "model")),
    ("fm-d1m1", "fm", (1, 1), ("data", "model")),
]
LM_DIMS = dict(global_batch=4, seq_len=16)
GNN_DIMS = dict(n_nodes=64, n_edges=1000, d_feat=8)  # edges padded to 1024
MOL_DIMS = dict(batch=16, n_nodes=8, n_edges=32)  # 512 edges, 1024 triplets
FM_DIMS = dict(batch=64)
ELASTIC = "qwen2-d2m2"  # the case whose step is saved and restored elsewhere
TRAINER_STEPS, TRAINER_KILL = 5, 3
# the sharded Trainer: an LM (ZeRO-1 update) and a GNN (edge-parallel, whole
# gradients, replicated moments)
TRAINER_CASES = [
    ("qwen2-d1m2", "qwen2-1.5b", (1, 2), ("data", "model")),
    ("gatedgcn-d2m2", "gatedgcn", (2, 2), ("data", "model")),
]


# -- the inputs ------------------------------------------------------------------

def spec_and_shape(pkg: str, arch: str):
    """``pkg``'s ArchSpec with its reduced config (``+fsdp``: with FSDP on),
    and the small train shape of the case."""
    cfgs = __import__(f"{pkg}.configs", fromlist=["get_arch"])
    base = __import__(f"{pkg}.configs.base", fromlist=["ShapeSpec"])
    arch, fsdp = arch.split("+")[0], arch.endswith("+fsdp")
    spec = cfgs.get_arch(arch)
    spec = dataclasses.replace(spec, config=dataclasses.replace(spec.reduced, fsdp=True)
                               if fsdp else spec.reduced)
    if spec.family == "lm":
        shape = base.ShapeSpec("train_small", "train", LM_DIMS)
    elif arch == "dimenet":
        shape = base.ShapeSpec("molecule", "train", MOL_DIMS)
    elif spec.family == "gnn":
        shape = base.ShapeSpec("full_graph_sm", "train", GNN_DIMS)
    else:
        shape = base.ShapeSpec("train_batch", "train", FM_DIMS)
    return spec, shape


def cell_config(spec, mesh_shape: dict):
    """The config a cell runs (an MoE's token chunks and axes set from the
    mesh, as ``build_lm_cell`` sets them)."""
    cfg = spec.config
    if spec.family == "lm" and cfg.is_moe:
        dp = tuple(a for a in ("pod", "data") if a in mesh_shape)
        cfg = dataclasses.replace(cfg, n_token_shards=int(np.prod([mesh_shape[a] for a in dp])),
                                  dp_axes=dp, ep_axis="model")
    return cfg


def _bf16(a: np.ndarray) -> np.ndarray:
    import ml_dtypes

    return a.astype(ml_dtypes.bfloat16)


def case_params(arch: str) -> object:
    """The step's starting weights, a numpy tree with the port's structure
    (the reference's): seeded by the arch's name."""
    import torch

    from repro_torch.models import recsys, transformer as lm

    spec, _ = spec_and_shape("repro_torch", arch)
    cfg = spec.config
    rng = np.random.default_rng(sum(map(ord, arch.split("+")[0])))
    if spec.family == "lm":
        out = {}

        def leaf(name, sd):
            shape = sd.shape
            if name.endswith("norm"):
                a = 1.0 + 0.1 * rng.normal(size=shape)
            elif name in ("bq", "bk", "bv"):
                a = 0.02 * rng.normal(size=shape)
            elif name == "router":
                a = 0.5 * rng.normal(size=shape)
            else:
                a = rng.normal(size=shape) * shape[-2] ** -0.5
            a = a.astype(np.float32)
            return _bf16(a) if sd.dtype == torch.bfloat16 else a

        shapes = lm.param_shapes(cfg)
        out["embed"] = leaf("embed", shapes["embed"])
        out["final_norm"] = leaf("final_norm", shapes["final_norm"])
        out["layers"] = {k: leaf(k, v) for k, v in shapes["layers"].items()}
        return out
    if spec.family == "recsys":
        shapes = recsys.param_shapes(cfg)
        return {"table": (0.01 * rng.normal(size=shapes["table"].shape)).astype(np.float32),
                "w1": (0.01 * rng.normal(size=shapes["w1"].shape)).astype(np.float32),
                "bias": np.full((), 0.1, np.float32)}
    from repro_torch.launch.workloads import _GNN_MODULES

    d = 16 if arch in ("egnn",) else GNN_DIMS["d_feat"]
    if arch in ("gatedgcn", "pna", "egnn"):
        cfg = dataclasses.replace(cfg, d_in=d)
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    params = _GNN_MODULES[arch].init_params(gen, cfg, device="cpu")

    def jitter(t):  # non-zero biases, so that every parameter has a gradient
        a = t.numpy()
        return (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32) if a.ndim == 1 else a

    from torch.utils import _pytree as pytree

    return pytree.tree_map(jitter, params)


def case_batch(arch: str) -> tuple:
    """The step's batch arguments after ``(params, opt)``, numpy."""
    spec, shape = spec_and_shape("repro_torch", arch)
    cfg = spec.config
    rng = np.random.default_rng(7 + sum(map(ord, arch.split("+")[0])))
    if spec.family == "lm":
        b, s = LM_DIMS["global_batch"], LM_DIMS["seq_len"]
        tok = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
        return tok[:, :-1].copy(), tok[:, 1:].copy()
    if spec.family == "recsys":
        b = FM_DIMS["batch"]
        return ({"ids": rng.integers(0, cfg.rows_per_field, (b, cfg.n_fields)).astype(np.int32),
                 "labels": (rng.random(b) < 0.3).astype(np.float32)},)
    from repro_torch.data.graphs import random_graph
    from repro_torch.data.pipeline import build_triplets, molecule_batch

    if arch == "dimenet":
        mb = molecule_batch(rng, MOL_DIMS["batch"], MOL_DIMS["n_nodes"], MOL_DIMS["n_edges"])
        e = mb["edge_index"].shape[1]
        return ({"edge_index": mb["edge_index"], "pos": mb["pos"],
                 "graph_ids": mb["graph_ids"], "y": mb["y"], "z": mb["z"],
                 "triplets": build_triplets(mb["edge_index"], 2 * e),
                 "x": mb["x"]},)
    e = (GNN_DIMS["n_edges"] + 511) // 512 * 512
    g = random_graph(rng, GNN_DIMS["n_nodes"], e, GNN_DIMS["d_feat"], cfg.n_classes)
    if arch == "pna":
        del g["edge_attr"]
    return (g,)


def flat(tree) -> dict:
    """A tree's leaves as f32/int numpy arrays (bf16 exactly as f32) by the
    checkpoint's keys (JAX's keystr)."""
    from repro_torch.ckpt.checkpoint import _flatten

    out = {}
    for k, v in _flatten(tree):
        a = v.detach().float().cpu().numpy() if hasattr(v, "detach") and v.is_floating_point() \
            else np.asarray(v)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        out[k] = a
    return out


def _save(path: Path, **kw) -> None:
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **kw)
    os.replace(tmp, path)


def _pack(prefix: str, tree) -> dict:
    return {f"{prefix}{k}": v for k, v in flat(tree).items()}


def load(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def tree_part(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


# -- the reference side ------------------------------------------------------------

def start_reference(out: Path, part: str) -> subprocess.Popen:
    """The reference's ``part``: "steps_lm" (the LM step cases) or
    "steps_rest" (GNN and FM, and the compression exchange) on 4 fake
    devices, or "specs" (specs and blocks) on 8."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    devices = 8 if part == "specs" else 4
    env.update(XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")]))
    log = open(out / f"ref-{part}.log", "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(out), part],
                            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    proc.log, proc.log_path = log, out / f"ref-{part}.log"
    return proc


def wait_reference(proc, timeout_s: float = TIMEOUT_S) -> None:
    try:
        rc = proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = "timeout"
    proc.log.close()
    if rc != 0:
        raise AssertionError(f"reference: {rc}\n" + proc.log_path.read_text()[-4000:])


def _jax_tree(tree):
    import jax.numpy as jnp
    from torch.utils import _pytree as pytree

    return pytree.tree_map(jnp.asarray, tree)


def _ref_step(case: str, arch: str, shape_, axes, out: Path) -> None:
    import jax

    from repro.compat import make_mesh
    from repro.launch.workloads import build_cell
    from repro.models import transformer as jlm
    from repro.optim import adamw_init, adamw_update

    spec, shape = spec_and_shape("repro", arch)
    mesh = make_mesh(shape_, axes, devices=jax.devices()[:int(np.prod(shape_))])
    mesh1 = make_mesh((1,) * len(axes), axes, devices=jax.devices()[:1])
    params = _jax_tree(case_params(arch))
    batch = case_batch(arch)
    routes: list = []
    real_top_k = jax.lax.top_k

    def top_k(x, k):
        vals, idx = real_top_k(x, k)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)), idx)
        return vals, idx

    jax.lax.top_k = top_k
    try:
        with jax.set_mesh(mesh):
            cell = build_cell(spec, shape, mesh)
            args = jax.device_put((params, adamw_init(params), *batch), cell.in_shardings)
            fn = jax.jit(cell.step, in_shardings=cell.in_shardings,
                         out_shardings=cell.out_shardings)
            p, o, loss, gn = jax.block_until_ready(fn(*args))
        sharded_routes = list(routes)
        routes.clear()
        cfg = cell_config(spec, dict(zip(axes, shape_)))
        with jax.set_mesh(mesh1):
            if spec.family == "lm":
                def step(params, opt, tokens, labels):
                    value, grads = jax.value_and_grad(jlm.loss_fn)(params, cfg, tokens, labels)
                    params, opt, gn = adamw_update(params, grads, opt)
                    return params, opt, value, gn
            else:
                step = build_cell(spec, shape, mesh1).step
            p1, o1, loss1, gn1 = jax.block_until_ready(
                jax.jit(step)(params, adamw_init(params), *batch))
    finally:
        jax.lax.top_k = real_top_k
    res = dict(loss=np.asarray(loss), gn=np.asarray(gn), loss_un=np.asarray(loss1),
               gn_un=np.asarray(gn1), **_pack("p:", p), **_pack("mu:", o["mu"]),
               **_pack("nu:", o["nu"]), **_pack("pu:", p1), **_pack("muu:", o1["mu"]),
               **_pack("nuu:", o1["nu"]))
    for i, r in enumerate(sharded_routes):
        res[f"route{i}"] = r
    for i, r in enumerate(routes):
        res[f"uroute{i}"] = r
    _save(out / f"{case}.npz", **res)
    if case == ELASTIC:
        from repro.ckpt import save_checkpoint

        save_checkpoint(str(out / "jax_ckpt"), 1, {"params": p, "opt": o},
                        aux={"next_step": 1})


BLOCK_CASES = [  # (name, global shape, mesh shape, mesh axes, spec)
    ("pod_data_rows", (8, 6), (2, 2, 2), ("pod", "data", "model"),
     (("pod", "data"), "model")),
    ("data_model_3d", (2, 4, 6), (2, 2), ("data", "model"), (None, "data", "model")),
    ("model_rows_replicated_data", (6, 4), (2, 2), ("data", "model"), ("model",)),
    ("all_axes_one_dim", (16,), (2, 2, 2), ("pod", "data", "model"),
     (("pod", "data", "model"),)),
    ("not_divisible", (5, 4), (2, 2), ("data", "model"), ("data", None)),
]


def _ref_blocks(out: Path) -> None:
    """Each block case placed by ``jax.device_put``: every device's shard by
    its mesh coordinate, or the error."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import make_mesh

    res = {}
    for name, shape, mshape, axes, spec in BLOCK_CASES:
        mesh = make_mesh(mshape, axes, devices=jax.devices()[:int(np.prod(mshape))])
        x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
        try:
            arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
        except Exception as e:  # noqa: BLE001 - the error is the result
            res[f"{name}:error"] = np.asarray(type(e).__name__)
            continue
        devs = mesh.devices
        for sh in arr.addressable_shards:
            coord = np.argwhere(devs == sh.device)[0]
            res[f"{name}:{','.join(map(str, coord))}"] = np.asarray(sh.data)
    _save(out / "blocks.npz", **res)


def _ref_compression(out: Path) -> None:
    """``tests/test_compression.py``'s shard_map pod exchange on 2 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh, shard_map
    from repro.optim.compression import compressed_grad_exchange

    mesh = make_mesh((2,), ("pod",), devices=jax.devices()[:2])
    g, e = compression_inputs()

    def body(g, e):
        mean, new_e = compressed_grad_exchange({"g": g[0]}, {"g": e[0]}, axis="pod")
        return mean["g"][None], new_e["g"][None]

    mean, new_e = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                                    out_specs=(P("pod"), P("pod"))))(jnp.asarray(g),
                                                                     jnp.asarray(e))
    _save(out / "compression.npz", mean=np.asarray(mean), residual=np.asarray(new_e))


def compression_inputs():
    """Two pods' gradients and carried residuals."""
    rng = np.random.default_rng(11)
    g = np.stack([np.linspace(-1, 1, 64), np.linspace(0, 2, 64)]).astype(np.float32)
    e = (rng.normal(size=(2, 64)) * 1e-3).astype(np.float32)
    return g, e


def _ref_specs(out: Path) -> None:
    """Every LM config (full and reduced, with and without FSDP), the FM and
    the four GNNs: param and optimiser-state PartitionSpecs on three
    meshes (shapes only)."""
    import jax

    from repro.compat import make_mesh
    from repro.configs import get_arch
    from repro.launch.mesh import data_axes
    from repro.launch.workloads import build_gnn_cell
    from repro.models import recsys, transformer as jlm
    from repro.optim import opt_state_shardings

    res = {}
    for mshape, axes in SPEC_MESHES:
        mesh = make_mesh(mshape, axes, devices=jax.devices()[:int(np.prod(mshape))])
        dp = data_axes(mesh)
        mkey = mesh_key(mshape, axes)
        for arch, which, fsdp in spec_cases():
            spec = get_arch(arch)
            cfg = getattr(spec, which)
            if spec.family == "lm":
                cfg = dataclasses.replace(cfg, fsdp=fsdp)
                shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0), cfg))
                psh = jlm.param_shardings(cfg, mesh, dp=dp)
                osh = opt_state_shardings(psh, shapes, mesh, dp=dp)
            elif spec.family == "recsys":
                shapes = jax.eval_shape(lambda: recsys.init_params(jax.random.PRNGKey(0), cfg))
                psh = recsys.param_shardings(cfg, mesh)
                osh = opt_state_shardings(psh, shapes, mesh, dp=dp)
            else:
                shape = spec.shape("full_graph_sm")
                cell = build_gnn_cell(dataclasses.replace(spec, config=cfg), shape, mesh)
                psh, osh = cell.in_shardings[0], cell.in_shardings[1]
                shapes = cell.input_specs[0]
            key = f"{mkey}|{arch}|{which}|{fsdp}"
            res[key] = json.dumps(dict(
                params=_jax_specs(psh, shapes), mu=_jax_specs(osh["mu"], shapes),
                nu=_jax_specs(osh["nu"], shapes), step=norm_spec(osh["step"].spec, 0)))
    (out / "specs.json").write_text(json.dumps(res))


SPEC_MESHES = [((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model")),
               ((2, 2, 2), ("pod", "data", "model"))]
LM_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-moe-16b", "qwen2-1.5b", "smollm-135m",
            "starcoder2-15b")


def spec_cases() -> list:
    out = [(a, w, f) for a in LM_ARCHS for w in ("config", "reduced") for f in (False, True)]
    out += [("fm", w, False) for w in ("config", "reduced")]
    out += [(a, "config", False) for a in ("gatedgcn", "pna", "egnn", "dimenet")]
    return out


def mesh_key(shape, axes) -> str:
    return ",".join(f"{a}{s}" for a, s in zip(axes, shape))


def norm_spec(spec, ndim: int) -> list:
    """A PartitionSpec as a list of ndim entries, each None or a list of
    axis names."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append(None if e is None or e == () else ([e] if isinstance(e, str) else list(e)))
    return out


def _jax_specs(shardings, shapes) -> dict:
    import jax

    keys = jax.tree_util.tree_flatten_with_path(shapes)[0]
    sh = jax.tree_util.tree_leaves(shardings)
    return {jax.tree_util.keystr(k): norm_spec(s.spec, len(v.shape))
            for (k, v), s in zip(keys, sh)}


def reference_main(out: str, part: str) -> None:
    import jax
    import jax.experimental
    import jax.extend.core

    # jax 0.9 moved these; the reference package imports them by their old names
    jax.experimental.enable_x64 = jax.enable_x64
    jax.core.Jaxpr = jax.extend.core.Jaxpr
    out = Path(out)
    t0 = time.perf_counter()
    if part == "specs":
        _ref_specs(out)
        _ref_blocks(out)
        print("specs, blocks", f"{time.perf_counter() - t0:.1f}s", flush=True)
        return
    lm_part = part == "steps_lm"
    if not lm_part:
        _ref_compression(out)
    for case, arch, shape, axes in STEP_CASES:
        if arch.startswith(("qwen", "smollm", "deepseek")) != lm_part:
            continue
        t0 = time.perf_counter()
        _ref_step(case, arch, shape, axes, out)
        print(case, f"{time.perf_counter() - t0:.1f}s", flush=True)


# -- the port side ---------------------------------------------------------------------

def run_port(out: Path, jobs: list[str], world: int = 4) -> None:
    """The port's sharded cases (``jobs``: "steps", "one_rank", "elastic",
    "trainer", "compression") in ``world`` gloo processes."""
    from repro_torch.launch.mesh import spawn

    out.mkdir(parents=True, exist_ok=True)
    spawn(port_main, world, (jobs, str(out)), store_path=str(out / "store"), threads=1,
          timeout_s=300)


def _port_unsharded(arch: str, cfg, params_np, batch):
    """The port's unsharded step on the same inputs."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.launch.workloads import _GNN_MODULES, value_and_grad
    from repro_torch.models import recsys, transformer as lm
    from repro_torch.optim import adamw_init, adamw_update

    params = pytree.tree_map(lambda a: _tensor(a), params_np)
    args = [pytree.tree_map(_tensor, b) for b in batch]
    if cfg.__class__.__name__ == "LMConfig":
        def loss(p, tokens, labels):
            return lm.loss_fn(p, cfg, tokens, labels)
    elif arch == "fm":
        def loss(p, b):
            return recsys.loss_fn(p, cfg, b)
    else:
        n_graphs = MOL_DIMS["batch"] if arch == "dimenet" else 1
        gcfg = cfg if arch == "dimenet" else dataclasses.replace(cfg, d_in=GNN_DIMS["d_feat"])

        def loss(p, b):
            return _GNN_MODULES[arch].loss_fn(p, gcfg, dict(b, n_graphs=n_graphs))
    value, grads = value_and_grad(loss, params, *args)
    with torch.no_grad():
        p, o, gn = adamw_update(params, grads, adamw_init(params))
    return p, o, value, gn


def _tensor(a):
    from repro_torch.launch.sharding import _to_tensor

    return _to_tensor(a, "cpu") if isinstance(a, (np.ndarray, np.generic)) else a


def _place_inputs(cell, params_np, batch):
    from repro_torch.launch.sharding import place

    params = place(params_np, cell.in_shardings[0], "cpu")
    opt = cell.init_opt("cpu")
    args = [place(b, sh, "cpu") for b, sh in zip(batch, cell.in_shardings[2:])]
    return params, opt, args


def _port_step(case, arch, mesh, out: Path, unsharded: bool) -> None:
    from repro_torch.launch.sharding import gather_tree
    from repro_torch.launch.workloads import build_cell
    from repro_torch.models.moe import RoutingLog, routing_log

    spec, shape = spec_and_shape("repro_torch", arch)
    params_np, batch = case_params(arch), case_batch(arch)
    if mesh is not None:
        cell = build_cell(spec, shape, mesh)
        params, opt, args = _place_inputs(cell, params_np, batch)
        with routing_log(RoutingLog(keep_calls=True)) as log:
            p, o, loss, gn = cell.step(params, opt, *args)
        pg = gather_tree(p, cell.in_shardings[0])
        og = gather_tree(o, cell.in_shardings[1])
        res = dict(loss=loss.numpy(), gn=gn.numpy(), counts=json.dumps(mesh.counts()),
                   **_pack("blk:", p), **_pack("mublk:", o["mu"]))
        if mesh.rank == 0:
            res.update(**_pack("p:", pg), **_pack("mu:", og["mu"]), **_pack("nu:", og["nu"]))
        for i, r in enumerate(log.routes[:spec.config.n_layers] if spec.family == "lm" else []):
            res[f"route{i}"] = r["gate_idx"].numpy()
            res[f"probs{i}"] = r["probs"].numpy()
        _save(out / f"{case}.r{mesh.rank}.npz", **res)
        if case == ELASTIC:
            _port_elastic_save(cell, p, o, out)
    if unsharded:
        cfg = cell_config(spec, dict(zip(*_case_mesh(case)[::-1])))
        p1, o1, loss1, gn1 = _port_unsharded(arch, cfg, params_np, batch)
        _save(out / f"{case}.un.npz", loss=loss1.numpy(), gn=gn1.numpy(),
              **_pack("p:", p1), **_pack("mu:", o1["mu"]), **_pack("nu:", o1["nu"]))


def _case_mesh(case: str):
    for c, _arch, shape, axes in STEP_CASES + ONE_RANK_CASES:
        if c == case:
            return shape, axes
    raise KeyError(case)


def _port_elastic_save(cell, p, o, out: Path) -> None:
    from repro_torch.ckpt import save_checkpoint

    save_checkpoint(str(out / "elastic_ckpt"), 1, {"params": p, "opt": o},
                    aux={"next_step": 1},
                    shardings={"params": cell.in_shardings[0], "opt": cell.in_shardings[1]})
    import torch.distributed as dist

    dist.barrier()  # rank 0's write is done before any rank reads it


def _port_elastic_restore(meshes: dict, out: Path) -> None:
    """The elastic case's step-1 state restored at (data 1, model 2) and at
    one rank: each rank's blocks, and the next step's loss, norm and
    gathered parameters."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.launch.sharding import gather_tree
    from repro_torch.launch.workloads import build_cell

    arch = dict((c, a) for c, a, _, _ in STEP_CASES)[ELASTIC]
    spec, shape = spec_and_shape("repro_torch", arch)
    batch = case_batch(arch)
    for key in (((1, 2), ("data", "model")), ((1, 1), ("data", "model"))):
        mesh = meshes[key]
        if mesh is None:
            continue
        cell = build_cell(spec, shape, mesh)
        params, opt, args = _place_inputs(cell, case_params(arch), batch)
        state, aux, step = restore_checkpoint(
            str(out / "elastic_ckpt"), {"params": params, "opt": opt},
            shardings={"params": cell.in_shardings[0], "opt": cell.in_shardings[1]})
        p, o, loss, gn = cell.step(state["params"], state["opt"], *args)
        res = dict(loss=loss.numpy(), gn=gn.numpy(), step=np.asarray(step),
                   **_pack("rblk:", state["params"]), **_pack("rmublk:", state["opt"]["mu"]))
        pg = gather_tree(p, cell.in_shardings[0])
        if mesh.rank == 0:
            res.update(**_pack("p:", pg))
        tag = mesh_key(*key)
        _save(out / f"elastic-{tag}.r{mesh.rank}.npz", **res)


def _port_trainer(case: str, arch: str, mesh, out: Path) -> None:
    """A sharded Trainer run for TRAINER_STEPS steps uninterrupted, one
    killed after TRAINER_KILL and resumed, and the cell's own step run as
    many times on the same batches: losses and blocks."""
    from repro_torch.launch.sharding import local_block
    from repro_torch.launch.workloads import build_cell
    from repro_torch.train import TrainConfig, Trainer

    spec, shape = spec_and_shape("repro_torch", arch)
    cell = build_cell(spec, shape, mesh)
    params_np = case_params(arch)
    bsh = cell.in_shardings[2]
    if spec.family == "lm":
        b = LM_DIMS["global_batch"]

        def batch_fn(step):
            rng = np.random.default_rng(100 + step)
            tok = rng.integers(0, spec.config.vocab,
                               (b, LM_DIMS["seq_len"] + 1)).astype(np.int32)
            return {"tokens": local_block(tok[:, :-1], bsh),
                    "labels": local_block(tok[:, 1:], bsh)}

        def loss_fn(p, batch):
            return cell.loss(p, batch["tokens"], batch["labels"])

        def cell_args(batch):
            return _tensor(batch["tokens"]), _tensor(batch["labels"])
    else:
        (graph,) = case_batch(arch)

        def batch_fn(step):
            return {k: local_block(v, bsh[k]) for k, v in graph.items()}

        loss_fn = cell.loss

        def cell_args(batch):
            return ({k: _tensor(v) for k, v in batch.items()},)

    runs = {}
    for label in ("full", "cut", "resumed"):
        d = out / f"trainer-{case}_{'full' if label == 'full' else 'cut'}"
        cfg = TrainConfig(n_steps=TRAINER_STEPS, ckpt_dir=str(d), ckpt_every=2, keep=2,
                          async_ckpt=True, log_every=0)
        params, _, _ = _place_inputs(cell, params_np, ())
        t = Trainer(loss_fn, params, batch_fn, cfg, mesh=mesh, cell=cell)
        if label == "resumed" and not t.resume():
            raise AssertionError("nothing to resume")
        t.run(TRAINER_KILL if label == "cut" else None)
        t.close()
        runs[label] = t
    # the Trainer's first step alone, for its global norm
    params, _, _ = _place_inputs(cell, params_np, ())
    t = Trainer(loss_fn, params, batch_fn, TrainConfig(ckpt_dir=str(out / f"trainer-{case}_1")),
                mesh=mesh, cell=cell)
    _, trainer_gn = t._train_step(t._to_device(batch_fn(0)))
    t.close()
    p, o, _ = _place_inputs(cell, params_np, ())
    cell_losses, cell_gns = [], []
    for step in range(TRAINER_STEPS):
        p, o, loss, gn = cell.step(p, o, *cell_args(batch_fn(step)))
        cell_losses.append(float(loss))
        cell_gns.append(float(gn))
    res = dict(full=np.asarray(runs["full"].losses), cut=np.asarray(runs["cut"].losses),
               resumed=np.asarray(runs["resumed"].losses), cell=np.asarray(cell_losses),
               trainer_gn=trainer_gn.numpy(), cell_gn=np.asarray(cell_gns, np.float32),
               **_pack("full:", {"params": runs["full"].params, "opt": runs["full"].opt}),
               **_pack("resumed:", {"params": runs["resumed"].params,
                                    "opt": runs["resumed"].opt}),
               **_pack("cell:", {"params": p, "opt": o}))
    _save(out / f"trainer-{case}.r{mesh.rank}.npz", **res)


def _port_compression(mesh, out: Path) -> None:
    import torch

    from repro_torch.optim.compression import compressed_grad_exchange

    g, e = compression_inputs()
    r = mesh.rank
    mean, new_e = compressed_grad_exchange({"g": torch.from_numpy(g[r])},
                                           {"g": torch.from_numpy(e[r])},
                                           group=mesh.axis("pod").group)
    _save(out / f"compression.r{r}.npz", mean=mean["g"].numpy(), residual=new_e["g"].numpy())


def port_main(rank: int, world: int, jobs: list, out: str) -> None:
    from repro_torch.launch.mesh import make_mesh

    out = Path(out)
    keys = []
    for _c, _a, shape, axes in STEP_CASES + ONE_RANK_CASES:
        if (shape, axes) not in keys:
            keys.append((shape, axes))
    keys += [((1, 2), ("data", "model")), ((2,), ("pod",))]
    keys += [(shape, axes) for _c, _a, shape, axes in TRAINER_CASES if (shape, axes) not in keys]
    # every rank builds every mesh in the same order (new_group is collective)
    meshes = {k: make_mesh(*k) for k in keys}
    if "steps" in jobs:
        for i, (case, arch, shape, axes) in enumerate(STEP_CASES):
            _port_step(case, arch, meshes[(shape, axes)], out, unsharded=i % world == rank)
    if "one_rank" in jobs:
        for case, arch, shape, axes in ONE_RANK_CASES:
            mesh = meshes[(shape, axes)]
            if mesh is not None:
                _port_step(case, arch, mesh, out, unsharded=True)
    if "elastic" in jobs:
        _port_elastic_restore(meshes, out)
    if "trainer" in jobs:
        for case, arch, shape, axes in TRAINER_CASES:
            if meshes[(shape, axes)] is not None:
                _port_trainer(case, arch, meshes[(shape, axes)], out)
    if "compression" in jobs and meshes[((2,), ("pod",))] is not None:
        _port_compression(meshes[((2,), ("pod",))], out)


if __name__ == "__main__":
    reference_main(sys.argv[1], sys.argv[2])
