"""Shared by the serving- and engine-cell differential (``tests/test_torch_serve_cells.py``).

Two sides run each case and write ``.npz`` files that the test compares:

* the reference: ``repro.launch.workloads.build_cell(...).step`` jitted
  with its in/out shardings under ``jax.set_mesh`` on 4 fake CPU devices,
  in one subprocess (``python tests/serve_dist_cases.py OUT``; ``XLA_FLAGS``
  gives it the devices before jax is imported, and the jax 0.9 shim is set
  before ``repro`` is), beside the same functions unsharded on one device
  (the gap between the two sets each comparison's tolerance);
* the port: ``repro_torch.launch.workloads.build_cell(...).step`` on 4
  gloo processes (:func:`run_port`), each rank on its blocks, and the
  port's unsharded functions.

The cases: an LM's prefill of ``LM_T`` tokens, then decode steps at
``DECODE_POS`` (across the boundary of the two model ranks' cache blocks;
each step overwrites the cache at its position and attends to the keys
before it); the FM's serve and retrieval (a candidate count that is not a
multiple of 512, padded as the reference pads it); one engine round at the
reduced caps on an arena of :func:`engine_triples` laid out by
:func:`repro_torch.launch.workloads.engine_arena`.  Both sides make every
input from the same numpy seed; this module imports neither jax nor
``repro`` at its top.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from train_dist_cases import _save, case_params

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
MESH = ((2, 2), ("data", "model"))
MESH1 = ((1, 1), ("data", "model"))
LM_ARCHS = ("smollm-135m", "qwen2-1.5b", "deepseek-moe-16b")  # split, whole heads, MoE
LM_B, LM_T = 4, 32
DECODE_POS = (LM_T // 2 - 2, LM_T // 2 - 1, LM_T // 2)  # the block boundary at T/2
FM_SERVE_B, FM_CANDIDATES = 64, 1000  # 1,000 candidates, padded to 1,024
ENGINE_DIMS = dict(capacity=256, n_resources=1024)


# -- the inputs ------------------------------------------------------------------

def lm_spec(pkg: str, arch: str):
    """``pkg``'s ArchSpec on its reduced config and the prefill and decode
    shapes of the cases."""
    cfgs = __import__(f"{pkg}.configs", fromlist=["get_arch"])
    base = __import__(f"{pkg}.configs.base", fromlist=["ShapeSpec"])
    spec = cfgs.get_arch(arch)
    spec = dataclasses.replace(spec, config=spec.reduced)
    dims = dict(global_batch=LM_B, seq_len=LM_T)
    return spec, base.ShapeSpec("prefill_small", "prefill", dims), \
        base.ShapeSpec("decode_small", "decode", dims)


def lm_config(spec):
    """The config the (data 2, model 2) cells run: an MoE's token chunks
    and axes set from the mesh, as ``build_lm_cell`` sets them."""
    cfg = spec.config
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, n_token_shards=2, dp_axes=("data",), ep_axis="model")
    return cfg


def lm_tokens(arch: str):
    """The prompt (B, T) and one new token a decode step (B, steps)."""
    spec, _, _ = lm_spec("repro_torch", arch)
    rng = np.random.default_rng(3 + sum(map(ord, arch)))
    tok = rng.integers(0, spec.config.vocab, (LM_B, LM_T + len(DECODE_POS))).astype(np.int32)
    return tok[:, :LM_T].copy(), tok[:, LM_T:].copy()


def fm_spec(pkg: str, kind: str):
    cfgs = __import__(f"{pkg}.configs", fromlist=["get_arch"])
    base = __import__(f"{pkg}.configs.base", fromlist=["ShapeSpec"])
    spec = cfgs.get_arch("fm")
    spec = dataclasses.replace(spec, config=spec.reduced)
    if kind == "serve":
        return spec, base.ShapeSpec("serve_small", "serve", dict(batch=FM_SERVE_B))
    return spec, base.ShapeSpec("retrieval_small", "retrieval",
                                dict(batch=1, n_candidates=FM_CANDIDATES))


def fm_inputs() -> dict:
    spec, _ = fm_spec("repro_torch", "serve")
    cfg = spec.config
    rng = np.random.default_rng(29)
    nc = (FM_CANDIDATES + 511) // 512 * 512
    cand = np.zeros(nc, np.int32)  # sentinel rows pad the candidates
    cand[:FM_CANDIDATES] = rng.integers(0, cfg.n_rows, FM_CANDIDATES)
    return dict(ids=rng.integers(0, cfg.rows_per_field, (FM_SERVE_B, cfg.n_fields)).astype(np.int32),
                user=rng.integers(0, cfg.rows_per_field, (1, cfg.n_fields)).astype(np.int32),
                cand=cand)


def engine_spec(pkg: str):
    cfgs = __import__(f"{pkg}.configs", fromlist=["get_arch"])
    base = __import__(f"{pkg}.configs.base", fromlist=["ShapeSpec"])
    spec = cfgs.get_arch("sameas_rew")
    return (dataclasses.replace(spec, config=spec.reduced),
            base.ShapeSpec("round_reduced", "engine", ENGINE_DIMS))


def engine_triples() -> np.ndarray:
    """Distinct rows over resources [16, 400): plain triples and a few
    sameAs rows (predicate 1), so that the round merges, sweeps and
    routes."""
    rng = np.random.default_rng(41)
    plain = np.stack([rng.integers(16, 400, 320), rng.integers(3, 12, 320),
                      rng.integers(16, 400, 320)], axis=1)
    pairs = rng.integers(16, 400, (24, 2))
    same = np.stack([pairs[:, 0], np.ones(24, np.int64), pairs[:, 1]], axis=1)
    return np.unique(np.concatenate([plain, same]), axis=0).astype(np.int32)


def engine_inputs(n_dev: int) -> tuple:
    """The arena over ``n_dev`` shards; on one shard, the rows that shard 0
    of four holds (the rest would overflow its capacity)."""
    from repro_torch.launch.workloads import engine_arena

    rows = engine_triples()
    if n_dev == 1:
        rows = rows[rows[:, 0] % 4 == 0]
    return engine_arena(rows, ENGINE_DIMS["n_resources"], ENGINE_DIMS["capacity"], n_dev)


ENGINE_OUT = ("spo", "epoch", "marked", "n_used", "rep", "sort_perm", "sorted_keys")


# -- the reference side ------------------------------------------------------------

def start_reference(out: Path) -> subprocess.Popen:
    """Every reference case on 4 fake devices, in one subprocess."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           env.get("PYTHONPATH", "")]))
    log = open(out / "ref.log", "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(out)],
                            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    proc.log, proc.log_path = log, out / "ref.log"
    return proc


def _jax_tree(tree):
    import jax.numpy as jnp
    from torch.utils import _pytree as pytree

    return pytree.tree_map(jnp.asarray, tree)


def _meshes():
    import jax

    from repro.compat import make_mesh

    return (make_mesh(*MESH, devices=jax.devices()[:4]),
            make_mesh(*MESH1, devices=jax.devices()[:1]))


def _ref_lm(arch: str, out: Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.launch.workloads import build_cell
    from repro.models import transformer as jlm

    spec, pshape, dshape = lm_spec("repro", arch)
    mesh, mesh1 = _meshes()
    params = _jax_tree(case_params(arch))
    prompt, new = lm_tokens(arch)
    res = {}
    with jax.set_mesh(mesh):
        pc, dc = build_cell(spec, pshape, mesh), build_cell(spec, dshape, mesh)
        p, tok = jax.device_put((params, prompt), pc.in_shardings)
        logits, cache = jax.jit(pc.step, in_shardings=pc.in_shardings,
                                out_shardings=pc.out_shardings)(p, tok)
        res["pre"] = np.asarray(logits)
        step = jax.jit(dc.step, in_shardings=dc.in_shardings, out_shardings=dc.out_shardings)
        for i, pos in enumerate(DECODE_POS):
            t = jax.device_put(new[:, i], dc.in_shardings[2])
            logits, cache = step(p, cache, t, jnp.int32(pos))
            res[f"dec{i}"] = np.asarray(logits)
        res["k"], res["v"] = np.asarray(cache["k"]), np.asarray(cache["v"])
    # the same functions unsharded (one device), on the cells' config
    cfg = lm_config(spec)
    with jax.set_mesh(mesh1):
        logits, cache = jax.jit(lambda p, t: jlm.prefill(p, cfg, t))(params, prompt)
        res["u_pre"] = np.asarray(logits)
        step = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, cfg, c, t, pos))
        for i, pos in enumerate(DECODE_POS):
            logits, cache = step(params, cache, new[:, i], jnp.int32(pos))
            res[f"u_dec{i}"] = np.asarray(logits)
        res["u_k"], res["u_v"] = np.asarray(cache["k"]), np.asarray(cache["v"])
    _save(out / f"lm-{arch}.npz", **{k: v.astype(np.float32) for k, v in res.items()})


def _ref_fm(out: Path) -> None:
    import jax

    from repro.launch.workloads import build_cell

    res = {}
    fm = fm_inputs()
    for tag, m in zip(("", "u_"), _meshes()):
        with jax.set_mesh(m):
            spec, shape = fm_spec("repro", "serve")
            params = _jax_tree(case_params("fm"))
            cell = build_cell(spec, shape, m)
            args = jax.device_put((params, {"ids": fm["ids"]}), cell.in_shardings)
            res[f"{tag}serve"] = np.asarray(jax.jit(cell.step, in_shardings=cell.in_shardings,
                                                    out_shardings=cell.out_shardings)(*args))
            spec, shape = fm_spec("repro", "retrieval")
            cell = build_cell(spec, shape, m)
            args = jax.device_put((params, fm["user"], fm["cand"]), cell.in_shardings)
            res[f"{tag}retrieval"] = np.asarray(jax.jit(
                cell.step, in_shardings=cell.in_shardings,
                out_shardings=cell.out_shardings)(*args))
    _save(out / "fm.npz", **res)


def _ref_engine(out: Path) -> None:
    """The round's every output, per device (its coordinate's rank)."""
    import jax

    from repro.launch.workloads import build_cell

    spec, shape = engine_spec("repro")
    mesh, _ = _meshes()
    res = {}
    # packed keys are int64: the reference's engine runs its rounds in x64
    with jax.enable_x64(True), jax.set_mesh(mesh):
        cell = build_cell(spec, shape, mesh)
        args = jax.device_put(engine_inputs(4), cell.in_shardings)
        outs = jax.jit(cell.step, in_shardings=cell.in_shardings)(*args)
    named = dict(zip(ENGINE_OUT, outs[:-1]), **outs[-1])
    devs = mesh.devices
    for name, arr in named.items():
        for sh in arr.addressable_shards:
            c = np.argwhere(devs == sh.device)[0]
            res[f"{name}:{int(c[0]) * devs.shape[1] + int(c[1])}"] = np.asarray(sh.data)
    _save(out / "engine.npz", **res)


def reference_main(out: str) -> None:
    import jax
    import jax.experimental
    import jax.extend.core

    # jax 0.9 moved these; the reference package imports them by their old names
    jax.experimental.enable_x64 = jax.enable_x64
    jax.core.Jaxpr = jax.extend.core.Jaxpr
    out = Path(out)
    for name, fn in [(a, lambda a=a: _ref_lm(a, out)) for a in LM_ARCHS] + [
            ("fm", lambda: _ref_fm(out)), ("engine", lambda: _ref_engine(out))]:
        t0 = time.perf_counter()
        fn()
        print(name, f"{time.perf_counter() - t0:.1f}s", flush=True)


# -- the port side ---------------------------------------------------------------------

def run_port(out: Path, world: int = 4) -> None:
    """The port's cases in ``world`` gloo processes."""
    from repro_torch.launch.mesh import spawn

    out.mkdir(parents=True, exist_ok=True)
    spawn(port_main, world, (str(out),), store_path=str(out / "store"), threads=1,
          timeout_s=300)


def _f32(t) -> np.ndarray:
    return t.detach().float().numpy()


def _port_lm(arch: str, mesh, out: Path, unsharded: bool) -> None:
    import torch

    from repro_torch.launch.sharding import gather, gather_tree, place
    from repro_torch.launch.workloads import build_cell
    from repro_torch.models import transformer as lm

    spec, pshape, dshape = lm_spec("repro_torch", arch)
    prompt, new = lm_tokens(arch)
    params_np = case_params(arch)
    pc, dc = build_cell(spec, pshape, mesh), build_cell(spec, dshape, mesh)
    params = place(params_np, pc.in_shardings[0], "cpu")
    res = {}
    logits, cache = pc.step(params, place(prompt, pc.in_shardings[1], "cpu"))
    res["pre"] = _f32(gather(logits, pc.out_shardings[0]))
    for i, pos in enumerate(DECODE_POS):
        logits, cache = dc.step(params, cache, place(new[:, i], dc.in_shardings[2], "cpu"),
                                pos)
        res[f"dec{i}"] = _f32(gather(logits, dc.out_shardings[0]))
    whole = gather_tree(cache, dc.out_shardings[1])
    res["k"], res["v"] = _f32(whole["k"]), _f32(whole["v"])
    tag = "d2m2" if mesh.size > 1 else "d1m1"
    if mesh.rank == 0:
        _save(out / f"lm-{arch}-{tag}.npz", **res)
    if unsharded:  # the port's functions unsharded, on the cells' config
        from repro_torch.compat import pytree
        from repro_torch.launch.sharding import _to_tensor

        cfg = lm_config(spec) if mesh.size > 1 else spec.config
        params = pytree.tree_map(lambda a: _to_tensor(a, "cpu"), params_np)
        res = {}
        logits, cache = lm.prefill(params, cfg, torch.from_numpy(prompt))
        res["pre"] = _f32(logits)
        for i, pos in enumerate(DECODE_POS):
            logits, cache = lm.decode_step(params, cfg, cache, torch.from_numpy(new[:, i]), pos)
            res[f"dec{i}"] = _f32(logits)
        res["k"], res["v"] = _f32(cache["k"]), _f32(cache["v"])
        _save(out / f"lm-{arch}-{tag}-un.npz", **res)


def _port_fm(mesh, out: Path, unsharded: bool) -> None:
    import torch

    from repro_torch.compat import pytree
    from repro_torch.launch.sharding import _to_tensor, gather, place
    from repro_torch.launch.workloads import build_cell
    from repro_torch.models import recsys

    fm = fm_inputs()
    params_np = case_params("fm")
    res = {}
    spec, shape = fm_spec("repro_torch", "serve")
    cell = build_cell(spec, shape, mesh)
    got = cell.step(place(params_np, cell.in_shardings[0], "cpu"),
                    place({"ids": fm["ids"]}, cell.in_shardings[1], "cpu"))
    res["serve"] = gather(got, cell.out_shardings).numpy()
    spec, shape = fm_spec("repro_torch", "retrieval")
    cell = build_cell(spec, shape, mesh)
    got = cell.step(place(params_np, cell.in_shardings[0], "cpu"), torch.from_numpy(fm["user"]),
                    place(fm["cand"], cell.in_shardings[2], "cpu"))
    res["retrieval"] = gather(got, cell.out_shardings).numpy()
    tag = "d2m2" if mesh.size > 1 else "d1m1"
    if mesh.rank == 0:
        _save(out / f"fm-{tag}.npz", **res)
    if unsharded:
        params = pytree.tree_map(lambda a: _to_tensor(a, "cpu"), params_np)
        cfg = spec.config
        _save(out / f"fm-{tag}-un.npz",
              serve=recsys.serve_step(params, cfg, {"ids": torch.from_numpy(fm["ids"])}).numpy(),
              retrieval=recsys.retrieval_scores(params, cfg, torch.from_numpy(fm["user"]),
                                                torch.from_numpy(fm["cand"])).numpy())


def _port_engine(mesh, out: Path, unsharded: bool) -> None:
    """Each rank's outputs of the round (and, at one rank, the port's
    unsharded functions on the same arena)."""
    from repro_torch.launch.sharding import _to_tensor, local_block
    from repro_torch.launch.workloads import build_cell, engine_rule

    spec, shape = engine_spec("repro_torch")
    cell = build_cell(spec, shape, mesh)
    arena = engine_inputs(mesh.size)
    args = [_to_tensor(local_block(a, sh), "cpu") for a, sh in zip(arena, cell.in_shardings)]
    outs = cell.step(*args)
    named = dict(zip(ENGINE_OUT, outs[:-1]), **outs[-1])
    tag = "d2m2" if mesh.size > 1 else "d1m1"
    _save(out / f"engine-{tag}.r{mesh.rank}.npz", **{k: v.numpy() for k, v in named.items()})
    if unsharded:
        from repro_torch.core.engine import eval_plan, process_candidates

        cfg = spec.config
        _, plan, slots = engine_rule()
        a = [_to_tensor(x, "cpu") for x in arena]
        heads, valid, *_ = eval_plan(a[0], a[1], a[2], a[7], a[6], a[10], a[8], a[9],
                                     plan=plan, head_var_slots=slots, bind_cap=cfg.bind_cap,
                                     out_cap=cfg.out_cap, tomb=a[3])
        outs = process_candidates(a[0], a[1], a[2], a[4], a[5], a[6], a[7], heads, valid, a[10],
                                  rewrite_cap=cfg.rewrite_cap, route_cap=cfg.route_cap)
        named = dict(zip(ENGINE_OUT, outs[:-1]), **outs[-1])
        _save(out / f"engine-{tag}-un.npz", **{k: v.numpy() for k, v in named.items()})


def port_main(rank: int, world: int, out: str) -> None:
    from repro_torch.launch.mesh import make_mesh

    out = Path(out)
    meshes = [make_mesh(*MESH), make_mesh(*MESH1)]  # every rank, in order (collective)
    for i, arch in enumerate(LM_ARCHS):
        _port_lm(arch, meshes[0], out, unsharded=i % world == rank)
    _port_fm(meshes[0], out, unsharded=rank == world - 1)
    _port_engine(meshes[0], out, unsharded=False)
    if meshes[1] is not None:
        for arch in LM_ARCHS:
            _port_lm(arch, meshes[1], out, unsharded=True)
        _port_fm(meshes[1], out, unsharded=True)
        _port_engine(meshes[1], out, unsharded=True)


if __name__ == "__main__":
    reference_main(sys.argv[1])
