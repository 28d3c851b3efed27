"""The port stands alone: it imports torch and numpy, never jax and nothing
of the JAX package, and it never falls back to the CPU unasked."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MODULES = [
    "repro_torch", "repro_torch.core.engine", "repro_torch.core.uf",
    "repro_torch.core.rules", "repro_torch.core.terms",
    "repro_torch.core.triples", "repro_torch.core.stats",
    "repro_torch.core.fused", "repro_torch.core.axiom",
    "repro_torch.core.seminaive", "repro_torch.core.materialise",
    "repro_torch.core.incremental", "repro_torch.core.incremental_spmd",
    "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.kernels.merge", "repro_torch.kernels._build",
    "repro_torch.data.generator", "repro_torch.data.datasets",
    "repro_torch.device", "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.smollm_135m", "repro_torch.configs.fm",
    "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.transformer", "repro_torch.models.recsys",
    "repro_torch.serve", "repro_torch.serve.engine",
    "repro_torch.configs.gatedgcn", "repro_torch.configs.pna",
    "repro_torch.models.gnn", "repro_torch.models.gnn.common",
    "repro_torch.models.gnn.gatedgcn", "repro_torch.models.gnn.pna",
    "repro_torch.data.graphs", "repro_torch.sparql",
    "repro_torch.sparql.algebra", "repro_torch.sparql.executor",
    "repro_torch.sparql.batched", "repro_torch.serve.scheduler",
    "repro_torch.serve.triple_store", "repro_torch.configs.sameas_rew",
    "repro_torch.analysis", "repro_torch.analysis.passes",
    "repro_torch.analysis.fixtures", "repro_torch.analysis.__main__",
    "repro_torch.launch", "repro_torch.launch.mesh",
    "repro_torch.core.collectives", "repro_torch.models.moe",
    "repro_torch.configs.qwen3_moe_235b", "repro_torch.configs.deepseek_moe_16b",
    "repro_torch.configs.qwen2_1p5b", "repro_torch.configs.starcoder2_15b",
    "repro_torch.models.gnn.egnn", "repro_torch.models.gnn.dimenet",
    "repro_torch.configs.egnn", "repro_torch.configs.dimenet",
    "repro_torch.data.pipeline", "repro_torch.data.sampler",
    "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.compression",
    "repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
    "repro_torch.train", "repro_torch.train.loop",
    "repro_torch.launch.sharding", "repro_torch.launch.workloads",
    "repro_torch.compat", "repro_torch.launch.costs", "repro_torch.launch.dryrun",
    "repro_torch.launch.roofline", "repro_torch.launch.bufdump",
    "repro_torch.examples", "repro_torch.examples.quickstart",
    "repro_torch.examples.materialise_kg", "repro_torch.examples.serve_sparql",
    "repro_torch.examples.serve_lm", "repro_torch.examples.train_lm",
    "repro_torch.examples.kg_dedup_gnn",
    "chip_smoke",
]


def test_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)(\.|\s)(?!_torch))",
    re.M,
)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_jax_or_repro_import_in_source(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)


def test_engine_without_a_card_raises_unless_cpu_is_asked(monkeypatch):
    from repro_torch.core.engine import TorchEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TorchEngine(16)
    assert TorchEngine(16, device="cpu").device.type == "cpu"


def test_state_loader_has_no_default_device():
    from repro_torch.core.engine import state_from_arrays
    from repro_torch.core.rules import Program

    with pytest.raises(TypeError):
        state_from_arrays({}, Program([]), 0)  # the caller names the device


def test_serving_entry_points_without_a_card_raise_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys, transformer as lm
    from repro_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm_cfg, fm_cfg = get_arch("smollm-135m").reduced, get_arch("fm").reduced
    gen = torch.Generator().manual_seed(0)
    for init, cfg in ((lm.init_params, lm_cfg), (recsys.init_params, fm_cfg)):
        with pytest.raises(RuntimeError):
            init(gen, cfg)
    with pytest.raises(RuntimeError):
        lm.init_cache(lm_cfg, 1, 8)
    with pytest.raises(TypeError):
        lm.params_from_numpy({})  # the caller names the device
    with pytest.raises(TypeError):
        recsys.params_from_numpy({})
    params = lm.init_params(gen, lm_cfg, device="cpu")
    with pytest.raises(RuntimeError):
        ServeEngine(params, lm_cfg, n_slots=1, max_len=8)
    eng = ServeEngine(params, lm_cfg, n_slots=1, max_len=8, device="cpu")
    assert eng.device.type == "cpu" and eng.cache["k"].device.type == "cpu"
    fm_params = recsys.init_params(gen, fm_cfg, device="cpu")
    ids = torch.zeros((2, fm_cfg.n_fields), dtype=torch.int32)
    assert recsys.serve_step(fm_params, fm_cfg, {"ids": ids}).device.type == "cpu"


def test_gnn_entry_points_without_a_card_raise_unless_cpu_is_asked(monkeypatch):
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import dedup_graph, graph_to, random_graph
    from repro_torch.models.gnn import dimenet, egnn, gatedgcn, pna

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for mod, name in ((gatedgcn, "gatedgcn"), (pna, "pna"), (egnn, "egnn"),
                      (dimenet, "dimenet")):
        cfg = get_arch(name).reduced
        with pytest.raises(RuntimeError):
            mod.init_params(gen, cfg)
        leaf = torch.utils._pytree.tree_leaves(mod.init_params(gen, cfg, device="cpu"))[0]
        assert leaf.device.type == "cpu"
    graph = random_graph(np.random.default_rng(0), 8, 20, 4, 2)
    rho = np.arange(8, dtype=np.int32)
    with pytest.raises(RuntimeError):
        dedup_graph(graph, rho)
    with pytest.raises(RuntimeError):
        graph_to(graph, "cuda")
    assert dedup_graph(graph, rho, "cpu")["edge_index"].device.type == "cpu"


CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
LIBRARY_INCLUDE = re.compile(
    r'^\s*#\s*include\s*[<"]([^>"]*(cub/|thrust/|cublas|cudnn|gemm/device|'
    r'gemm/kernel|gemm/collective)[^>"]*)[>"]', re.M | re.I)
REPLACES = re.compile(r"Replaces:\s*(src/repro/kernels/\w+\.py),\s*(\w+)")


@pytest.mark.parametrize("name", sorted(p.name for p in CSRC.glob("*.cu")))
def test_kernel_source_is_hand_written(name):
    """Each kernel source includes no library's sort, GEMM or attention
    (CUB, Thrust, cuBLAS, cuDNN, a CUTLASS device, kernel or collective
    GEMM) and names the Pallas kernel's function that it replaces."""
    text = (CSRC / name).read_text()
    hit = LIBRARY_INCLUDE.search(text)
    assert hit is None, f"{name} includes {hit.group(1)}"
    found = REPLACES.search(text)
    assert found, f"{name} names no src/repro/kernels function that it replaces"
    path, fn = found.groups()
    assert re.search(rf"^def {fn}\(", (ROOT / path).read_text(), re.M), \
        f"{name}: {path} defines no {fn}"


def test_triple_store_without_a_card_raises_unless_cpu_is_asked(monkeypatch):
    from repro_torch.core.engine import TorchEngine
    from repro_torch.data.datasets import single_clique
    from repro_torch.serve import TripleStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    facts, prog, dic = single_clique(3)
    with pytest.raises(RuntimeError):
        TripleStore(facts, prog, dic)
    store = TripleStore(facts, prog, dic, device="cpu")
    assert store.engine.device.type == "cpu" and store.snapshot.d_keys.device.type == "cpu"
    with pytest.raises(ValueError):
        TripleStore(facts, prog, dic, device="cuda",
                    engine=TorchEngine(dic.n_resources, device="cpu"))


def test_audit_entry_points_without_a_card_raise_unless_cpu_is_asked(monkeypatch):
    from repro_torch.analysis import build_probe, run_report
    from repro_torch.analysis.fixtures import trace_fixture
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import TorchEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reduced = get_arch("sameas_rew").reduced
    for call in (lambda: build_probe("chain"), lambda: run_report("chain"),
                 lambda: trace_fixture("arena_sort"),
                 lambda: TorchEngine.from_config(reduced)):
        with pytest.raises(RuntimeError):
            call()
    assert TorchEngine.from_config(reduced, device="cpu").device.type == "cpu"
    assert trace_fixture("arena_sort", "cpu")[1]
