"""The port's six examples (``repro_torch.examples``) run on the CPU.

Each module's ``main`` runs with ``--device cpu`` at its reference
example's own sizes (``train_lm`` for 3 steps into a temporary checkpoint
directory).  ``quickstart`` and ``serve_sparql`` print what the
reference's ``examples/quickstart.py`` and ``examples/serve_sparql.py``
print, line for line, and ``materialise_kg`` too but for its timings;
``kg_dedup_gnn``'s graph lines (facts, merged entities, edges before and
after the dedup) equal the reference's, whose training is left out (the
two GatedGCN losses come from different initialisations).  The reference
runs in subprocesses (started when the module's first test asks, beside
the port's runs) with the jax 0.9 shim set inside.  The REW counts are the
engine's on the device, the reference's its numpy oracle's (quickstart,
materialise_kg) and its ``JaxEngine``'s (the store).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.examples import (kg_dedup_gnn, materialise_kg, quickstart, serve_lm,
                                  serve_sparql, train_lm)

ROOT = Path(__file__).resolve().parents[1]
SHIM = ("import jax, jax.experimental, jax.extend.core\n"
        "jax.experimental.enable_x64 = jax.enable_x64\n"
        "jax.core.Jaxpr = jax.extend.core.Jaxpr\n"
        "import runpy, sys\n"
        "sys.argv = [sys.argv[1]]\n"
        "main = runpy.run_path(sys.argv[0], run_name='reference')['main']\n"
        "if sys.argv[0].endswith('kg_dedup_gnn.py'):  # the graphs only\n"
        "    main.__globals__['train'] = lambda graph, steps=40: (0.0, 0.0)\n"
        "main()\n")
# a timing in a printed line: "0.05s", "4.1ms", "7.4x"
TIMING = re.compile(r"\d+\.\d+(s|ms|x)\b")


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference examples' standard output, by name (each a running
    subprocess until first read)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", SHIM, str(ROOT / "examples" / f"{name}.py")], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("quickstart", "serve_sparql", "materialise_kg", "kg_dedup_gnn")}
    outs = {}

    def get(name: str) -> str:
        if name not in outs:
            out, err = procs[name].communicate(timeout=300)
            assert procs[name].returncode == 0, err
            outs[name] = out
        return outs[name]

    yield get
    for p in procs.values():
        p.kill()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's runs on one intra-op thread: beside the other test
    workers, torch's default of a thread a core oversubscribes the host
    many times over and these small examples slow down 40x."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(main, capsys, *args) -> str:
    main(["--device", "cpu", *args])
    return capsys.readouterr().out


def test_materialise_kg(reference, capsys):
    out = _run(materialise_kg.main, capsys)
    assert "Theorem 1 validated (T^rho == AX materialisation)" in out
    assert "SPARQL over T (bag semantics): 8000 answers, 1000 distinct" in out
    assert TIMING.sub("T", out).splitlines() == \
        TIMING.sub("T", reference("materialise_kg")).splitlines()


def test_serve_lm(capsys):
    out = _run(serve_lm.main, capsys)
    assert out.startswith("12 requests, 192 tokens in ")


def test_train_lm(tmp_path, capsys):
    out = _run(train_lm.main, capsys, "--steps", "3", "--ckpt-dir", str(tmp_path))
    assert "batch 8 x seq 128, 3 steps" in out and "final loss " in out


def test_kg_dedup_gnn(reference, capsys):
    out = _run(kg_dedup_gnn.main, capsys)
    assert "KG: 6100 facts, 600 entities merged by rho" in out
    assert "dedup graph: 4891 edges (1209 removed)" in out
    assert out.count("gatedgcn 40 steps") == 2
    assert out.splitlines()[:3] == reference("kg_dedup_gnn").splitlines()[:3]


# the reference-comparing cases last: the reference runs beside the others
def test_quickstart_prints_the_reference_lines(reference, capsys):
    out = _run(quickstart.main, capsys)
    assert "   derivations: 11   (paper: 6)" in out  # 5 rule derivations, 6 reflexive
    assert "   triples (unmarked): 5" in out
    assert "|T^rho| = 21 == |AX| = 21: True" in out
    assert out.splitlines() == reference("quickstart").splitlines()


def test_serve_sparql_prints_the_reference_lines(reference, capsys):
    out = _run(serve_sparql.main, capsys)
    assert "mixed trace: queries answered at epochs" in out
    assert out.splitlines() == reference("serve_sparql").splitlines()
