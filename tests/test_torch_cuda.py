"""The hand-written kernels and the engine on the card: each kernel equals
its plain version on the same CUDA tensors, and a run on the card equals
the run on the CPU.  Needs an NVIDIA card with nvcc; skipped elsewhere.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.engine import TorchEngine
from repro_torch.core.triples import pack
from repro_torch.data.generator import PROFILES, generate
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda
KEY_MAX = (1 << 63) - 1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(a, b):
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("n", [1, 2047, 2049, 100_003])
def test_dedup_order(dev, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(0, 1 << 40, n)).to(dev)
    keys[rng.integers(0, n, n // 3)] = 7
    keys[-max(n // 8, 1):] = KEY_MAX
    before = ops.LAUNCHES["dedup_order"]
    _same([ops.dedup_order(keys)], [ref.dedup_order(keys)])
    assert ops.LAUNCHES["dedup_order"] == before + 1


def test_search_and_prefix(dev):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, (5000, 3))
    keys = torch.from_numpy(np.sort((ids[:, 0] << 42) | (ids[:, 1] << 21) | ids[:, 2])).to(dev)
    queries = keys[torch.from_numpy(rng.integers(0, 5000, 3000)).to(dev)].contiguous()
    _same(ops.search_bounds(queries, keys), ref.search_bounds(queries, keys))
    for k in (1, 2, 3):
        prefix = torch.from_numpy(rng.integers(0, 52, (3000, k)).astype(np.int32)).to(dev)
        _same(ops.prefix_range_bounds(prefix, keys), ref.prefix_range_bounds(prefix, keys))


def test_rewrite_triples(dev):
    rng = np.random.default_rng(2)
    n, v = 10_000, 4096
    spo = torch.from_numpy(rng.integers(0, v, (n, 3)).astype(np.int32)).to(dev)
    rho = torch.from_numpy((np.arange(v) // 4 * 4).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    epoch = torch.from_numpy(rng.integers(-1, 3, n).astype(np.int32)).to(dev)
    marked = torch.from_numpy(rng.random(n) < 0.2).to(dev)
    for kw in ({}, {"valid": valid}, {"epoch": epoch, "marked": marked}):
        _same(ops.rewrite_triples(spo, rho, **kw), ref.rewrite_triples(spo, rho, **kw))


@pytest.mark.parametrize("shape", ["random_links", "permuted_chain"])
def test_union_find(dev, shape):
    """Merge loops on the card equal the plain version: random (x, x+1)
    links, and one chain through a random permutation of all resources
    (hooks land in no sequential order, so the compressing walks race)."""
    rng = np.random.default_rng(3)
    v, m = 50_000, 40_000
    if shape == "random_links":
        x = rng.integers(0, v - 1, m).astype(np.int32)
        pairs = np.stack([x, x + 1], axis=1)
    else:
        perm = rng.permutation(v).astype(np.int32)
        pairs = np.stack([perm[:-1], perm[1:]], axis=1)
        m = pairs.shape[0]
    out = []
    for mod in (ops, ref):
        rep = torch.arange(v, dtype=torch.int32, device=dev)
        a = torch.from_numpy(pairs[:, 0].copy()).to(dev)
        b = torch.from_numpy(pairs[:, 1].copy()).to(dev)
        valid = torch.ones(m, dtype=torch.bool, device=dev)
        while int(mod.uf_hook_(rep, a, b, valid)):
            mod.uf_compress_(rep)
        out.append(rep)
    _same(out[:1], out[1:])
    if shape == "permuted_chain":  # one clique; its minimum is resource 0
        assert int(out[0].max()) == 0


@pytest.mark.parametrize("name", ["opencyc_like", "merge_like", "uobm_like"])
def test_engine_on_card_equals_cpu(dev, name):
    facts, program, dic = generate(**PROFILES[name])
    results = [TorchEngine(dic.n_resources, device=d).materialise(facts, program)
               for d in (dev, "cpu")]
    (spo, rep, stats), (cspo, crep, cstats) = results
    np.testing.assert_array_equal(np.sort(pack(spo)), np.sort(pack(cspo)))
    np.testing.assert_array_equal(rep, crep)
    assert stats.as_dict() | {"wall_seconds": 0} == cstats.as_dict() | {"wall_seconds": 0}
