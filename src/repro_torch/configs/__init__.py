"""Architecture registry of the port: ``get_arch(name)`` returns the
ArchSpec of a ported architecture; ``all_archs()`` lists the reference's
architectures in its order (plus ``sameas_rew``, the paper's own engine
workload).

The port carries all eleven; any other name raises ``KeyError``.
"""

from __future__ import annotations

import importlib

from .base import ArchSpec

_ARCH_MODULES = [
    "qwen3_moe_235b",
    "deepseek_moe_16b",
    "qwen2_1p5b",
    "smollm_135m",
    "starcoder2_15b",
    "dimenet",
    "egnn",
    "gatedgcn",
    "pna",
    "fm",
    "sameas_rew",
]
_ALIASES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-1.5b": "qwen2_1p5b",
    "smollm-135m": "smollm_135m",
    "starcoder2-15b": "starcoder2_15b",
}


def get_arch(name: str) -> ArchSpec:
    module = _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if module not in _ARCH_MODULES:
        raise KeyError(f"{name!r}: the reference has no such arch")
    return importlib.import_module(f"repro_torch.configs.{module}").SPEC


def all_archs() -> list[str]:
    return list(_ARCH_MODULES)
