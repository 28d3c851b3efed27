"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file, and the spans' stage marker
(``marks/span_mark.cu``), is compiled on its own into a shared library with
a plain C interface, ``build/kernels/<name>-<digest>.so`` under the
checkout, where the digest covers the source and the flags, so an edited
source or a changed flag rebuilds and an unchanged one is reused.  All
missing libraries are compiled at once, one ``nvcc`` process per source, at
first use.  Nothing is built or imported when the module is imported: the
CPU never needs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
MARKS = Path(__file__).resolve().parent / "marks"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# each library's source: the ported kernels, then every file of marks/
SOURCES = {
    **{name: CSRC / f"{name}.cu" for name in (
        "dedup_order", "search_bounds", "rewrite_triples", "union_find",
        "flash_attention", "fm_interact", "segment_sum", "embedding_bag")},
    **{path.stem: path for path in sorted(MARKS.glob("*.cu"))},
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(verbose: bool = False) -> dict:
    """Compile every kernel library that is missing, in parallel.

    Returns ``{"seconds": wall time, "built": [names], "ptxas": {name:
    text}}``; ``ptxas`` holds nvcc's register and spill report for each
    library built when ``verbose`` is set.  Raises with nvcc's output if any
    compilation fails.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _target(n).is_file()]
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed, ptxas = [], {}
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name].name}:\n{out}")
            continue
        os.replace(tmp, _target(name))
        ptxas[name] = out
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": todo, "ptxas": ptxas}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, building all on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _target(name).is_file():
                build_all()
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
