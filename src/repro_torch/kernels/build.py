"""Build and load the port's CUDA kernels at first use.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C entry
point (no PyTorch headers).  ``nvcc`` compiles it for Hopper (``sm_90a``)
into a shared library under ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source and the flags, and
``ctypes`` loads it.  Nothing is compiled at import, so the package imports
on machines without ``nvcc``.  A library may also be built from CUDA text
that has no file under ``csrc/`` (a variant of a kernel, such as the planted
fault ``chip_smoke.py`` checks its comparison against); the text is written
beside the library and compiled the same way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# Every kernel of the port, by the name of its source under ``csrc/``.
KERNELS = ("paged_attention", "moe_ffn", "rwkv6_scan", "mamba_scan")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": nvcc wall time (0.0 when the library was already
# built), "log": nvcc's stderr, which holds the -Xptxas -v report}
build_log: Dict[str, dict] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "compiled at first use and need the CUDA toolkit")


def _source(name: str, text: Optional[str]) -> bytes:
    return text.encode() if text is not None else (
        CSRC / f"{name}.cu").read_bytes()


def _target(name: str, src: bytes) -> Path:
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str],
              sources: Optional[Mapping[str, str]] = None) -> None:
    """Compile every listed kernel not yet built, all nvcc processes
    started together, and record each one's time and ptxas report.
    `sources` maps a name to its CUDA text where it has no file under
    ``csrc/``."""
    sources = sources or {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    for name in names:
        src = _source(name, sources.get(name))
        out = _target(name, src)
        log = out.with_suffix(".log")
        if out.exists():
            build_log[name] = {"seconds": 0.0,
                               "log": log.read_text() if log.exists() else ""}
            continue
        cu = CSRC / f"{name}.cu"
        if name in sources:
            cu = out.with_suffix(".cu")
            cu.write_bytes(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(cu)]
        procs.append((name, out, tmp, log, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, log, t0, proc in procs:
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, out)
        build_log[name] = {"seconds": seconds, "log": text}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str, source: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed from
    ``csrc/<name>.cu``, or from the CUDA text `source` when given."""
    lib = _libs.get(name)
    if lib is None:
        out = _target(name, _source(name, source))
        if not out.exists():
            build_all([name], {name: source} if source is not None else None)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
    return lib
