"""Build and bind the CUDA kernels in ``lia_tpu_torch/csrc``.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
header is included, so a build takes seconds). All sources build in parallel,
one ``nvcc`` process each, at the first call of :func:`library` or
:func:`build_all`. A library's file name carries a hash of its source, the
shared headers and the flags, so an edited source rebuilds and an unchanged one
is loaded as it is. The libraries go to ``lia_tpu_torch/_build/`` (listed in
``.gitignore``). A failed build raises :class:`BuildError` with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry point and argument types of each library. Every pointer, and the
# stream, is a c_void_p: ctypes would pass a bare Python int as a 32-bit int.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "flash_prefill": {
        "lia_flash_prefill": [P, P, P, P, P, I, I, I, I, I, F, I, P],
    },
    "decode": {
        "lia_decode": [P, P, P, P, P, I, P, I, I, I, I, I, F, I, P],
    },
    "decode_fresh": {
        "lia_decode_fresh": [P, P, P, P, P, P, P, I, P, I, I, I, I, I, F, I, P],
    },
    "decode_fresh_int8": {
        "lia_decode_fresh_int8": [P, P, P, P, P, P, P, P, P, I, P, I, I, I, I, I, F, I, P],
    },
    "w4a8_matmul": {
        "lia_w4a8_matmul": [P, P, P, P, P, P, P, I, I, I, I, I, P],
    },
    "woq_matmul": {
        "lia_woq_matmul": [P, P, P, P, P, P, I, I, I, I, I, I, P],
    },
}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (looked on PATH and under $CUDA_HOME/bin)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(nvcc: str, name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all() -> Dict[str, Path]:
    """Compile every missing library in parallel; return name → library path.

    nvcc's output (with ``-Xptxas -v``: registers, shared memory and spills per
    kernel) is kept beside each library as ``<library>.log``."""
    paths = {n: _lib_path(n) for n in SIGNATURES}
    todo = [n for n, p in paths.items() if not p.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {n: _start(nvcc, n, paths[n]) for n in todo}
        errors = []
        for n, proc in procs.items():
            log, _ = proc.communicate()
            out = paths[n]
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            out.with_name(out.name + ".log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if errors:
            raise BuildError("kernel build failed:\n" + "\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building every source first if needed)."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            lib = ctypes.CDLL(str(paths[name]))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]
