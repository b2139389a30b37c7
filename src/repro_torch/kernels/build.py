"""Build and load the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, into ``build/kernels`` at the root of the
checkout (listed in ``.gitignore``); the library's file name carries a
hash of its source and flags, so an edited source is rebuilt and a
current one is reused. Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C signature of every kernel library: (function name, argtypes)
SIGNATURES = {
    "clustered_agg": ("clustered_agg_f32", [_P, _P, _P, _I, _I, _LL, _I, _P]),
    "kmeans_assign": ("kmeans_assign_f32", [_P, _P, _P, _I, _I, _I, _P]),
    "mem_attention": ("mem_attention_f32",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "flash_decode": ("flash_decode_f32",
                     [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _P]),
}

_loaded: Dict[str, object] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns each compiled
    library's ptxas report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def kernel(name: str):
    """The C entry point of kernel library ``name``, built if needed."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            fname, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(path)), fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn
