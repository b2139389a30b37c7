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
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ULL = ctypes.c_ulonglong
# the C entry points of every kernel library, {function name: argtypes};
# each returns a CUDA error code (0: success)
SIGNATURES = {
    "clustered_agg": {"clustered_agg_f32":
                      [_P, _P, _P, _I, _I, _LL, _LL, _LL, _I, _P]},
    "kmeans_assign": {"kmeans_assign_f32":
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "mem_attention": {"mem_attention_f32":
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "flash_decode": {"flash_decode_f32":
                     [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _P]},
    "shared_allreduce": {
        "sar_alloc": [_I, _LL, _P],
        "sar_free": [_I, _P],
        "sar_ipc_handle": [_P, _P],
        "sar_ipc_open": [_I, _P, _P],
        "sar_ipc_close": [_I, _P],
        "sar_all_reduce_f32": [_P, _LL, _P, _P, _P, _P, _I, _I, _I, _LL,
                               _I, _ULL, _I, _P]},
}

_loaded: Dict[str, Dict[str, object]] = {}
_lock = threading.Lock()

# (device index, stream) -> (int32 ticket counters, float32 workspace) of
# the kernels that combine their splits in the launch (K2, K4). Each such
# kernel leaves its counters at 0 and reads only the workspace its own
# launch wrote, and kernels queued on one stream run one after another,
# so the kernels of one stream share both.
scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_scratch(device: torch.device, stream: int, n_counters: int,
                  n_floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """At least ``n_counters`` zeroed int32 ticket counters and an
    ``n_floats`` float32 workspace for ``stream`` on ``device``, allocated
    once and grown as needed."""
    key = (device.index, stream)
    cnt, ws = scratch.get(key, (None, None))
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros(n_counters, dtype=torch.int32, device=device)
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(n_floats, dtype=torch.float32, device=device)
    scratch[key] = (cnt, ws)
    return cnt, ws


def library(name: str) -> Dict[str, object]:
    """The C entry points of kernel library ``name``, by function name,
    built if needed."""
    with _lock:
        fns = _loaded.get(name)
        if fns is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            fns = {}
            for fname, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[fname] = fn
            _loaded[name] = fns
        return fns


def kernel(name: str):
    """The C entry point of kernel library ``name``, which has one."""
    fn, = library(name).values()
    return fn
