"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``build/lib<name>.so``
beside this module (``build/`` is git-ignored): a plain C interface, no
PyTorch headers, so a build takes seconds.  Sources build at first use,
all stale ones in parallel; a library is rebuilt when a source is newer.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_attention", "paged_decode", "ssd_scan")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime
                 for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every stale source among ``names``, one ``nvcc`` each, all
    started together.  Returns seconds spent per name (0.0 when the
    library was current).  The compiler's output, register and shared
    memory use included (``-Xptxas -v``), lands in ``build/<name>.log``."""
    names = list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD / f"lib{name}.so.tmp"
        cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = open(BUILD / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log, tmp)
    out = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp) in procs.items():
        rc = proc.wait()
        log.close()
        out[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        msgs = "\n".join(f"--- {n}\n{(BUILD / f'{n}.log').read_text()}"
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
