"""Builds of edited CUDA sources and their device times, for the A/B tools
(``tools/decode_variants.py``, ``tools/ssd_tc.py``).

``build`` compiles one source text per name with nvcc, all at once, into
``src/repro_torch/kernels/build/variants/`` and loads each as a ctypes
library; ``edit`` makes such a text from a kept source; ``ms_by_kernel``
times a call's kernels by name with torch.profiler, as chip_smoke.py
times the port's kernels.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from typing import Dict, Mapping


def edit(text: str, subs: Mapping, name: str = "") -> str:
    """``text`` with some lines replaced.  ``subs`` maps a constant to its
    new value (``constexpr int NAME = value;``), or any key to a list of
    ``(pattern, replacement[, count])``, where count says how often the
    pattern must occur (1 if not given)."""
    for const, value in subs.items():
        pairs = value if isinstance(value, list) else [
            (rf"constexpr int {const} = [^;]+;",
             f"constexpr int {const} = {value};")]
        for pattern, repl, *count in pairs:
            text, n = re.subn(pattern, repl, text)
            if n != (count[0] if count else 1):
                raise RuntimeError(f"{name}: {pattern!r} found {n} times")
    return text


def build(texts: Mapping[str, str], prefix: str) -> Dict[str, ctypes.CDLL]:
    """Compile each ``texts[name]`` into ``lib<prefix>_<name>.so`` beside
    the port's kernels (their headers on the include path), one nvcc each,
    all started together; the compiler's report (``-Xptxas -v``) lands in
    ``<prefix>_<name>.log``.  Raises on the first failed build."""
    from repro_torch.kernels import _build
    out = _build.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out / f"{prefix}_{name}.cu"
        cu.write_text(text)
        so = out / f"lib{prefix}_{name}.so"
        log = open(out / f"{prefix}_{name}.log", "w")
        cmd = [_build._nvcc(), _build.ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
               str(_build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log, so)
    libs = {}
    for name, (proc, log, so) in procs.items():
        rc = proc.wait()
        log.close()
        if rc:
            text = (out / f"{prefix}_{name}.log").read_text()
            raise RuntimeError(f"nvcc failed for {prefix}_{name}: "
                               f"{text[-4000:]}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def log_of(prefix: str, name: str) -> str:
    """The compiler's report of one build."""
    from repro_torch.kernels import _build
    return (_build.BUILD / "variants" / f"{prefix}_{name}.log").read_text()


def ms_by_kernel(fn, pattern: str, reps: int = 20) -> dict:
    """Device ms per call of ``fn`` of each kernel whose name matches
    ``pattern`` (torch.profiler), keyed by the match."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        m = re.search(pattern, ev.key)
        if m and us:
            out[m.group(0)] = out.get(m.group(0), 0.0) + us / reps / 1e3
    return out


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()

