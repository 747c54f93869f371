"""The traced run's device trace: ``torch.profiler`` (device activity)
over a sub-window of the measured window, started and stopped between
two of the pump's events, and its reduction to kernel time by group, the union of kernel
intervals (the card's busy time), idle gaps labelled by what the pump was
dispatching, and, beside the trace, CUDA events around each call of the
port's kernels (a cross-check of the profiler's kernel time)."""

from __future__ import annotations

import re
from typing import Dict, List, Optional

# the port's kernels by symbol: K2/K3 are attn_tc_kernel / attn_simt_kernel
# <head_dim, paged>, K1's split and merge kernels carry "decode_", K5's
# "ssd_" (the grouping of chip_smoke.py's profile phase)
_ATTN = re.compile(r"attn_(tc|simt)_kernel<\d+, (true|false)\b")
GEMM_TAGS = ("gemm", "nvjet", "sm90_", "cutlass")
# the port's kernel entries in repro_torch.kernels.ops, by group
ENTRIES = {"K3": "flash_attention", "K2": "paged_flash_prefill",
           "K1": "paged_flash_decode", "K5": "ssd_scan"}


def kernel_group(name: str) -> str:
    m = _ATTN.search(name)
    if m:
        return "K2" if m.group(2) == "true" else "K3"
    if "decode_" in name:
        return "K1"
    if "ssd_" in name:
        return "K5"
    if any(t in name.lower() for t in GEMM_TAGS):
        return "gemm"
    return "other"


class DeviceTrace:
    """Profile ``[start_s, start_s + seconds)`` of the window: ``on_step``
    is the pump's hook between events (window seconds)."""

    def __init__(self, start_s: float, seconds: float, clock):
        self.start_s, self.seconds = start_s, seconds
        self.clock = clock
        self.prof = None
        self.t_on = self.t_off = None        # window seconds
        self.start_cost_s = self.stop_cost_s = 0.0
        self.mark_host = None                # window seconds of the mark
        self.calls: Dict[str, List] = {g: [] for g in ENTRIES}
        self._saved = {}

    def on_step(self, now: float) -> None:
        if self.prof is None and now >= self.start_s:
            self._start(now)
        elif (self.prof is not None and self.t_off is None
              and now >= self.start_s + self.seconds):
            self.stop(now)

    @staticmethod
    def warm() -> None:
        """Start and stop a profiler once in set-up: the first start
        initialises the device tracing, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def _start(self, now: float) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        mark = torch.ones(1, device="cuda")
        torch.cuda.synchronize()
        self._wrap_kernels()
        # device activity only: a tick launches some 2,000 kernels, and
        # the profiler's stop parses every event it recorded
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        # the sub-window opens once the profiler runs; the card is idle,
        # so the first kernel it records is the mark, launched now
        self.t_on = self.mark_host = self.clock()
        mark.add_(1)
        self.start_cost_s = self.t_on - now

    def stop(self, now: float) -> None:
        import torch
        if self.prof is None or self.t_off is not None:
            return
        torch.cuda.synchronize()
        self.t_off = self.clock()
        self.prof.stop()
        self.stop_cost_s = self.clock() - self.t_off
        self._unwrap_kernels()

    # ------------------------------------------- CUDA events around calls
    def _wrap_kernels(self) -> None:
        import torch
        from repro_torch.kernels import ops
        for g, name in ENTRIES.items():
            fn = getattr(ops, name)
            self._saved[name] = fn

            def timed(*a, _fn=fn, _g=g, **k):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = _fn(*a, **k)
                e.record()
                self.calls[_g].append((s, e))
                return out
            setattr(ops, name, timed)

    def _unwrap_kernels(self) -> None:
        from repro_torch.kernels import ops
        for name, fn in self._saved.items():
            setattr(ops, name, fn)
        self._saved = {}

    def event_ms(self) -> Dict[str, float]:
        """Summed CUDA-event ms of each group's calls in the sub-window."""
        return {g: sum(s.elapsed_time(e) for s, e in v)
                for g, v in self.calls.items() if v}

    # -------------------------------------------------------- reduction
    def reduce(self, events: List[tuple]) -> Optional[dict]:
        """Kernel seconds by group and by name, busy seconds (the union
        of kernel intervals), the sub-window's seconds, and idle seconds
        by the kind of event the pump was dispatching (``events``:
        (kind, start, end) window seconds; "between" outside any)."""
        if self.prof is None or self.t_off is None:
            return None
        evs = [e for e in self.prof.events()
               if e.device_type.name == "CUDA" and e.time_range.end > 0]
        if len(evs) < 2:
            return None
        evs.sort(key=lambda e: e.time_range.start)
        base = evs[0].time_range.start          # the mark
        ivs, by_group, by_name, count = [], {}, {}, {}
        for e in evs[1:]:
            a = self.mark_host + (e.time_range.start - base) / 1e6
            b = self.mark_host + (e.time_range.end - base) / 1e6
            if b <= a:
                continue
            ivs.append((a, b))
            g = kernel_group(e.name)
            by_group[g] = by_group.get(g, 0.0) + (b - a)
            count[g] = count.get(g, 0) + 1
            key = g if g in ENTRIES else e.name[:60]
            by_name[key] = by_name.get(key, 0.0) + (b - a)
        if not ivs:
            return None
        ivs.sort()
        busy, gaps = 0.0, []
        cur_a, cur_b = ivs[0]
        prev_end = self.t_on
        for a, b in ivs[1:] + [(float("inf"), float("inf"))]:
            if a > cur_b:
                busy += cur_b - cur_a
                gaps.append((prev_end, cur_a))
                prev_end = cur_b
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        gaps.append((prev_end, self.t_off))
        idle: Dict[str, float] = {}
        spans = sorted(events, key=lambda x: x[1])
        for a, b in gaps:
            a, b = max(a, self.t_on), min(b, self.t_off)
            if b <= a:
                continue
            # split the gap over the events it overlaps
            left = b - a
            for kind, s, t in spans:
                if t <= a or s >= b:
                    continue
                ov = min(b, t) - max(a, s)
                idle[kind] = idle.get(kind, 0.0) + ov
                left -= ov
            if left > 0:
                idle["between"] = idle.get("between", 0.0) + left
        return {"window_s": self.t_off - self.t_on, "busy_s": busy,
                "group_s": by_group, "group_calls": count,
                "name_s": by_name, "idle_s": idle,
                "event_ms": self.event_ms(),
                "start_cost_s": self.start_cost_s,
                "stop_cost_s": self.stop_cost_s}


def breakdown(red: dict) -> dict:
    top = sorted(red["name_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(red["idle_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}

