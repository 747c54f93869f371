"""Execution context for the single-device port.

The reference ``ExecContext`` names mesh axes for GSPMD sharding; this slice
of the port runs on one device, so the context carries only what the model
and the serving engine read: the device, the kernel choice (``impl``), the
runtime window override, the MoE dispatch strategy, the two sliding-window
decode branches (``window_slice``, ``ring_cache``), and the paged-pool
queries, which all answer "unsharded" (``mesh`` is always None here).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Asking for CUDA where there is none raises — nothing falls
    back to the CPU behind the caller's back."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


@dataclass(frozen=True)
class ExecContext:
    device: torch.device = torch.device("cpu")
    impl: Optional[str] = None           # None: by device | "ref"
    window: Optional[int] = None         # runtime SWA override
    mesh: None = None                    # single device: no mesh
    active_pool_shards: Optional[int] = None
    kv_split_axis: None = None
    sp_axis: None = None
    # gather/scatter MoE dispatch instead of one-hot einsums
    moe_gather_dispatch: bool = False
    # sliding-window dense decode: attend over a slice of window + 8 keys
    # of the full buffer (the new KV is still written into the buffer)
    window_slice: bool = False
    # sliding-window dense decode over a ring buffer of the last S_max
    # (<= window) tokens
    ring_cache: bool = False

    def pool_axis(self, role: str) -> None:
        if role not in ("decode", "prefill"):
            raise KeyError(role)
        return None

    def pool_head_axis(self, n_kv_heads: int) -> None:
        return None

    def pool_shards(self, role: str) -> int:
        self.pool_axis(role)
        return 1

    def with_(self, **kw) -> "ExecContext":
        return replace(self, **kw)


CPU_CTX = ExecContext()


def make_context(device=None, impl: Optional[str] = None) -> ExecContext:
    """Context for an entry point: CUDA by default (raises without a card),
    the CPU only when asked for."""
    return ExecContext(device=resolve_device(device), impl=impl)
