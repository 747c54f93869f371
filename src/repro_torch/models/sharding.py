"""Execution context: the device, the kernel choice and the mesh roles.

The reference ``ExecContext`` names mesh axes for GSPMD sharding and for
its shard_map islands.  The port's context carries the roles the serving
path reads: ``mesh`` (a ``launch.mesh.Mesh`` driven by this one process,
or None for one device), ``sp_axis`` (ring attention and the prefill
pool's stripe), ``kv_split_axis`` (split-KV paged decode and the decode
pool's stripe) and ``active_pool_shards`` (the live stripe width), with
the reference's helpers over them.  ``tp_axis`` stays None: heads are
never sharded here, so ``pool_head_axis`` answers None.  Outside the
islands activations live whole on ``device``, position 0's device of the
mesh, as a replicated GSPMD array would.

Besides: the kernel choice (``impl``), the runtime window override, the
MoE dispatch strategy and the two sliding-window decode branches
(``window_slice``, ``ring_cache``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Optional

import torch

if TYPE_CHECKING:
    from repro_torch.launch.mesh import Mesh


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
    # None: position 0's device of ``mesh``, or the CPU without a mesh
    device: Optional[torch.device] = None
    impl: Optional[str] = None           # None: by device | "ref"
    window: Optional[int] = None         # runtime SWA override
    mesh: Optional["Mesh"] = None
    sp_axis: Optional[str] = None        # sequence (ring attention)
    kv_split_axis: Optional[str] = None  # split-KV paged decode
    tp_axis: None = None                 # heads are not sharded here
    # live stripe width of an elastically restriped paged pool (None: all
    # of its physical shards)
    active_pool_shards: Optional[int] = None
    # gather/scatter MoE dispatch instead of one-hot einsums
    moe_gather_dispatch: bool = False
    # sliding-window dense decode: attend over a slice of window + 8 keys
    # of the full buffer (the new KV is still written into the buffer)
    window_slice: bool = False
    # sliding-window dense decode over a ring buffer of the last S_max
    # (<= window) tokens
    ring_cache: bool = False

    def __post_init__(self):
        first = None if self.mesh is None else self.mesh.devices[0]
        dev = self.device if self.device is not None else first
        dev = torch.device("cpu") if dev is None else torch.device(dev)
        if first is not None and dev != first:
            raise ValueError(f"ExecContext.device {dev} must be the mesh's "
                             f"position 0 device {first}")
        object.__setattr__(self, "device", dev)
        for ax in (self.sp_axis, self.kv_split_axis):
            if ax is not None and self.mesh is not None \
                    and ax not in self.mesh.axis_names:
                raise ValueError(f"axis {ax!r} is not an axis of "
                                 f"{self.mesh}")

    # ----------------------------------------------------------- helpers
    def axis_size(self, axis: Optional[str]) -> int:
        if axis is None or self.mesh is None:
            return 1
        return self.mesh.shape[axis]

    # ------------------------------------------------- paged pool sharding
    def pool_axis(self, role: str) -> Optional[str]:
        """Mesh axis a paged KV pool of the given role stripes over, or
        None for an unsharded pool: ``"decode"`` pools split over
        ``kv_split_axis``, ``"prefill"`` pools over ``sp_axis``."""
        ax = {"decode": self.kv_split_axis, "prefill": self.sp_axis}[role]
        if ax is None or self.mesh is None or self.axis_size(ax) <= 1:
            return None
        return ax

    def pool_head_axis(self, n_kv_heads: int) -> None:
        """Mesh axis a pool's KV-head dim is sharded over: none, since
        heads are not sharded here (TP x SP is a later slice)."""
        return None

    def pool_shards(self, role: str) -> int:
        """PHYSICAL shard count for a paged pool of the given role (1 =
        unsharded); fixed for a pool's lifetime."""
        return self.axis_size(self.pool_axis(role))

    def active_shards(self, role: str) -> int:
        """Live stripe width for a paged pool of the given role."""
        n = self.pool_shards(role)
        if self.active_pool_shards is None:
            return n
        return min(n, self.active_pool_shards)

    def with_(self, **kw) -> "ExecContext":
        return replace(self, **kw)


CPU_CTX = ExecContext()


def make_context(device=None, impl: Optional[str] = None) -> ExecContext:
    """Single-device context for an entry point: CUDA by default (raises
    without a card), the CPU only when asked for.  Mesh contexts come from
    ``launch.mesh.make_context``."""
    return ExecContext(device=resolve_device(device), impl=impl)
