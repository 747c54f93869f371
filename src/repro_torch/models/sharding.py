"""Execution context: the device, the kernel choice and the mesh roles.

The reference ``ExecContext`` names mesh axes for GSPMD sharding and for
its shard_map islands.  The port's context carries the roles the serving
path reads: ``mesh`` (a ``launch.mesh.Mesh`` driven by this one process,
or None for one device), ``sp_axis`` (ring attention and the prefill
pool's stripe), ``kv_split_axis`` (split-KV paged decode and the decode
pool's stripe, and the dense split-KV decode; a tuple of axes is the
reference's collapsed split, indexed row-major), ``tp_axis`` (attention
heads, and the KV heads of the pools where they divide it: TP x SP),
``dp_axis`` (the batch: read only where the reference's branches read it,
such as expert parallelism's token split — one process never splits the
batch), ``active_pool_shards`` (the live stripe width), ``zigzag_skip``
(the causal-skip ring for a zigzag prefill layout) and ``moe_ep`` (expert
parallelism), with the reference's helpers over them.  Outside the
islands activations live whole on ``device``, position 0's device of the
mesh, as a replicated GSPMD array would.

Besides: the kernel choice (``impl``), the runtime window override, the
MoE dispatch strategy, the two sliding-window decode branches
(``window_slice``, ``ring_cache``) and ``remat`` (train mode recomputes
each block's activations in the backward pass, reference
``sharding.py:28``).

Two fields name the reference's placement without changing what this
process runs: ``pod_axis`` (the multi-pod outer data axis, major in
``batch_axes``) and ``shard2d_weights`` (2-D weight sharding, the dim
that TP leaves whole split over the data axis too:
``models.params.param_specs`` reads it).  The reference's
``unroll_scan`` is not here: the port's layer loop is Python, never a
scan, so there is nothing to unroll.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Optional, Tuple, Union

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


def _axes(axis) -> Tuple[str, ...]:
    """An axis or a tuple of axes as a tuple (None: none)."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclass(frozen=True)
class ExecContext:
    # None: position 0's device of ``mesh``, or the CPU without a mesh
    device: Optional[torch.device] = None
    impl: Optional[str] = None           # None: by device | "ref"
    window: Optional[int] = None         # runtime SWA override
    mesh: Optional["Mesh"] = None
    dp_axis: Optional[str] = None        # batch
    sp_axis: Optional[str] = None        # sequence (ring attention, sp_ssd)
    # split-KV decode (paged and dense); a tuple is a collapsed split
    kv_split_axis: Optional[Union[str, Tuple[str, ...]]] = None
    tp_axis: Optional[str] = None        # attention heads (TP)
    pod_axis: Optional[str] = None       # multi-pod outer data axis
    # live stripe width of an elastically restriped paged pool (None: all
    # of its physical shards)
    active_pool_shards: Optional[int] = None
    # gather/scatter MoE dispatch instead of one-hot einsums
    moe_gather_dispatch: bool = False
    # zigzag causal-skip ring attention (valid only when the prefill's
    # storage layout is zigzag: core/zigzag.py)
    zigzag_skip: bool = False
    # expert parallelism: the experts split over moe_ep_axis(), each
    # position computing its own experts' slots (models/moe.py)
    moe_ep: bool = False
    # sliding-window dense decode: attend over a slice of window + 8 keys
    # of the full buffer (the new KV is still written into the buffer)
    window_slice: bool = False
    # sliding-window dense decode over a ring buffer of the last S_max
    # (<= window) tokens
    ring_cache: bool = False
    # train mode: checkpoint each block of the stack (its activations are
    # recomputed in the backward pass)
    remat: bool = False
    # 2-D weight sharding (model x data) in ``param_specs``: the weights'
    # placement on the reference's mesh; this process keeps them whole
    shard2d_weights: bool = False

    def __post_init__(self):
        first = None if self.mesh is None else self.mesh.devices[0]
        dev = self.device if self.device is not None else first
        dev = torch.device("cpu") if dev is None else torch.device(dev)
        if first is not None and dev != first:
            raise ValueError(f"ExecContext.device {dev} must be the mesh's "
                             f"position 0 device {first}")
        object.__setattr__(self, "device", dev)
        for ax in (self.dp_axis, self.sp_axis, self.tp_axis,
                   self.pod_axis, *_axes(self.kv_split_axis)):
            if ax is not None and self.mesh is not None \
                    and ax not in self.mesh.axis_names:
                raise ValueError(f"axis {ax!r} is not an axis of "
                                 f"{self.mesh}")

    # ----------------------------------------------------------- helpers
    def axis_size(self, axis) -> int:
        """Positions along ``axis``; a tuple of axes is their product."""
        if axis is None or self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in _axes(axis))

    @property
    def batch_axes(self):
        """Axes the batch dim is sharded over (pod major), or None."""
        axes = tuple(a for a in (self.pod_axis, self.dp_axis)
                     if a is not None)
        return axes if axes else None

    def moe_ep_axis(self) -> Optional[str]:
        """The axis the experts split over under ``moe_ep``: "data" where
        the mesh has it, else ``dp_axis``, else ``sp_axis``."""
        if not self.moe_ep or self.mesh is None:
            return None
        if "data" in self.mesh.axis_names:
            return "data"
        return self.dp_axis or self.sp_axis

    def shardable(self, dim: int, axis: Optional[str]) -> Optional[str]:
        """``axis`` if ``dim`` divides evenly over it (and it has more than
        one position), else None."""
        n = self.axis_size(axis)
        return axis if (axis is not None and n > 1 and dim % n == 0) \
            else None

    # ------------------------------------------------- paged pool sharding
    def pool_axis(self, role: str) -> Optional[str]:
        """Mesh axis a paged KV pool of the given role stripes over, or
        None for an unsharded pool: ``"decode"`` pools split over
        ``kv_split_axis``, ``"prefill"`` pools over ``sp_axis``."""
        ax = {"decode": self.kv_split_axis, "prefill": self.sp_axis}[role]
        if ax is None or self.mesh is None or self.axis_size(ax) <= 1:
            return None
        return ax

    def pool_head_axis(self, n_kv_heads: int) -> Optional[str]:
        """Mesh axis a paged pool's KV-head dim is sharded over on top of
        its SP stripe (the TP x SP layout), or None for a pool replicated
        over TP: ``tp_axis`` when ``n_kv_heads`` divides it.  The same
        rule picks the attention islands' KV head axis
        (models/attention.py), so the pools and their readers agree."""
        return self.shardable(n_kv_heads, self.tp_axis)

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
