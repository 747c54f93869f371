"""A device mesh driven by one process, and its mode-specific contexts.

The reference runs its sequence-parallel islands as ``shard_map`` bodies
under one JAX controller.  The port keeps that single controller: one
Python process drives every mesh position.  A *position* is a
``torch.device``, and several positions may name the same card (one H100
runs a 4-position mesh as four logical positions on ``cuda:0``).

* ``Mesh`` — axis names, their sizes (the positions, row-major) and one
  device per position: the counterpart of ``jax.sharding.Mesh`` and of the
  reference's ``compat.make_mesh`` (``make_mesh`` here).
* ``make_context(mesh, mode)`` — the axis roles of each execution mode
  (reference ``launch/mesh.py``): ``"train"`` (the batch on ``dp_axis``
  = "data", each block rematerialised), ``"prefill"`` (ring attention over
  ``sp_axis``), ``"decode"`` (split-KV over ``kv_split_axis`` = "model",
  the batch on ``dp_axis`` = "data") and
  ``"serve_paged"`` (both on the "data" axis, so a page's stripe position
  lives on the same position in the prefill and the decode pool).  A
  mesh with a "model" axis of more than one position (the reference's
  ``"data" x "model"``) also gets ``tp_axis="model"``: attention heads
  and, where the KV heads divide it, the page pools shard over it (TP x
  SP).  A 1-D "data" mesh has no TP axis.
* The collectives the islands use.  A sharded tensor is a list of
  per-position tensors, each on its position's device; ``ring_shift`` is
  ``lax.ppermute`` with the ring permutation j -> j + 1, ``all_gather``
  stacks the parts on one device, and the axis size and index
  (``lax.psum(1)``, ``lax.axis_index``) are the length of
  ``Mesh.positions(axis)`` and the index into it.  On a 2-D mesh
  ``Mesh.positions(axis, other=i)`` is one line of it: an SP column at a
  fixed TP index, or a TP row at a fixed SP index, and the collectives
  run along that line.  ``split`` and ``unsplit`` place a whole tensor's
  contiguous sequence shards and gather them back; ``head_part`` is a
  tensor's slice of the heads at one TP index, and ``head_stripes`` a
  head-sharded pool's stripe at each.

Moving a part to a position is ``.to(device, non_blocking=True)``, a
no-op when it is already there.  Nothing here sets a global mesh.

* ``make_production_mesh`` — the reference's production meshes, (16, 16)
  over ("data", "model") and, multi-pod, (2, 16, 16) over ("pod",
  "data", "model"), every position on one device (``"meta"`` for the
  dry run, ``launch/dryrun.py``, which allocates nothing).
* Accounting for the dry run.  ``Mesh.positions`` returns a ``Line``,
  which also carries each device's position number; an island's loop
  runs each position's body under ``at(devices, i)``, so
  ``current_position()`` names the position whose work runs now (several
  positions may share one device, so a tensor's device cannot say).
  Work outside every island is position 0's, where the port runs it.
  Under ``recording_collectives()`` the collectives above append a
  record (kind, result bytes on one position, group size) that
  ``launch.roofline.collective_bytes`` turns into wire bytes.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models.sharding import ExecContext, resolve_device


# the position whose work runs now, and the collectives' record (None:
# not recording)
_POSITION = contextvars.ContextVar("mesh_position", default=0)
_COLLECTIVES = contextvars.ContextVar("mesh_collectives", default=None)


class Line(tuple):
    """The devices of one line of a mesh, in axis order; ``ids`` holds
    each one's position number (row-major over the mesh's shape)."""

    def __new__(cls, devices, ids):
        line = super().__new__(cls, devices)
        line.ids = tuple(ids)
        return line


def current_position() -> int:
    """The position number whose work runs now (0 outside the
    islands)."""
    return _POSITION.get()


@contextlib.contextmanager
def at(devices: Sequence[torch.device], i: int):
    """Run the body as position ``i`` of ``devices`` (a ``Line``; a plain
    sequence of devices names no position and changes nothing)."""
    ids = getattr(devices, "ids", None)
    if ids is None:
        yield
        return
    token = _POSITION.set(ids[i])
    try:
        yield
    finally:
        _POSITION.reset(token)


@contextlib.contextmanager
def recording_collectives():
    """Collect a record of every collective run in the body: a list of
    {"kind", "result_bytes" (on one position), "group"}."""
    records: list = []
    token = _COLLECTIVES.set(records)
    try:
        yield records
    finally:
        _COLLECTIVES.reset(token)


def _record(kind: str, result_bytes: int, group: int) -> None:
    records = _COLLECTIVES.get()
    if records is not None and group > 1:
        records.append({"kind": kind, "result_bytes": int(result_bytes),
                        "group": group})


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class Mesh:
    """Named axes over positions, one ``torch.device`` per position.

    ``shape`` gives each axis's size; positions are numbered row-major
    over it, and ``devices[i]`` is position i's device.  ``Mesh.shape``
    maps an axis name to its size, as a JAX mesh's does."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 devices: Sequence[Union[str, torch.device]]):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in shape)
        if len(sizes) != len(self.axis_names) or min(sizes, default=0) < 1:
            raise ValueError(f"mesh shape {sizes} does not fit axes "
                             f"{self.axis_names}")
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.devices) != math.prod(sizes):
            raise ValueError(f"a {sizes} mesh needs {math.prod(sizes)} "
                             f"devices, got {len(self.devices)}")
        self.shape = dict(zip(self.axis_names, sizes))

    def positions(self, axis, **at: int) -> Line:
        """The devices along ``axis``, every other axis at the index ``at``
        names (default 0), in axis order: entry i is the position with
        ``axis_index == i`` on that line of the mesh.  A tuple of axes is
        the reference's collapsed axis: its index runs row-major over
        them (``_axis_index_multi``)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a, j in at.items():
            if a in axes or not 0 <= j < self.shape[a]:
                raise ValueError(f"{a}={j} does not fix a line along "
                                 f"{axis!r} of {self}")
        ids = []
        for flat_line in range(math.prod(self.shape[a] for a in axes)):
            idx, rest = {}, flat_line
            for a in reversed(axes):
                idx[a], rest = rest % self.shape[a], rest // self.shape[a]
            flat = 0
            for a, n in self.shape.items():
                flat = flat * n + (idx[a] if a in idx else at.get(a, 0))
            ids.append(flat)
        return Line((self.devices[i] for i in ids), ids)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    """A mesh of ``prod(shape)`` positions, all on ``device`` (default
    ``cuda``, which raises without a card; the tests pass ``"cpu"``)."""
    dev = _concrete(resolve_device(device))
    return Mesh(axis_names, shape, [dev] * math.prod(shape))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production mesh (reference launch/mesh.py:19):
    (16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model") with ``multi_pod``; every position on ``device`` (default
    ``cuda``; the dry run passes ``"meta"``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def _concrete(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, the device a tensor reports."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_context(mesh: Mesh, mode: str, *, impl: Optional[str] = None,
                 window: Optional[int] = None) -> ExecContext:
    """Mesh-axis roles per execution mode (reference launch/mesh.py).

    ``"train"`` puts the batch on ``dp_axis="data"`` and sets ``remat``
    (each block's activations recomputed in the backward pass).  One
    process never splits the batch; only expert parallelism
    (``moe_ep``) reads ``dp_axis``, so without it a train step on the
    mesh computes the single-device loss and gradients on position 0's
    device.
    ``serve_paged`` is the paged serving engine's context: one context
    drives chunk prefill (ring attention over ``sp_axis``) and paged
    decode (split-KV over ``kv_split_axis``), and the engine's pools
    stripe over those axes (``ExecContext.pool_axis``).  Both roles ride
    the "data" axis so prefill-pool pages hand off to decode pools
    position-locally.  ``tp_axis`` is "model" where the mesh has that
    axis with more than one position (heads shard over it), else None;
    ``pod_axis`` is "pod" where the mesh has it (the multi-pod mesh's
    outer data axis)."""
    tp = "model" if mesh.shape.get("model", 1) > 1 else None
    pod = "pod" if "pod" in mesh.axis_names else None
    common = dict(mesh=mesh, tp_axis=tp, pod_axis=pod, impl=impl,
                  window=window)
    if mode == "train":
        return ExecContext(dp_axis="data", remat=True, **common)
    if mode == "prefill":
        return ExecContext(sp_axis="data", **common)
    if mode == "decode":
        return ExecContext(dp_axis="data", kv_split_axis="model", **common)
    if mode == "serve_paged":
        return ExecContext(sp_axis="data", kv_split_axis="data", **common)
    raise ValueError(f"mode {mode!r}: the mesh contexts are 'train', "
                     "'prefill', 'decode' and 'serve_paged'")


# ------------------------------------------------------------ collectives
def to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``; the same tensor when it is already there."""
    if x.device == device:
        return x
    return x.to(device, non_blocking=device.type == "cuda")


def ring_shift(xs: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``lax.ppermute`` with the ring permutation j -> j + 1: position i
    receives position i - 1's part."""
    n = len(xs)
    _record("collective-permute", _nbytes(xs[0]), n)
    return [to(xs[(i - 1) % n], devices[i]) for i in range(n)]


def all_gather(xs: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """``lax.all_gather``: the parts stacked on ``device``, (n, ...)."""
    _record("all-gather", sum(_nbytes(x) for x in xs), len(xs))
    return torch.stack([to(x, device) for x in xs])


def split(x: torch.Tensor,
          devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Contiguous equal shards of ``x`` along its sequence dim (1), shard
    i on ``devices[i]`` (each shard contiguous in memory, as the kernels
    require)."""
    n = len(devices)
    if x.shape[1] % n:
        raise ValueError(f"dim 1 of {tuple(x.shape)} does not divide over "
                         f"{n} positions")
    _record("scatter", _nbytes(x), n)
    return [to(p.contiguous(), d)
            for p, d in zip(torch.chunk(x, n, dim=1), devices)]


def unsplit(xs: Sequence[torch.Tensor],
            device: torch.device) -> torch.Tensor:
    """The inverse of ``split``: the shards concatenated on ``device``."""
    _record("all-gather", sum(_nbytes(x) for x in xs), len(xs))
    return torch.cat([to(x, device) for x in xs], dim=1)


def head_stripes(pools) -> List[List[torch.Tensor]]:
    """The stripes of a sharded page pool, one per head slice.  A
    head-sharded pool (TP x SP) is a list over shards of lists over TP
    indices, ``pools[s][t]`` holding head slice t of shard s's pages; it
    gives ``[pools[s][t] for s]`` for each t.  A striped pool (a list of
    per-shard tensors) is its own one stripe."""
    if isinstance(pools[0], (list, tuple)):
        return [[p[t] for p in pools] for t in range(len(pools[0]))]
    return [list(pools)]


def head_part(x: torch.Tensor, t: int, n: int, dim: int) -> torch.Tensor:
    """Slice ``t`` of ``n`` equal slices of ``x``'s heads (dim ``dim``):
    what TP index ``t`` of an ``n``-wide head axis holds.  A view; the
    islands make it contiguous where a kernel reads it."""
    if n == 1:
        return x
    w = x.shape[dim] // n
    return x.narrow(dim, t * w, w)
