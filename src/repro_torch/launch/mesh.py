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
  (reference ``launch/mesh.py``): ``"prefill"`` (ring attention over
  ``sp_axis``), ``"decode"`` (split-KV over ``kv_split_axis``) and
  ``"serve_paged"`` (both on the "data" axis, so a page's stripe position
  lives on the same position in the prefill and the decode pool).
* The collectives the islands use.  A sharded tensor is a list of
  per-position tensors, each on its position's device; ``ring_shift`` is
  ``lax.ppermute`` with the ring permutation j -> j + 1, ``all_gather``
  stacks the parts on one device, and the axis size and index
  (``lax.psum(1)``, ``lax.axis_index``) are the length of
  ``Mesh.positions(axis)`` and the index into it.  ``split`` and ``unsplit``
  place a whole tensor's contiguous sequence shards and gather them back.

Moving a part to a position is ``.to(device, non_blocking=True)``, a
no-op when it is already there.  Nothing here sets a global mesh, and the
reference's 16x16 production mesh is not ported.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models.sharding import ExecContext, resolve_device


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

    def positions(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` (every other axis at index 0), in
        axis order: entry i is the position with ``axis_index == i``."""
        i = self.axis_names.index(axis)
        stride = math.prod(list(self.shape.values())[i + 1:])
        return tuple(self.devices[j * stride]
                     for j in range(self.shape[axis]))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    """A mesh of ``prod(shape)`` positions, all on ``device`` (default
    ``cuda``, which raises without a card; the tests pass ``"cpu"``)."""
    dev = _concrete(resolve_device(device))
    return Mesh(axis_names, shape, [dev] * math.prod(shape))


def _concrete(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, the device a tensor reports."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_context(mesh: Mesh, mode: str, *, impl: Optional[str] = None,
                 window: Optional[int] = None) -> ExecContext:
    """Mesh-axis roles per execution mode (reference launch/mesh.py).

    ``serve_paged`` is the paged serving engine's context: one context
    drives chunk prefill (ring attention over ``sp_axis``) and paged
    decode (split-KV over ``kv_split_axis``), and the engine's pools
    stripe over those axes (``ExecContext.pool_axis``).  Both roles ride
    the "data" axis so prefill-pool pages hand off to decode pools
    position-locally.  The reference's ``tp_axis`` ("model") is not
    ported: heads are never sharded here."""
    common = dict(mesh=mesh, impl=impl, window=window)
    if mode == "prefill":
        return ExecContext(sp_axis="data", **common)
    if mode == "decode":
        return ExecContext(kv_split_axis="model", **common)
    if mode == "serve_paged":
        return ExecContext(sp_axis="data", kv_split_axis="data", **common)
    raise ValueError(f"mode {mode!r}: the port's mesh contexts are "
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
    return [to(xs[(i - 1) % n], devices[i]) for i in range(n)]


def all_gather(xs: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """``lax.all_gather``: the parts stacked on ``device``, (n, ...)."""
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
    return [to(p.contiguous(), d)
            for p, d in zip(torch.chunk(x, n, dim=1), devices)]


def unsplit(xs: Sequence[torch.Tensor],
            device: torch.device) -> torch.Tensor:
    """The inverse of ``split``: the shards concatenated on ``device``."""
    return torch.cat([to(x, device) for x in xs], dim=1)
