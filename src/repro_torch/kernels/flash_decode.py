"""Paged decode kernel (CUDA, ``csrc/paged_decode.cu``), its plain PyTorch
version, and the page helpers of the serving engine's block pools.

* ``paged_flash_decode`` (K1) — one query token per row against a paged
  pool (n_pages, page, KVH, D) through a block table (B, npg); length and
  window masks follow the per-column ``page_pos``; returns ``(o, lse)``.
  With ``k_new``/``v_new`` it is the fused decode tick: the new token's
  K/V is written at ``(append_page, append_slot)`` in place and the row
  attends over ``lengths + 1`` keys.  Replaces the Pallas
  ``paged_flash_decode`` reached through ``paged_append_attend``.
* Page helpers (``scatter_kv_chunk``, ``copy_kv_blocks``,
  ``gather_kv_blocks``, ``scatter_kv_blocks``, ``copy_kv_block_within``)
  are indexing, not kernels: the reference runs them as XLA scatters on
  donated buffers, here they write the live pool tensors in place.  Pools
  carry the layer axis first, (nb, n_pages, page, KVH, D).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import _DTYPES, _check

# Position base for table columns past a sequence's allocation: far past
# any real length, and small enough that base + slot never overflows int32.
POS_PAD = 2 ** 30


# ------------------------------------------------------------ page helpers
def scatter_kv_chunk(pool: torch.Tensor, blocks: torch.Tensor,
                     seq_kv: torch.Tensor, positions: torch.Tensor) -> None:
    """Write one chunk's KV (nb, L, KVH, D) at its logical ``positions``
    (L,): token j lands in page ``blocks[positions[j] // page]`` at slot
    ``positions[j] % page``."""
    page = pool.shape[2]
    pos = positions.long()
    pool[:, blocks.long()[pos // page], pos % page] = seq_kv.to(pool.dtype)


def copy_kv_blocks(dst_pool: torch.Tensor, src_pool: torch.Tensor,
                   src_blocks: torch.Tensor, dst_blocks: torch.Tensor) -> None:
    """Copy whole pages between two pools (prefill -> decode admission)."""
    dst_pool[:, dst_blocks.long()] = src_pool[:, src_blocks.long()].to(
        dst_pool.device, dst_pool.dtype)


def gather_kv_blocks(pool: torch.Tensor, blocks: torch.Tensor
                     ) -> torch.Tensor:
    """Pages ``blocks`` out of a pool: (nb, n, page, KVH, D), a copy."""
    return pool[:, blocks.long()]


def scatter_kv_blocks(pool: torch.Tensor, blocks: torch.Tensor,
                      pages: torch.Tensor) -> None:
    """Write whole pages (nb, n, page, KVH, D) into ``blocks`` (swap-in,
    host prefix promotion)."""
    pool[:, blocks.long()] = pages.to(pool.device, pool.dtype)


def copy_kv_block_within(pool: torch.Tensor, src_block: int,
                         dst_block: int) -> None:
    """Copy one page onto another in the same pool (copy-on-write split)."""
    pool[:, dst_block] = pool[:, src_block]


def fused_append_attend(k_pool: torch.Tensor, v_pool: torch.Tensor,
                        append_page: torch.Tensor, append_slot: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """The append half of the decode tick, in place: each row's new K/V
    (B, KVH, D) lands at its (page, slot).  Padded rows aim at the scratch
    page and write bytes nothing reads."""
    pg, sl = append_page.long(), append_slot.long()
    k_pool[pg, sl] = k_new.to(k_pool.dtype)
    v_pool[pg, sl] = v_new.to(v_pool.dtype)


# ----------------------------------------------------------------- K1
def paged_flash_decode_plain(q, k_pool, v_pool, block_tables, lengths, *,
                             window: Optional[int] = None,
                             softmax_scale=None, page_pos=None,
                             k_new=None, v_new=None, append_page=None,
                             append_slot=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: append in place (when given), then attend over
    ``lengths (+1)`` with the masked slots zeroed before any arithmetic;
    ``(o, lse)`` with ``o = 0`` for a row with no valid key."""
    if k_new is not None:
        fused_append_attend(k_pool, v_pool, append_page, append_slot,
                            k_new, v_new)
        lengths = lengths + 1
    B, npg = block_tables.shape
    page = k_pool.shape[1]
    if page_pos is None:
        page_pos = (torch.arange(npg, dtype=torch.int32, device=q.device)
                    * page)[None].expand(B, npg)
    kv_pos = (page_pos[:, :, None] + torch.arange(
        page, dtype=torch.int32, device=q.device)[None, None]
              ).reshape(B, npg * page)
    valid = kv_pos < lengths[:, None]
    if window is not None:
        valid &= kv_pos >= (lengths[:, None] - window)
    idx = block_tables.long()
    zero = torch.zeros((), dtype=k_pool.dtype, device=q.device)
    k = torch.where(valid[:, :, None, None],
                    k_pool[idx].reshape(B, npg * page, *k_pool.shape[2:]),
                    zero)
    v = torch.where(valid[:, :, None, None],
                    v_pool[idx].reshape(B, npg * page, *v_pool.shape[2:]),
                    zero)
    out, lse = _ref.attention_ref(
        q[:, None], k, v, q_pos=(lengths - 1)[:, None], kv_pos=kv_pos,
        causal=False, kv_valid=valid, softmax_scale=softmax_scale,
        with_lse=True)
    o, lse = out[:, 0], lse[:, :, 0]
    dead = (lse <= _ref.NEG_INF / 2)[..., None]
    return torch.where(dead, torch.zeros((), dtype=o.dtype,
                                         device=o.device), o), lse


_PD_ARGS = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# blocks the split kernel aims for: a few per SM of the 132 on an H100
_TARGET_BLOCKS = 4 * 132


def _int32_on(t: torch.Tensor, device, n: int, what: str) -> torch.Tensor:
    t = t.to(torch.int32).reshape(n).contiguous()
    if t.device != device:
        raise ValueError(f"paged_flash_decode: {what} must be on {device}")
    return t


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *,
                       window: Optional[int] = None,
                       softmax_scale: Optional[float] = None,
                       page_pos: Optional[torch.Tensor] = None,
                       k_new: Optional[torch.Tensor] = None,
                       v_new: Optional[torch.Tensor] = None,
                       append_page: Optional[torch.Tensor] = None,
                       append_slot: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1.  q (B, H, D); pools (n_pages, page, KVH, D); block_tables
    (B, npg) int32; lengths (B,) int32 (EXCLUDING the new token when
    ``k_new`` is given).  Returns o (B, H, D) and lse (B, H) fp32; with
    ``k_new`` the pools are written in place first."""
    if not q.is_cuda:
        return paged_flash_decode_plain(
            q, k_pool, v_pool, block_tables, lengths, window=window,
            softmax_scale=softmax_scale, page_pos=page_pos, k_new=k_new,
            v_new=v_new, append_page=append_page, append_slot=append_slot)
    B, H, D = q.shape
    _, page, KVH, Dk = k_pool.shape
    if (Dk != D or v_pool.shape != k_pool.shape or H % KVH
            or block_tables.dim() != 2 or block_tables.shape[0] != B):
        raise ValueError(
            f"paged_flash_decode: shapes q {tuple(q.shape)} pool "
            f"{tuple(k_pool.shape)} table {tuple(block_tables.shape)}")
    if H // KVH not in (1, 2, 4, 8):
        raise ValueError(f"paged_flash_decode: GQA group {H // KVH} "
                         "not in (1, 2, 4, 8)")
    append = k_new is not None
    tensors = (q, k_pool, v_pool) + ((k_new, v_new) if append else ())
    _check("paged_flash_decode", *tensors)
    if append and (k_new.shape != (B, KVH, D) or v_new.shape != k_new.shape):
        raise ValueError("paged_flash_decode: k_new/v_new must be "
                         f"({B}, {KVH}, {D})")
    dev = q.device
    npg = block_tables.shape[1]
    bt = _int32_on(block_tables, dev, B * npg, "block_tables")
    ln = _int32_on(lengths, dev, B, "lengths")
    pp = (None if page_pos is None
          else _int32_on(page_pos, dev, B * npg, "page_pos"))
    ap = _int32_on(append_page, dev, B, "append_page") if append else None
    asl = _int32_on(append_slot, dev, B, "append_slot") if append else None
    pages_per_split = max(1, -(-npg * B * KVH // _TARGET_BLOCKS))
    splits = -(-npg // pages_per_split)
    part_m = torch.empty((B, H, splits), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, splits, D), dtype=torch.float32,
                           device=dev)
    o = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.library("paged_decode").paged_decode_fwd
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _PD_ARGS, ctypes.c_int
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            bt.data_ptr(), ln.data_ptr(), ptr(pp), ptr(k_new), ptr(v_new),
            ptr(ap), ptr(asl), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, KVH, D, npg, page, splits, pages_per_split,
            -1 if window is None else int(window), float(scale),
            _DTYPES[q.dtype], _build.stream_ptr(dev))
    _build.check(rc, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return o, lse


paged_flash_decode.launches = 0
