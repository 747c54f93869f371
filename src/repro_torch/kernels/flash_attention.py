"""Prefill attention kernels (CUDA, ``csrc/flash_attention.cu``) and their
plain PyTorch versions.

* ``flash_attention`` (K3) — flash attention masked by position arrays:
  causal through ``q_pos``/``kv_pos``, sliding window, GQA ``h // group``;
  returns ``(out, lse)``.  Replaces the Pallas ``flash_attention``.
* ``paged_flash_prefill`` (K2) — a prefill chunk's queries against history
  pages in natural token order (a key's position is its flat table index,
  valid while below ``hist_len``); returns the partial ``(out, lse)`` that
  ``ref.merge_partials`` combines with the chunk's own attention.
  Replaces the Pallas ``paged_flash_prefill``.

A wrapper given CUDA tensors launches its kernel (and counts the launch in
its ``launches`` attribute); given CPU tensors it runs the plain version
beside it.  The plain versions compute what the kernels compute, including
``out = 0`` for a query row with no valid key (the reference oracle in
``ref.py`` leaves a mean of V there, which merging weights by zero).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 128)


def _zero_dead_rows(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """out (B, Sq, H, D), lse (B, H, Sq): rows whose lse sits at NEG_INF
    had no valid key; the kernels return 0 for them."""
    dead = (lse <= _ref.NEG_INF / 2).transpose(1, 2)[..., None]
    return torch.where(dead, torch.zeros((), dtype=out.dtype,
                                         device=out.device), out)


def _pos2d(pos: torch.Tensor, B: int, S: int) -> torch.Tensor:
    if pos.dim() == 1:
        pos = pos[None]
    return pos.expand(B, S).to(torch.int32).contiguous()


def _check(name: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not in {list(_DTYPES)}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not in {_HEAD_DIMS}")
    for t in (q,) + others:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: every tensor must be on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: mixed dtypes {q.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


# ------------------------------------------------------------------- K3
def flash_attention_plain(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                          window: Optional[int] = None, softmax_scale=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: ``(out, lse)``."""
    out, lse = _ref.attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                  window=window, softmax_scale=softmax_scale,
                                  with_lse=True)
    return _zero_dead_rows(out, lse), lse


_FA_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_PP_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _fn(symbol: str, argtypes):
    f = getattr(_build.library("flash_attention"), symbol)
    if f.argtypes is None:
        f.argtypes, f.restype = argtypes, ctypes.c_int
    return f


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softmax_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3.  q (B, Sq, H, D); k/v (B, Sk, KVH, D); q_pos (Sq,) or (B, Sq),
    kv_pos (Sk,) or (B, Sk) int32.  Returns out (B, Sq, H, D) in q's
    dtype and lse (B, H, Sq) fp32."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window,
                                     softmax_scale=softmax_scale)
    B, Sq, H, D = q.shape
    _, Sk, KVH, Dk = k.shape
    if Dk != D or v.shape != k.shape or k.shape[0] != B or H % KVH:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    _check("flash_attention", q, k, v)
    qp, kp = _pos2d(q_pos, B, Sq), _pos2d(kv_pos, B, Sk)
    if qp.device != q.device or kp.device != q.device:
        raise ValueError("flash_attention: positions must be on q's device")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _fn("flash_attention_fwd", _FA_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
        kp.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, KVH, D,
        int(causal), -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


# ------------------------------------------------------------------- K2
def paged_flash_prefill_plain(q, k_pool, v_pool, block_tables, hist_len,
                              q_pos, *, causal: bool = True,
                              window: Optional[int] = None,
                              softmax_scale=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: gather the history pages in table order and
    attend with ``index < hist_len`` validity; ``(out, lse)``."""
    B, Sq = q.shape[:2]
    npg = block_tables.shape[1]
    page = k_pool.shape[1]
    S_h = npg * page
    idx = block_tables.long()
    hk = k_pool[idx].reshape(B, S_h, *k_pool.shape[2:])
    hv = v_pool[idx].reshape(B, S_h, *v_pool.shape[2:])
    hist_pos = torch.arange(S_h, dtype=torch.int32, device=q.device)
    valid = hist_pos[None, :] < hist_len[:, None]
    # never let an unused slot's bytes into the arithmetic, even times 0
    zero = torch.zeros((), dtype=hk.dtype, device=q.device)
    hk = torch.where(valid[:, :, None, None], hk, zero)
    hv = torch.where(valid[:, :, None, None], hv, zero)
    out, lse = _ref.attention_ref(
        q, hk, hv, q_pos, hist_pos[None].expand(B, S_h), causal=causal,
        window=window, kv_valid=valid, softmax_scale=softmax_scale,
        with_lse=True)
    return _zero_dead_rows(out, lse), lse


def paged_flash_prefill(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        hist_len: torch.Tensor, q_pos: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2.  q (B, Sq, H, D); pools (n_pages, page, KVH, D); block_tables
    (B, npg) int32; hist_len (B,) int32; q_pos (Sq,) or (B, Sq) int32.
    Returns the history partial: out (B, Sq, H, D), lse (B, H, Sq)."""
    if not q.is_cuda:
        return paged_flash_prefill_plain(
            q, k_pool, v_pool, block_tables, hist_len, q_pos, causal=causal,
            window=window, softmax_scale=softmax_scale)
    B, Sq, H, D = q.shape
    _, page, KVH, Dk = k_pool.shape
    if (Dk != D or v_pool.shape != k_pool.shape or H % KVH
            or block_tables.dim() != 2 or block_tables.shape[0] != B):
        raise ValueError(
            f"paged_flash_prefill: shapes q {tuple(q.shape)} pool "
            f"{tuple(k_pool.shape)} table {tuple(block_tables.shape)}")
    _check("paged_flash_prefill", q, k_pool, v_pool)
    bt = block_tables.to(torch.int32).contiguous()
    hl = hist_len.to(torch.int32).reshape(B).contiguous()
    qp = _pos2d(q_pos, B, Sq)
    for t in (bt, hl, qp):
        if t.device != q.device:
            raise ValueError("paged_flash_prefill: index tensors must be "
                             "on q's device")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _fn("paged_prefill_fwd", _PP_ARGS)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
        hl.data_ptr(), qp.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, Sq, H, KVH, D, bt.shape[1], page, int(causal),
        -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], _build.stream_ptr(q.device))
    _build.check(rc, "paged_flash_prefill")
    paged_flash_prefill.launches += 1
    return out, lse


paged_flash_prefill.launches = 0
