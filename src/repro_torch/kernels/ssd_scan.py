"""Mamba-2 chunked SSD scan (CUDA, ``csrc/ssd_scan.cu``) and its plain
PyTorch version.

* ``ssd_scan`` (K5) — x (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32,
  Bm/Cm (B, S, G, N) with head h on group h // (H/G), optional h0
  (B, H, P, N) fp32.  Returns y (B, S, H, P) in x's dtype and the state
  after the last token, h_final (B, H, P, N) fp32.  Any S: the tail chunk
  is masked in the kernel (rows past S count as dt = 0, the identity of
  the recurrence), so nothing is padded.  Replaces the Pallas ``ssd_scan``.
  bf16 runs on the tensor cores, each fp32 operand (the scores, the
  weighted x, the carried state) entering its products as a bf16 head
  and tail; the state each chunk starts from goes to the output kernel in
  that form through a scratch ``h_split`` (B, H, nc, 2, P, N) bf16.  fp32
  runs on the CUDA cores.
* ``ssd_scan_plain`` — the same function in plain PyTorch: the tail padded
  with dt = 0 to a whole chunk, then ``ref.ssd_chunked_ref``.
* ``SSDScanFn`` — K5 under autograd: the forward is ``ssd_scan``, the
  backward the vector-Jacobian product of ``ssd_scan_plain`` (for x, dt,
  A, Bm, Cm and h0) recomputed from the saved inputs, the function
  ``jax.grad`` differentiates in the reference (no Pallas kernel there
  has a backward).

Given CUDA tensors the wrapper launches the kernel (and counts the launch
in ``ssd_scan.launches``); given CPU tensors it runs the plain version.
The bf16 kernels copy x, B and C 16 bytes at a time and read h0 as
float4: x, Bm and Cm must start 16-byte aligned with batch and token
strides of whole 16 bytes (8 elements), and h0 must start 16-byte
aligned, or the call raises (the model's fused projection of
``d_inner + 2 G N`` channels meets this).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import (_DTYPES, _plain_vjp,
                                                 refuse_grad)

# (P, N) pairs the kernels are instantiated for, both dtypes
# (csrc/ssd_scan.cu); bf16 pads P and N to 64-column tiles
SHAPES = ((64, 128), (32, 64), (16, 32), (16, 16))
MAX_CHUNK = 256


def ssd_scan_plain(x, dt, A, Bm, Cm, *, h0=None, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: ``(y, h_final)``."""
    S = x.shape[1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        # dt = 0 rows are the identity of the recurrence (decay 1, no input)
        def zpad(a):
            return torch.cat([a, a.new_zeros((a.shape[0], pad)
                                             + a.shape[2:])], dim=1)
        x, dt, Bm, Cm = zpad(x), zpad(dt), zpad(Bm), zpad(Cm)
    y, h = _ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                                return_state=True)
    return y[:, :S], h


_SSD_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 6 \
    + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _rows(t: torch.Tensor, name: str) -> Tuple[int, int]:
    """(batch, token) strides of a (B, S, a, b) tensor whose last two dims
    are packed — the kernel reads x, Bm and Cm in place as slices of the
    model's fused projection."""
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        raise ValueError(f"ssd_scan: {name} must be packed in its last two "
                         f"dims, got strides {t.stride()}")
    return t.stride(0), t.stride(1)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             h0: Optional[torch.Tensor] = None, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5.  Returns ``(y, h_final)``.  bf16 x/B/C and h0 must meet the
    alignment rule of the module docstring, or the launch raises."""
    if not x.is_cuda:
        return ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)
    refuse_grad("ssd_scan", x, dt, A, Bm, Cm, h0)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (Bm.shape != (B, S, G, N) or Cm.shape != Bm.shape or H % G
            or dt.shape != (B, S, H) or A.shape != (H,)):
        raise ValueError(
            f"ssd_scan: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} A "
            f"{tuple(A.shape)} B {tuple(Bm.shape)} C {tuple(Cm.shape)}")
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd_scan: (head_dim, d_state) {(P, N)} not in "
                         f"{SHAPES}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x/B/C dtypes {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    chunk = min(chunk, S)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in 1..{MAX_CHUNK}")
    dev = x.device
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)) + (
            (("h0", h0),) if h0 is not None else ()):
        if t.device != dev:
            raise ValueError(f"ssd_scan: {name} must be on {dev}")
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    if h0 is not None:
        if h0.shape != (B, H, P, N):
            raise ValueError(f"ssd_scan: h0 {tuple(h0.shape)} != "
                             f"{(B, H, P, N)}")
        h0 = h0.to(torch.float32).contiguous()
    xs, bs, cs = _rows(x, "x"), _rows(Bm, "Bm"), _rows(Cm, "Cm")
    nc = -(-S // chunk)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    states = torch.empty((B, H, nc, P, N), dtype=torch.float32, device=dev)
    h_split = (torch.empty((B, H, nc, 2, P, N), dtype=torch.bfloat16,
                           device=dev) if x.dtype == torch.bfloat16 else None)
    a_cum = torch.empty((B, H, nc * chunk), dtype=torch.float32, device=dev)
    a_tot = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
    fn = _build.library("ssd_scan").ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _SSD_ARGS, ctypes.c_int
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_final.data_ptr(), states.data_ptr(),
            None if h_split is None else h_split.data_ptr(),
            a_cum.data_ptr(), a_tot.data_ptr(), *xs, *bs, *cs,
            B, S, H, G, P, N, chunk, nc, _DTYPES[x.dtype],
            _build.stream_ptr(dev))
    _build.check(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_final


ssd_scan.launches = 0


class SSDScanFn(torch.autograd.Function):
    """K5 with gradients for x, dt, A, Bm, Cm and h0: ``apply(x, dt, A,
    Bm, Cm, h0, chunk)`` gives ``(y, h_final)``.  The forward is
    ``ssd_scan`` (the kernel on CUDA tensors, which masks a ragged last
    chunk; the plain scan on CPU ones); the backward recomputes
    ``ssd_scan_plain`` (which pads it with dt = 0) from the saved inputs
    and returns its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk):
        y, h = ssd_scan(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, g_y, g_h):
        return (*_plain_vjp(
            lambda x, dt, A, Bm, Cm, h0: ssd_scan_plain(
                x, dt, A, Bm, Cm, h0=h0, chunk=ctx.chunk),
            ctx.saved_tensors, ctx.needs_input_grad[:6], (g_y, g_h)), None)
