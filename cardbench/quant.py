"""Matrix products of the plain references, exact or in the control's
lower precision."""

from __future__ import annotations

import torch

FP8_MAX = 448.0                         # largest float8 e4m3 value


def set_exact_matmul() -> None:
    """float32 products in float32: TF32 (a lower precision) off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in
    float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x @ w in float32 (``mode="fp32"``), or with x rounded to float8
    per row and w per column first (``mode="fp8"``, the control)."""
    if mode == "fp32":
        return x @ w
    if mode == "fp8":
        return fp8_round(x, -1) @ fp8_round(w, -2)
    raise ValueError(f"mode {mode!r}")
