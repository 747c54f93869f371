"""Helpers the port keeps its own copies of.

``causal_depthwise_conv`` is the reference's spelling (``repro/compat.py``)
of Mamba-2's short causal convolution: K shifted multiply-adds over a
zero-padded input plus a boundary correction for the carried-in window,
added in the same order, so fp32 results match the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                          init: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Depthwise causal conv (VALID over [carry, x]) as K shifted
    multiply-adds.

    ``x``: (B, S, ch); ``w``: (K, ch); ``init``: optional (B, K-1, ch)
    carry-in from a previous chunk (zeros = sequence start).  Returns
    (B, S, ch).  The carry contributes only to the first K-1 outputs and is
    added as a correction rather than concatenated in."""
    B, S, ch = x.shape
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0][None, None]
    for k in range(1, K):
        out = out + xp[:, k:k + S] * w[k][None, None]
    if init is not None and K > 1:
        t_max = min(K - 1, S)
        rows = []
        for t in range(t_max):
            r = torch.zeros((B, ch), dtype=out.dtype, device=out.device)
            for k in range(K - 1 - t):
                r = r + init[:, t + k].to(out.dtype) * w[k][None]
            rows.append(r)
        out = torch.cat([out[:, :t_max] + torch.stack(rows, dim=1),
                         out[:, t_max:]], dim=1)
    return out
