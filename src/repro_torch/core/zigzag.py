"""Zigzag sequence layout for load-balanced causal ring attention.

For N sequence-parallel shards the sequence is cut into 2N equal slices
S_0..S_{2N-1}; shard i holds (S_i, S_{2N-1-i}).  Under a causal mask every
shard then owns the same amount of attention work (Sec. 2.3 of the paper).

The layout is a permutation: tensors are stored in "shard order" (shard
0's tokens first, ...), and explicit position arrays carry the true token
positions — the attention kernels mask on positions, so no other code
needs to know about zigzag.  The permutations are numpy; the shard /
unshard helpers take tensors (reference core/zigzag.py).
"""

from __future__ import annotations

import numpy as np
import torch


def zigzag_permutation(seq_len: int, n_shards: int) -> np.ndarray:
    """perm[j] = original position of the j-th token in shard order."""
    if seq_len % (2 * n_shards):
        raise ValueError(f"{seq_len} tokens do not cut into "
                         f"{2 * n_shards} equal slices")
    slc = seq_len // (2 * n_shards)
    order = []
    for i in range(n_shards):
        order.append(np.arange(i * slc, (i + 1) * slc))
        j = 2 * n_shards - 1 - i
        order.append(np.arange(j * slc, (j + 1) * slc))
    return np.concatenate(order)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


def _take(x: torch.Tensor, perm: np.ndarray, dim: int) -> torch.Tensor:
    return torch.index_select(x, dim, torch.as_tensor(perm,
                                                      device=x.device))


def zigzag_shard(x: torch.Tensor, n_shards: int, dim: int = 1
                 ) -> torch.Tensor:
    """Reorder ``dim`` into zigzag shard order (then shard it
    contiguously)."""
    return _take(x, zigzag_permutation(x.shape[dim], n_shards), dim)


def zigzag_unshard(x: torch.Tensor, n_shards: int, dim: int = 1
                   ) -> torch.Tensor:
    return _take(x, inverse_permutation(
        zigzag_permutation(x.shape[dim], n_shards)), dim)


def zigzag_positions(seq_len: int, n_shards: int, offset: int = 0,
                     device=None) -> torch.Tensor:
    """Global positions in shard order, (seq_len,) int32."""
    return torch.as_tensor(zigzag_permutation(seq_len, n_shards) + offset,
                           dtype=torch.int32, device=device)


def striped_permutation(seq_len: int, n_shards: int) -> np.ndarray:
    """Striped Attention layout: round-robin token stripes (for
    comparison)."""
    if seq_len % n_shards:
        raise ValueError(f"{seq_len} tokens do not stripe over {n_shards}")
    return np.arange(seq_len).reshape(-1, n_shards).T.reshape(-1)


def workload_imbalance(perm: np.ndarray, n_shards: int) -> float:
    """max/mean causal-mask work across shards (1.0 = balanced)."""
    S = perm.size
    per_shard = perm.reshape(n_shards, S // n_shards)
    # work of shard i = sum over its query positions p of (p + 1)
    work = (per_shard.astype(np.int64) + 1).sum(axis=1)
    return float(work.max() / work.mean())
