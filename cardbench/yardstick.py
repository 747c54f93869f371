"""The yardstick: the card's peaks and the useful work of a step and of
each kernel call, counted from shapes.

Peaks: NVIDIA's data sheet for the H100 SXM (dense bf16 989 TFLOP/s,
HBM3 3.35 TB/s), as ``repro_torch.launch.roofline`` states them.

A step's useful work (``chunk_flops``, ``tick_flops``) follows
``repro_torch.launch.roofline.model_flops`` (copied): two operations a
weight a token, and 4 d operations an attention pair (q.k and p.v), a
causal chunk counting its L^2 / 2 own pairs and every pair with its
history.  Where it differs it counts less: the embedding is a lookup and
no product, and the head runs only for the rows whose logits are used
(one a chunk, one a decode row); Mamba-2's state update adds its
recurrence, 4 H P N a token a layer.

A kernel call's least time is max(flops / peak, bytes / bandwidth) with
its useful flops and each input and output byte counted once.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense, one H100 SXM
HBM_BW = 3.35e12             # bytes/s, one H100 SXM


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def weight_counts(layout: dict) -> dict:
    """Weights of the layout that are products (matrices of the stacked
    blocks), and the head's (vocabulary x d)."""
    mats = 0

    def walk(tree):
        nonlocal mats
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            elif len(v) >= 3:
                mats += _numel(v)

    walk(layout["blocks"])
    return {"matrices": mats}


class StepWork:
    """Useful operations of a configuration's prefill chunks and decode
    rows.  ``c`` is the configuration file; ``layout`` its weight tree's
    shapes (``families/<family>.layout``)."""

    def __init__(self, c: dict, layout: dict):
        self.mats = weight_counts(layout)["matrices"]
        self.head = c["vocab_size"] * (c.get("hidden_size") or c["d_model"])
        if c["family"] == "llama":
            H = c["num_attention_heads"]
            D = c.get("head_dim") or c["hidden_size"] // H
            self.attn = 4.0 * H * D * c["num_hidden_layers"]   # a pair
            self.ssd = 0.0
        else:
            d_in = c["expand"] * c["d_model"]
            self.attn = 0.0
            self.ssd = 4.0 * d_in * c["d_state"] * c["n_layer"]  # a token

    def chunk_flops(self, off: int, L: int) -> float:
        """A chunk of ``L`` tokens after ``off`` of history."""
        return (2.0 * self.mats * L + 2.0 * self.head + self.ssd * L
                + self.attn * (L * off + L * L / 2.0))

    def row_flops(self, cache_len: int) -> float:
        """One decode row over ``cache_len`` earlier tokens (the new
        token attends to them and to itself)."""
        return (2.0 * self.mats + 2.0 * self.head + self.ssd
                + self.attn * (cache_len + 1))


# --------------------------------------------------------------- kernels
def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


def k3_work(B, S, H, D, Skv, KVH, elem: int, causal: bool) -> tuple:
    """Flash attention over a chunk's own KV: (flops, bytes)."""
    pairs = S * (S + 1) / 2.0 if causal and S == Skv else float(S * Skv)
    flops = 4.0 * B * H * D * pairs
    nbytes = elem * B * (2 * S * H * D + 2 * Skv * KVH * D) + 4 * B * S * H
    return flops, nbytes


def k2_work(B, S, H, D, hist, KVH, elem: int) -> tuple:
    """Paged prefill attention of S queries over ``hist`` history tokens
    (all visible): (flops, bytes)."""
    flops = 4.0 * B * H * D * S * hist
    nbytes = elem * B * (2 * S * H * D + 2 * hist * KVH * D) + 4 * B * S * H
    return flops, nbytes


def k1_work(lengths, H, D, KVH, elem: int) -> tuple:
    """Paged decode with the append: each live row (length > 0) attends
    over its length + 1 keys; reads q, its keys and values, writes o and
    the new key and value: (flops, bytes)."""
    keys = sum(int(n) + 1 for n in lengths if int(n) > 0)
    rows = sum(1 for n in lengths if int(n) > 0)
    flops = 4.0 * H * D * keys
    nbytes = elem * (2 * keys * KVH * D + 2 * rows * H * D) + 4 * rows * H
    return flops, nbytes


def k5_work(B, S, H, P, G, N, elem: int, h0: bool) -> tuple:
    """The SSD scan of S steps: the recurrence's operations (4 P N a head
    a step); reads x, dt, B, C (and h0), writes y and the final state:
    (flops, bytes)."""
    flops = 4.0 * B * S * H * P * N
    nbytes = (elem * B * S * (2 * H * P + 2 * G * N) + 4 * B * S * H
              + 4 * B * H * P * N * (2 if h0 else 1))
    return flops, nbytes
