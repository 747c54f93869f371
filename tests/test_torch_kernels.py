"""The port's attention functions against the reference's, on the CPU.

The plain versions of the three CUDA kernels (K1 paged decode with the
fused append, K2 paged prefill, K3 flash attention) are held to the
reference's Pallas kernels run in interpret mode, and the port's ``ref``
functions and ``merge_partials`` to ``repro.kernels.ref``.  Inputs are
made with numpy from a seed and handed to both packages.  Tolerance: fp32
``atol = rtol = 1e-5`` (the two sides sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import paged_flash_prefill as j_prefill
from repro.kernels.flash_decode import paged_append_attend as j_append
from repro.kernels.flash_decode import paged_flash_decode as j_decode
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 paged_flash_prefill)
from repro_torch.kernels.flash_decode import POS_PAD, paged_flash_decode

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _pools(rng, n_pages, page, KVH, D):
    shape = (n_pages + 1, page, KVH, D)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _tables(rng, lengths, page, n_pages, extra_cols=0):
    """Shuffled page tables covering ``lengths + 1`` tokens per row, plus
    ``extra_cols`` scratch columns (page id ``n_pages``)."""
    npg = max(-(-(int(L) + 1) // page) for L in lengths)
    perm = rng.permutation(n_pages)
    bt = perm[:len(lengths) * npg].reshape(len(lengths), npg)
    if extra_cols:
        bt = np.concatenate(
            [bt, np.full((len(lengths), extra_cols), n_pages)], 1)
    return bt.astype(np.int32), npg


# ------------------------------------------------------------------- K3
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,window,offset", [
    (2, 64, 128, 4, 2, 32, None, 64),      # chunk after a history prefix
    (1, 128, 128, 4, 1, 32, 16, 0),        # window, GQA group 4
    (1, 32, 32, 2, 2, 32, None, -8),       # rows with no valid key
    (1, 128, 128, 8, 2, 128, None, 0),     # head_dim 128
])
def test_flash_attention_plain_matches_pallas(B, Sq, Sk, H, KVH, D, window,
                                              offset):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    qp = np.arange(offset, offset + Sq, dtype=np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    want_o, want_l = j_flash(*map(jnp.asarray, (q, k, v, qp, kp)),
                             causal=True, window=window, interpret=True,
                             with_lse=True)
    got_o, got_l = flash_attention(*map(torch.from_numpy, (q, k, v, qp, kp)),
                                   causal=True, window=window)
    _close(got_o, want_o)
    _close(got_l, want_l)
    assert flash_attention.launches == 0      # CPU tensors: plain version


# ------------------------------------------------------------------- K2
@pytest.mark.parametrize("hist,Sq,H,KVH,D,page,window", [
    ([24, 0], 16, 4, 2, 32, 8, None),       # page 8, a row without history
    ([45], 19, 4, 1, 32, 16, 20),           # ragged, window, group 4
    ([64, 33], 8, 2, 2, 128, 32, None),     # head_dim 128, page 32
])
def test_paged_prefill_plain_matches_pallas(hist, Sq, H, KVH, D, page,
                                            window):
    rng = np.random.default_rng(1)
    B = len(hist)
    n_pages = 4 * B * (max(hist) // page + 2)
    kp, vp = _pools(rng, n_pages, page, KVH, D)
    bt, _ = _tables(rng, hist, page, n_pages)
    hl = np.asarray(hist, np.int32)
    qpos = (hl[:, None] + np.arange(Sq, dtype=np.int32)[None]).astype(
        np.int32)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    want_o, want_l = j_prefill(*map(jnp.asarray, (q, kp, vp, bt, hl, qpos)),
                               causal=True, window=window, interpret=True)
    got_o, got_l = paged_flash_prefill(
        *map(torch.from_numpy, (q, kp, vp, bt, hl, qpos)), causal=True,
        window=window)
    _close(got_o, want_o)
    _close(got_l, want_l)


# ------------------------------------------------------------------- K1
@pytest.mark.parametrize("lengths,pad_rows,H,KVH,D,page,window,extra", [
    ([13, 0, 5], (1,), 4, 4, 32, 8, None, 0),      # padded row, group 1
    ([40, 17], (), 4, 2, 32, 16, 12, 2),           # window + POS_PAD columns
    ([70, 3, 0], (2,), 8, 2, 128, 32, None, 1),    # head_dim 128, group 4
])
def test_paged_decode_fused_append_matches_pallas(lengths, pad_rows, H, KVH,
                                                  D, page, window, extra):
    rng = np.random.default_rng(2)
    B = len(lengths)
    n_pages = 3 * B * (max(lengths) // page + 2)
    kp, vp = _pools(rng, n_pages, page, KVH, D)
    bt, npg = _tables(rng, lengths, page, n_pages, extra_cols=extra)
    for r in pad_rows:
        bt[r] = n_pages                       # idle row: all scratch
    page_pos = np.concatenate(
        [np.broadcast_to(np.arange(npg, dtype=np.int32) * page, (B, npg)),
         np.full((B, extra), POS_PAD, np.int32)], 1).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    ap = bt[np.arange(B), ln // page].astype(np.int32)
    sl = (ln % page).astype(np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    want_o, want_l, want_k, want_v = j_append(
        *map(jnp.asarray, (q, kp, vp, bt, ln, ap, sl, kn, vn, page_pos)),
        window=window, with_lse=True, impl="interpret")
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got_o, got_l = paged_flash_decode(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
        torch.from_numpy(ln), window=window,
        page_pos=torch.from_numpy(page_pos), k_new=torch.from_numpy(kn),
        v_new=torch.from_numpy(vn), append_page=torch.from_numpy(ap),
        append_slot=torch.from_numpy(sl))
    live = [r for r in range(B) if r not in pad_rows]
    _close(got_o[live], np.asarray(want_o)[live])
    _close(got_l[live], np.asarray(want_l)[live])
    # the append landed in place, byte for byte (the scratch page holds
    # whichever padded row wrote last, on either side)
    np.testing.assert_array_equal(tk[:-1].numpy(), np.asarray(want_k)[:-1])
    np.testing.assert_array_equal(tv[:-1].numpy(), np.asarray(want_v)[:-1])


def test_paged_decode_all_masked_rows_match_pallas():
    """Rows with nothing to attend (length 0, or every column at POS_PAD)
    give o = 0 and lse = -1e30 on both sides."""
    rng = np.random.default_rng(3)
    B, H, KVH, D, page, n_pages = 3, 4, 2, 32, 8, 12
    kp, vp = _pools(rng, n_pages, page, KVH, D)
    bt = rng.permutation(n_pages)[:B * 2].reshape(B, 2).astype(np.int32)
    ln = np.asarray([0, 9, 5], np.int32)
    page_pos = np.asarray([[0, 8], [0, 8], [POS_PAD, POS_PAD]], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    want_o, want_l = j_decode(*map(jnp.asarray, (q, kp, vp, bt, ln)),
                              page_pos=jnp.asarray(page_pos), interpret=True,
                              with_lse=True)
    got_o, got_l = paged_flash_decode(
        *map(torch.from_numpy, (q, kp, vp, bt, ln)),
        page_pos=torch.from_numpy(page_pos))
    _close(got_o, want_o)
    _close(got_l, want_l)
    assert float(got_l[0].max()) == float(np.float32(ref.NEG_INF))
    assert not got_o[2].any()


# ------------------------------------------------- ref.py and the dispatcher
def test_merge_partials_matches_reference():
    rng = np.random.default_rng(4)
    outs = [rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
            for _ in range(3)]
    lses = [rng.standard_normal((2, 4, 5)).astype(np.float32) * 3
            for _ in range(3)]
    lses[1][0, 0, :] = ref.NEG_INF          # an empty part
    want_o, want_l = jref.merge_partials([jnp.asarray(o) for o in outs],
                                         [jnp.asarray(l) for l in lses])
    got_o, got_l = ref.merge_partials([torch.from_numpy(o) for o in outs],
                                      [torch.from_numpy(l) for l in lses])
    _close(got_o, want_o)
    _close(got_l, want_l)


def test_ref_functions_match_reference():
    rng = np.random.default_rng(5)
    B, Sq, Sk, H, KVH, D, page = 2, 6, 20, 4, 2, 16, 4
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    qp = np.arange(14, 20, dtype=np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    valid = rng.random((B, Sk)) > 0.2
    T = torch.from_numpy
    for window in (None, 5):
        want = jref.attention_ref(*map(jnp.asarray, (q, k, v, qp, kp)),
                                  window=window, kv_valid=jnp.asarray(valid),
                                  with_lse=True)
        got = ref.attention_ref(*map(T, (q, k, v, qp, kp)), window=window,
                                kv_valid=T(valid), with_lse=True)
        for g, w in zip(got, want):
            _close(g, w)
    lengths = np.asarray([7, 20], np.int32)
    want = jref.decode_attention_ref(jnp.asarray(q[:, 0]), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     window=6, with_lse=True, kv_offset=2)
    got = ref.decode_attention_ref(T(q[:, 0]), T(k), T(v), T(lengths),
                                   window=6, with_lse=True, kv_offset=2)
    for g, w in zip(got, want):
        _close(g, w)
    n_pages = 12
    kpool, vpool = _pools(rng, n_pages, page, KVH, D)
    bt = rng.permutation(n_pages)[:B * 5].reshape(B, 5).astype(np.int32)
    pp = (np.arange(5, dtype=np.int32) * page)[None].repeat(B, 0)
    want = jref.paged_decode_attention_ref(
        *map(jnp.asarray, (q[:, 0], kpool, vpool, bt, lengths)), window=9,
        with_lse=True, page_pos=jnp.asarray(pp))
    got = ref.paged_decode_attention_ref(
        *map(T, (q[:, 0], kpool, vpool, bt, lengths)), window=9,
        with_lse=True, page_pos=T(pp))
    for g, w in zip(got, want):
        _close(g, w)
    hist = np.asarray([14, 9], np.int32)
    qpos = (hist[:, None] + np.arange(Sq)[None]).astype(np.int32)
    args = (q, k[:, :Sq], v[:, :Sq], qpos, qpos, kpool, vpool, bt, hist)
    want = jops.paged_prefill_attention(*map(jnp.asarray, args), window=7,
                                        impl="ref")
    got = ops.paged_prefill_attention(*map(T, args), window=7)
    _close(got, want)
    # the card's composition (K2 over pages, K3 over the chunk, merged by
    # LSE) equals the single softmax, run here through the plain versions
    o_h, l_h = paged_flash_prefill(T(q), T(kpool), T(vpool), T(bt), T(hist),
                                   T(qpos), window=7)
    o_s, l_s = flash_attention(T(q), T(k[:, :Sq]), T(v[:, :Sq]), T(qpos),
                               T(qpos), window=7)
    _close(ref.merge_partials([o_h, o_s], [l_h, l_s])[0], want)


def test_dispatch_rules():
    q = torch.zeros((1, 4, 2, 32))
    k = torch.zeros((1, 4, 2, 32))
    pos = torch.arange(4, dtype=torch.int32)
    assert not ops.use_kernel(q, None) and not ops.use_kernel(q, "ref")
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, k, k, pos, pos, impl="pallas")
