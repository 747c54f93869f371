"""The port's attention functions against the reference's, on the CPU.

The plain versions of the four attention kernels (K1 paged decode with the
fused append, K2 paged prefill, K3 flash attention, K4 dense-cache decode)
are held to the reference's Pallas kernels run in interpret mode, the
port's ``ref`` functions and ``merge_partials`` to ``repro.kernels.ref``,
and the dense serving path (CDSP chunked prefill, hand-off, dense decode)
to the reference's tokens.  Inputs are
made with numpy from a seed and handed to both packages.  Tolerance: fp32
``atol = rtol = 1e-5`` (the two sides sum in different orders).  The bf16
tensor-core K2/K3's arithmetic is emulated in torch and held to the plain
versions under chip_smoke.py's elementwise check; the split decode kernel
of K1/K4 is emulated in its own order (tiles, splits, merge) and held to
the plain versions and the Pallas kernels, and its split planner is
checked to cover every page once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import paged_flash_prefill as j_prefill
from repro.kernels.flash_decode import flash_decode as j_dense_decode
from repro.kernels.flash_decode import paged_append_attend as j_append
from repro.kernels.flash_decode import paged_flash_decode as j_decode
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 paged_flash_prefill)
from repro_torch.kernels.flash_decode import (POS_PAD, _TARGET_BLOCKS,
                                              _TILE, flash_decode,
                                              flash_decode_plain,
                                              paged_flash_decode,
                                              paged_flash_decode_plain,
                                              plan_splits)

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
    (2, 64, 128, 12, 2, 32, None, 64),     # GQA group 6
    (1, 128, 128, 12, 2, 32, 24, 0),       # group 6, window
    (2, 64, 128, 16, 1, 32, None, 64),     # group 16
    (1, 128, 128, 16, 1, 32, 24, 0),       # group 16, window
    (2, 64, 128, 4, 4, 64, None, 64),      # head_dim 64 (Whisper), MHA
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


@pytest.mark.parametrize("B,Sq,Sk,H,KVH", [
    (2, 64, 256, 4, 4),      # Whisper's cross attention: Sq != Sk, MHA
    (1, 128, 128, 4, 4),     # its encoder: Sq = Sk
    (1, 64, 128, 8, 2),      # a GQA group of 4
])
def test_flash_attention_noncausal_d64_matches_pallas(B, Sq, Sk, H, KVH):
    """K3's plain version at head_dim 64 without the causal mask, as the
    encoder and the cross attention call it (key positions 0..Sk-1 for
    queries at other positions), against the Pallas kernel in interpret
    mode (which takes whole blocks: the ragged 1500 keys go to the card
    tests)."""
    rng = np.random.default_rng(9)
    D = 64
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    qp = np.arange(7, 7 + Sq, dtype=np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    want_o, want_l = j_flash(*map(jnp.asarray, (q, k, v, qp, kp)),
                             causal=False, interpret=True, with_lse=True)
    got_o, got_l = flash_attention(*map(torch.from_numpy, (q, k, v, qp, kp)),
                                   causal=False)
    _close(got_o, want_o)
    _close(got_l, want_l)
    o = ops.attention(*map(torch.from_numpy, (q, k, v, qp, kp)),
                      causal=False)
    _close(o, want_o)


# ------------------------------------------------------------------- K2
@pytest.mark.parametrize("hist,Sq,H,KVH,D,page,window", [
    ([24, 0], 16, 4, 2, 32, 8, None),       # page 8, a row without history
    ([45], 19, 4, 1, 32, 16, 20),           # ragged, window, group 4
    ([64, 33], 8, 2, 2, 128, 32, None),     # head_dim 128, page 32
    ([24, 0], 16, 12, 2, 32, 8, None),      # group 6
    ([45], 19, 12, 2, 32, 16, 20),          # group 6, window
    ([24, 0], 16, 16, 1, 32, 8, None),      # group 16
    ([45], 19, 16, 1, 32, 16, 20),          # group 16, window
    ([45, 20], 16, 4, 4, 64, 16, None),     # head_dim 64, MHA
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
    ([13, 0, 5], (1,), 12, 2, 32, 8, None, 0),     # group 6, padded row
    ([40, 17], (), 12, 2, 32, 16, 12, 2),          # group 6, window
    ([13, 0, 5], (1,), 16, 1, 32, 8, None, 0),     # group 16, padded row
    ([40, 17], (), 16, 1, 32, 16, 12, 2),          # group 16, window
    ([70, 3, 0], (2,), 4, 4, 64, 16, None, 1),     # head_dim 64, MHA
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


# ------------------------------------------------------------------- K4
@pytest.mark.parametrize("lengths,S,H,KVH,D,window,offset", [
    ([40, 64, 0], 64, 4, 2, 32, None, 0),   # ragged rows, an empty row
    ([300, 129], 512, 8, 2, 128, 50, 0),    # window, group 4, head_dim 128
    ([90, 20], 64, 4, 4, 32, None, 30),     # kv_offset (cache starts at 30)
    ([70, 45], 256, 8, 1, 32, 16, 10),      # window + offset, group 8
    ([40, 64, 0], 64, 12, 2, 32, None, 0),  # group 6, an empty row
    ([70, 45], 256, 12, 2, 32, 16, 10),     # group 6, window + offset
    ([40, 64, 0], 64, 16, 1, 32, None, 0),  # group 16, an empty row
    ([70, 45], 256, 16, 1, 32, 16, 10),     # group 16, window + offset
    ([256, 256], 256, 4, 4, 64, None, 0),   # Whisper's cross decode: every
                                            #   key valid, head_dim 64, MHA
    ([300, 129], 512, 8, 8, 64, 50, 0),     # head_dim 64, window
])
def test_flash_decode_plain_matches_pallas(lengths, S, H, KVH, D, window,
                                           offset):
    rng = np.random.default_rng(6)
    B = len(lengths)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    want_o, want_l = j_dense_decode(*map(jnp.asarray, (q, k, v, ln)),
                                    window=window, kv_offset=offset,
                                    with_lse=True, interpret=True)
    got_o, got_l = flash_decode(*map(torch.from_numpy, (q, k, v, ln)),
                                window=window, kv_offset=offset)
    _close(got_o, want_o)
    _close(got_l, want_l)
    assert flash_decode.launches == 0         # CPU tensors: plain version
    # the dispatcher's plain route is the reference's oracle, which agrees
    # wherever a row has a valid key
    live = np.asarray(want_l).max(axis=1) > ref.NEG_INF / 2
    o = ops.decode_attention(*map(torch.from_numpy, (q, k, v, ln)),
                             window=window, kv_offset=offset)
    _close(o[live], np.asarray(want_o)[live])


# ------------------------------- the split decode kernel's order (K1, K4)
@pytest.mark.parametrize("npg,B,KVH,page", [
    (97, 4, 8, 64),        # the smoke's decode batch
    (2049, 1, 8, 64),      # one row at 131,072 keys
    (1, 1, 1, 8), (3, 1, 1, 8), (40, 3, 2, 8), (19, 2, 2, 16),
    (7, 1, 4, 32), (5, 64, 8, 64), (1000, 256, 8, 128), (96, 1, 1, 48),
])
def test_plan_splits_covers_every_page_once(npg, B, KVH, page):
    """The split planner (a function of the table width, B and KVH only)
    cuts a row's pages into runs that cover each page exactly once, every
    run non-empty, and keeps full rows near the block target."""
    splits, pps = plan_splits(npg, B, KVH, page)
    assert splits >= 1 and pps >= 1
    runs = [range(s * pps, min(npg, (s + 1) * pps)) for s in range(splits)]
    assert all(len(r) > 0 for r in runs)
    assert sorted(j for r in runs for j in r) == list(range(npg))
    assert splits * B * KVH <= max(_TARGET_BLOCKS, B * KVH)
    if page < _TILE and _TILE % page == 0 and splits > 1:
        assert pps * page % _TILE == 0        # whole 64-key tiles per run


def _split_decode_emulation(q, k, v, lengths, *, table=None, page_pos=None,
                            window=None, kv_offset=0, k_new=None,
                            v_new=None, append_page=None, append_slot=None):
    """``csrc/paged_decode.cu`` in torch, in the kernel's order.  Paged
    (``table`` given): k/v are the pools as a block finds them, before the
    append lands; dense: the caches (B, S, KVH, D), cut into virtual pages
    of 64.  For each (row, KV head, split of ``plan_splits``): the split's
    keys cut to the valid positions where positions follow the flat index;
    64-key tiles whose rows without a valid key are zero-filled (the
    pool's unused slots may hold NaN) and whose append row is patched from
    k_new/v_new after the tile lands; scores in log2 units with the scale
    folded into q; per tile one max, one rescale and exp2 of the scores;
    then the merge of the splits by their maxima.  Returns ``(o, lse)``."""
    B, H, D = q.shape
    KVH = k.shape[-2]
    G = H // KVH
    dense = table is None
    page = _TILE if dense else k.shape[1]
    S = k.shape[1] if dense else None
    npg = -(-S // page) if dense else table.shape[1]
    append = k_new is not None
    length = (lengths + int(append)).tolist()
    splits, pps = plan_splits(npg, B, KVH, page)
    qs = q.float() * (D ** -0.5 * np.log2(np.e))
    NEG = float(ref.NEG_INF)
    o = torch.zeros(B, H, D)
    lse = torch.full((B, H), NEG)
    for b in range(B):
        L = length[b]
        for h in range(KVH):
            qh = qs[b, h * G:(h + 1) * G]                     # (G, D)
            parts = []
            for s in range(splits):
                f0 = s * pps * page
                f1 = min(npg, (s + 1) * pps) * page
                if dense:
                    f1 = min(f1, S)
                if dense or page_pos is None:
                    off = kv_offset if dense else 0
                    if window is not None and L - window - off > f0:
                        f0 += (L - window - off - f0) // _TILE * _TILE
                    f1 = min(f1, L - off)
                m = torch.full((G,), NEG)
                l = torch.zeros(G)
                acc = torch.zeros(G, D)
                for t0 in range(f0, f1, _TILE):
                    f = torch.arange(t0, t0 + _TILE)
                    inside = f < f1
                    fc = torch.where(inside, f, 0)
                    if dense:
                        pos = kv_offset + f
                        kt, vt = k[b, fc.clamp(max=S - 1), h], \
                            v[b, fc.clamp(max=S - 1), h]
                        new = torch.zeros(_TILE, dtype=torch.bool)
                    else:
                        j, t = fc // page, fc % page
                        base = (page_pos[b, j] if page_pos is not None
                                else j * page)
                        pos = base + t
                        phys = table[b, j].long()
                        kt, vt = k[phys, t, h], v[phys, t, h]
                        new = ((phys == int(append_page[b])) &
                               (t == int(append_slot[b])) if append else
                               torch.zeros(_TILE, dtype=torch.bool))
                    ok = inside & (pos < L)
                    if window is not None:
                        ok &= pos >= L - window
                    zero = torch.zeros((), dtype=kt.dtype)
                    kt = torch.where(ok[:, None], kt, zero)   # zero-fill
                    vt = torch.where(ok[:, None], vt, zero)
                    patch = (ok & new)[:, None]               # after landing
                    if append:
                        kt = torch.where(patch, k_new[b, h], kt)
                        vt = torch.where(patch, v_new[b, h], vt)
                    sc = torch.where(ok[:, None], kt.float() @ qh.T, NEG)
                    m_new = torch.maximum(m, sc.max(0).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.where(ok[:, None], torch.exp2(sc - m_new), 0.0)
                    l = l * alpha + p.sum(0)
                    acc = acc * alpha[:, None] + p.T @ vt.float()
                    m = m_new
                parts.append((m, l, acc))
            ms = torch.stack([pm for pm, _, _ in parts])      # (splits, G)
            ls = torch.stack([pl for _, pl, _ in parts])
            accs = torch.stack([pa for _, _, pa in parts])
            live = ls > 0
            M = torch.where(live, ms, NEG).max(0).values
            c = torch.where(live, torch.exp2(ms - M), 0.0)
            Lt = (ls * c).sum(0)
            A = (accs * c[:, :, None]).sum(0)
            alive = Lt > 0
            o[b, h * G:(h + 1) * G] = torch.where(
                alive[:, None], A / Lt.clamp_min(1e-30)[:, None], 0.0)
            lse[b, h * G:(h + 1) * G] = torch.where(
                alive, (M + torch.log2(Lt.clamp_min(1e-30))) * np.log(2.0),
                NEG)
    return o, lse


@pytest.mark.parametrize("lengths,pad_rows,H,KVH,D,page,window,extra", [
    ([130, 0, 5], (1,), 4, 4, 32, 8, None, 0),     # padded row, group 1
    ([300, 17], (), 4, 2, 32, 16, 40, 2),          # window + POS_PAD columns
    ([200, 3, 0], (2,), 8, 2, 128, 32, None, 1),   # head_dim 128, group 4
    ([700, 64], (), 16, 2, 32, 64, None, 0),       # group 8, many splits
    ([500], (), 8, 4, 128, 128, 130, 0),           # page 128, window
    ([300, 0, 90], (1,), 12, 2, 32, 16, 60, 1),    # group 6
    ([400, 70], (), 16, 1, 32, 8, None, 0),        # group 16, page 8
    ([300, 45], (), 4, 4, 64, 16, None, 0),        # head_dim 64, MHA
])
def test_split_decode_order_matches_plain_and_pallas(lengths, pad_rows, H,
                                                     KVH, D, page, window,
                                                     extra):
    """K1's order (per-tile max, one rescale per tile, zero-filled invalid
    rows, the append row patched after its tile lands, the merge of the
    splits) against the plain version on pools whose unused slots and
    append slot hold NaN, and against the Pallas paged_append_attend
    (interpret mode) on finite pools.  The appended key falls in a split
    other than the one that writes it."""
    rng = np.random.default_rng(7)
    B = len(lengths)
    n_pages = 3 * B * (max(lengths) // page + 2)
    kp, vp = _pools(rng, n_pages, page, KVH, D)
    bt, npg = _tables(rng, lengths, page, n_pages, extra_cols=extra)
    for r in pad_rows:
        bt[r] = n_pages
    page_pos = np.concatenate(
        [np.broadcast_to(np.arange(npg, dtype=np.int32) * page, (B, npg)),
         np.full((B, extra), POS_PAD, np.int32)], 1).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    ap = bt[np.arange(B), ln // page].astype(np.int32)
    sl = (ln % page).astype(np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    live = [r for r in range(B) if r not in pad_rows]
    splits, pps = plan_splits(bt.shape[1], B, KVH, page)
    assert max(ln[live] // page) >= pps       # append outside split 0
    T = torch.from_numpy
    pp = T(page_pos) if extra else None
    # NaN in every pool slot no live row reads, and in the append slots
    read = np.zeros(kp.shape[:2], bool)
    for r in live:
        for j in range(bt.shape[1]):
            pos = page_pos[r, j] + np.arange(page)
            ok = pos < ln[r] + 1
            if window is not None:
                ok &= pos >= ln[r] + 1 - window
            read[bt[r, j]] |= ok
    read[ap[live], sl[live]] = False
    kn_pool, vn_pool = kp.copy(), vp.copy()
    kn_pool[~read] = np.nan
    vn_pool[~read] = np.nan
    kw = dict(window=window, page_pos=pp, k_new=T(kn), v_new=T(vn),
              append_page=T(ap), append_slot=T(sl))
    emu_o, emu_l = _split_decode_emulation(T(q), T(kn_pool), T(vn_pool),
                                           T(ln), table=T(bt), **kw)
    want_o, want_l = paged_flash_decode_plain(
        T(q), T(kn_pool.copy()), T(vn_pool.copy()), T(bt), T(ln), **kw)
    _close(emu_o[live], want_o[live])
    _close(emu_l[live], want_l[live])
    j_o, j_l, _, _ = j_append(
        *map(jnp.asarray, (q, kp, vp, bt, ln, ap, sl, kn, vn, page_pos)),
        window=window, with_lse=True, impl="interpret")
    emu_o, emu_l = _split_decode_emulation(T(q), T(kp), T(vp), T(ln),
                                           table=T(bt), **kw)
    _close(emu_o[live], np.asarray(j_o)[live])
    _close(emu_l[live], np.asarray(j_l)[live])


@pytest.mark.parametrize("lengths,S,H,KVH,D,window,offset", [
    ([300, 129], 512, 8, 2, 128, 50, 0),    # window, group 4, head_dim 128
    ([90, 20], 64, 4, 4, 32, None, 30),     # kv_offset (cache starts at 30)
    ([70, 45], 256, 8, 1, 32, 16, 10),      # window + offset, group 8
    ([203, 0, 150], 203, 8, 2, 128, None, 0),  # S not a multiple of 64
    ([190, 77], 203, 4, 2, 32, 70, 7),      # ragged S, window, offset
    ([190, 0], 203, 12, 2, 32, 70, 7),      # group 6
    ([250, 30], 256, 16, 1, 32, None, 0),   # group 16
    ([1500, 1500], 1500, 4, 4, 64, None, 0),  # Whisper's cross decode:
                                              #   1500 keys, head_dim 64
])
def test_split_decode_order_dense_matches_plain_and_pallas(lengths, S, H, KVH,
                                                           D, window, offset):
    """K4's order (the same split kernel over virtual pages of a dense
    cache) against the plain version with NaN in every slot outside the
    valid window, and against the Pallas flash_decode (interpret mode)
    where its tiling takes S."""
    rng = np.random.default_rng(8)
    B = len(lengths)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    pos = offset + np.arange(S)
    ok = pos[None] < ln[:, None]
    if window is not None:
        ok &= pos[None] >= ln[:, None] - window
    kq, vq = k.copy(), v.copy()
    kq[~ok], vq[~ok] = np.nan, np.nan
    T = torch.from_numpy
    kw = dict(window=window, kv_offset=offset)
    emu_o, emu_l = _split_decode_emulation(T(q), T(kq), T(vq), T(ln), **kw)
    want_o, want_l = flash_decode_plain(T(q), T(kq), T(vq), T(ln), **kw)
    _close(emu_o, want_o)
    _close(emu_l, want_l)
    assert not emu_o[ln == 0].any()
    if S % 64 == 0:
        j_o, j_l = j_dense_decode(*map(jnp.asarray, (q, k, v, ln)),
                                  window=window, kv_offset=offset,
                                  with_lse=True, interpret=True)
        _close(emu_o, j_o)
        _close(emu_l, j_l)


def test_dense_path_tokens_match_reference(reduced_params_cache):
    """CDSP chunked prefill over a dense history, the hand-off to dense
    decode caches and greedy dense decode (K3 and K4 on the card) give the
    reference's tokens."""
    from repro.core.cdsp import chunked_prefill as j_chunked
    from repro.core.cdsp import history_to_decode_caches as j_handoff
    from repro.models.sharding import CPU_CTX as J_CTX
    from repro.models.transformer import forward as j_forward
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cdsp import (chunked_prefill,
                                       history_to_decode_caches)
    from repro_torch.models.params import params_from_numpy
    from repro_torch.models.sharding import CPU_CTX
    from repro_torch.models.transformer import forward
    jcfg, jp = reduced_params_cache("llama3-8b")
    cfg = get_config("llama3-8b").reduced()
    tp = params_from_numpy(jp, cfg, device="cpu")
    S, chunks, n = 40, [16, 7, 17], 5
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                            (1, S)).astype(np.int32)
    pos = np.arange(S, dtype=np.int32)[None]

    def run(fwd, chunked, handoff, asarray, argmax, P, C):
        logits, hist = chunked(P, C, ctx, asarray(tok), asarray(pos), chunks)
        caches, clen = handoff(C, hist, max_seq=S + n)
        out = [int(argmax(logits[0, 0, :C.vocab_size]))]
        for i in range(n - 1):
            c = np.full((1,), S + i, np.int32)
            logits, _, caches = fwd(P, C, ctx, asarray([[out[-1]]]),
                                    asarray(c[:, None]), "decode",
                                    caches=caches, cache_len=asarray(c))
            out.append(int(argmax(logits[0, 0, :C.vocab_size])))
        return out

    ctx = J_CTX
    want = run(j_forward, j_chunked, j_handoff, jnp.asarray, jnp.argmax, jp,
               jcfg)
    ctx = CPU_CTX
    got = run(forward, chunked_prefill, history_to_decode_caches,
              lambda a: torch.as_tensor(np.asarray(a)), torch.argmax, tp,
              cfg)
    assert got == want


# ------------------------------------- the tensor-core kernels' arithmetic
def _tc_emulation(q, k, v, q_pos, kv_pos, kv_valid, *, p_tail=True, bk=64):
    """The bf16 K2/K3 kernel's arithmetic in torch: key rows that are not
    valid zero-filled before any product, S = Q.K^T in fp32 from bf16
    inputs, scaled to log2 units and masked by select, an online softmax
    over ``bk``-key tiles with l summed from the fp32 P, and O += P.V in
    fp32 with P rounded to a bf16 head plus (``p_tail``) the bf16 rounding
    of its remainder.  Causal masks; q/k/v (B, S, heads, D) bf16."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    zero = torch.zeros((), dtype=k.dtype)
    k = torch.where(kv_valid[:, :, None, None], k, zero)
    v = torch.where(kv_valid[:, :, None, None], v, zero)
    kf = k.float().repeat_interleave(G, 2)
    vf = v.float().transpose(1, 2).repeat_interleave(G, 1)   # (B, H, Sk, D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (
        D ** -0.5 * np.log2(np.e))
    ok = kv_valid[:, None, :] & (kv_pos[:, None, :] <= q_pos[:, :, None])
    s = torch.where(ok[:, None], s, -torch.inf)
    m = torch.full((B, H, Sq), -torch.inf)
    l = torch.zeros(B, H, Sq)
    o = torch.zeros(B, H, Sq, D)
    for t in range(0, s.shape[-1], bk):
        st = s[..., t:t + bk]
        m_new = torch.maximum(m, st.amax(-1))
        mu = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(st - mu[..., None])
        l = l * alpha + p.sum(-1)
        head = p.bfloat16().float()
        pv = head + (p - head).bfloat16().float() if p_tail else head
        o = o * alpha[..., None] + pv @ vf[:, :, t:t + bk]
        m = m_new
    o = torch.where(l[..., None] > 0, o / l[..., None].clamp_min(1e-30), 0.0)
    return o.transpose(1, 2).to(q.dtype)


def _smoke_ratio(got, want, atol=1e-3, rtol=1e-2):
    """chip_smoke.py's elementwise check for bf16 o: passes at <= 1."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


def _tc_case(kernel, p_tail):
    """(emulated o, plain o) at a reduced main-like shape: Sq = Sk = 512,
    H 8, KVH 2, D 128, bf16 from a numpy seed.  K2's history is 500 keys
    in shuffled 64-token pages whose unused slots hold NaN."""
    rng = np.random.default_rng(6)
    Sq, H, KVH, D = 512, 8, 2, 128

    def bf16(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).bfloat16()

    q = bf16(1, Sq, H, D)
    pos = torch.arange(Sq, dtype=torch.int32)
    if kernel == "flash_attention":
        k, v = bf16(1, Sq, KVH, D), bf16(1, Sq, KVH, D)
        want, _ = flash_attention(q, k, v, pos, pos)
        got = _tc_emulation(q, k, v, pos[None], pos[None],
                            torch.ones(1, Sq, dtype=torch.bool),
                            p_tail=p_tail)
        return got, want
    hist, page = 500, 64
    npg = -(-hist // page)
    n_pages = npg + 3
    table = torch.from_numpy(
        rng.permutation(n_pages)[:npg].astype(np.int32))[None]
    pools = []
    for _ in range(2):
        pool = torch.full((n_pages, page, KVH, D), float("nan"),
                          dtype=torch.bfloat16)
        pool[table[0].long()] = bf16(npg, page, KVH, D)
        pool[table[0, -1].long(), hist % page:] = float("nan")
        pools.append(pool)
    hl = torch.tensor([hist], dtype=torch.int32)
    qpos = hist + pos[None]
    want, _ = paged_flash_prefill(q, *pools, table, hl, qpos)
    # the kernel reads each key row through the table
    kg, vg = (p[table.long()].reshape(1, npg * page, KVH, D) for p in pools)
    j = torch.arange(npg * page, dtype=torch.int32)[None]
    got = _tc_emulation(q, kg, vg, qpos, j, j < hist, p_tail=p_tail)
    return got, want


@pytest.mark.parametrize("kernel", ["flash_attention", "paged_flash_prefill"])
def test_tensor_core_arithmetic_fits_the_smoke_check(kernel):
    """The bf16 kernels' one numerical change against their plain versions
    (P.V from bf16 head + tail fragments of P, zero-filled invalid keys)
    stays inside chip_smoke.py's fixed elementwise check."""
    got, want = _tc_case(kernel, p_tail=True)
    assert torch.isfinite(got.float()).all()
    assert _smoke_ratio(got, want) <= 1.0


def test_one_bf16_rounding_of_p_misses_the_smoke_check():
    """Why the kernels keep P's tail: with P rounded once to bf16, the
    causal rows whose terms cancel leave the elementwise check."""
    got, want = _tc_case("flash_attention", p_tail=False)
    assert _smoke_ratio(got, want) > 1.0


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
