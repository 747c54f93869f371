"""Card-only tests of the port: the hand-written CUDA kernels against their
plain versions, and one full-width MoE layer in bf16 against fp32 on the
CPU.  They skip without a CUDA device (the kernels have no CPU mode).
This file imports neither jax nor the reference package, so it also runs
where only the port is installed:

    python3 -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import os
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """Every kernel against its plain version at the edge cases of
    ``chip_smoke.py``: page sizes 8-64, head_dim 32/64/128, GQA groups 1-16,
    windows, POS_PAD columns, masked and padded rows, ragged tails, K3 key
    positions permuted within and across tiles, chunks of 17 queries, the
    fused append's pool bytes, dense caches of any length with an offset,
    and SSD scans with ragged, sub-chunk and grouped inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    chip_smoke.phase_kernels(full_shapes=False)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    return torch.device("cuda")


@pytest.mark.cuda
def test_dense_decode_kernel_on_card():
    """K4 against its plain version: a row with no valid key, a window, a
    cache offset, a length that is not a multiple of the split page."""
    dev = _card()
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    g = torch.Generator().manual_seed(0)
    for dtype, atol, rtol in ((torch.float32, 1e-5, 1e-4),
                              (torch.bfloat16, 1e-3, 1e-2)):
        q = torch.randn(3, 8, 128, generator=g).to(dev, dtype)
        k = torch.randn(3, 203, 2, 128, generator=g).to(dev, dtype)
        v = torch.randn(3, 203, 2, 128, generator=g).to(dev, dtype)
        ln = torch.tensor([203, 0, 150], dtype=torch.int32, device=dev)
        for kw in ({}, {"window": 40}, {"kv_offset": 7}):
            before = flash_decode.launches
            o, lse = flash_decode(q, k, v, ln, **kw)
            po, plse = flash_decode_plain(q, k, v, ln, **kw)
            assert flash_decode.launches == before + 1
            torch.testing.assert_close(o.float(), po.float(), atol=atol,
                                       rtol=rtol)
            torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)
            assert not o[1].any()


@pytest.mark.cuda
def test_ssd_scan_kernel_on_card():
    """K5 against its plain version: a ragged tail, a handed-in state,
    grouped B/C, and x/B/C read in place from one fused projection."""
    dev = _card()
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    g = torch.Generator().manual_seed(1)
    B, S, H, P, G, N = 2, 333, 8, 64, 2, 128
    for dtype, atol, rtol in ((torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, 1e-3, 1e-2)):
        xbc = torch.randn(B, S, H * P + 2 * G * N, generator=g).to(dev,
                                                                   dtype)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
        Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
        dt = torch.empty(B, S, H).uniform_(1e-3, 1e-1, generator=g).to(dev)
        A = -torch.empty(H).uniform_(1.0, 16.0, generator=g).to(dev)
        h0 = torch.randn(B, H, P, N, generator=g).to(dev)
        before = ssd_scan.launches
        y, h = ssd_scan(x, dt, A, Bm, Cm, h0=h0, chunk=128)
        py, ph = ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0, chunk=128)
        assert ssd_scan.launches == before + 1
        torch.testing.assert_close(y.float(), py.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(h, ph, atol=1e-4, rtol=1e-4)


# (P, N) pairs K5 is built for: repro_torch.kernels.ssd_scan.SHAPES
_SSD_SHAPES = [(64, 128), (32, 64), (16, 32), (16, 16)]


def _ssd_case(dev, g, B, S, H, P, G, N):
    """bf16 x, B and C as slices of one fused projection, dt and A in the
    model's ranges, and a handed-in state."""
    d_in, gn = H * P, G * N
    xbc = torch.randn(B, S, d_in + 2 * gn, generator=g).to(dev,
                                                          torch.bfloat16)
    x = xbc[..., :d_in].reshape(B, S, H, P)
    Bm = xbc[..., d_in:d_in + gn].reshape(B, S, G, N)
    Cm = xbc[..., d_in + gn:].reshape(B, S, G, N)
    dt = torch.exp(torch.empty(B, S, H).uniform_(-6.9, -2.3,
                                                 generator=g)).to(dev)
    A = -torch.empty(H).uniform_(1.0, 16.0, generator=g).to(dev)
    h0 = (0.3 * torch.randn(B, H, P, N, generator=g)).to(dev)
    return x, dt, A, Bm, Cm, h0


def _check_ssd(x, dt, A, Bm, Cm, h0, chunk):
    """K5 against its plain version under chip_smoke.py's check: y
    elementwise at bf16's 1e-3 / 1e-2, h_final at 1e-4 / 1e-4."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    before = ssd_scan.launches
    y, h = ssd_scan(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)
    py, ph = ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert torch.isfinite(y.float()).all()
    _bf16_close(y, py)
    torch.testing.assert_close(h, ph, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 32, 64, 256])
@pytest.mark.parametrize("P,N", _SSD_SHAPES)
def test_ssd_scan_bf16_shapes_on_card(P, N, chunk):
    """bf16 K5 at every (P, N) it is built for and at chunks of 1 to 256
    tokens, with a ragged last chunk, two batch rows, G = 2 and x/B/C
    read in place from a fused projection."""
    dev = _card()
    from repro_torch.kernels.ssd_scan import SHAPES
    assert sorted(SHAPES) == sorted(_SSD_SHAPES)
    g = torch.Generator().manual_seed(10)
    S = 37 if chunk == 1 else 2 * chunk + 29
    _check_ssd(*_ssd_case(dev, g, 2, S, 4, P, 2, N), chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("h0", [True, False])
def test_ssd_scan_bf16_groups4_on_card(h0):
    """bf16 K5 with G = 4 groups of four heads at the Mamba-2 head shape
    (P 64, N 128), a ragged last chunk, with and without a handed-in
    state."""
    dev = _card()
    g = torch.Generator().manual_seed(11)
    x, dt, A, Bm, Cm, hz = _ssd_case(dev, g, 1, 700, 16, 64, 4, 128)
    _check_ssd(x, dt, A, Bm, Cm, hz if h0 else None, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["x", "Bm", "Cm", "h0", "row"])
def test_ssd_scan_raises_on_unaligned_bf16(which):
    """bf16 K5 copies x, B and C 16 bytes at a time and reads h0 as
    float4: x, B or C one element off 16 bytes, h0 one float off, or a
    fused projection whose row is one element wider than whole 16 bytes
    raises at launch instead of faulting, and the card stays usable."""
    dev = _card()
    from repro_torch.kernels.ssd_scan import ssd_scan
    g = torch.Generator().manual_seed(12)
    B, S, H, P, G, N = 1, 100, 2, 64, 1, 128
    d_in, gn = H * P, G * N
    # x, B and C with 8 elements between them, one shifted by an element
    starts = {"x": 0, "Bm": d_in + 8, "Cm": d_in + gn + 16}
    if which in starts:
        starts[which] += 1
    xbc = torch.randn(B, S, d_in + 2 * gn + 24 + int(which == "row"),
                      generator=g).to(dev, torch.bfloat16)
    x = xbc[..., starts["x"]:starts["x"] + d_in].reshape(B, S, H, P)
    Bm = xbc[..., starts["Bm"]:starts["Bm"] + gn].reshape(B, S, G, N)
    Cm = xbc[..., starts["Cm"]:starts["Cm"] + gn].reshape(B, S, G, N)
    dt = torch.exp(torch.empty(B, S, H).uniform_(-6.9, -2.3,
                                                 generator=g)).to(dev)
    A = -torch.empty(H).uniform_(1.0, 16.0, generator=g).to(dev)
    h = (0.3 * torch.randn(B * H * P * N + 1, generator=g)).to(dev)
    h0 = (h[1:] if which == "h0" else h[:-1]).view(B, H, P, N)
    before = ssd_scan.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_scan(x, dt, A, Bm, Cm, h0=h0, chunk=64)
    assert ssd_scan.launches == before
    _check_ssd(*_ssd_case(dev, g, B, S, H, P, G, N), 64)


def _bf16_close(o, po):
    """chip_smoke.py's elementwise check for bf16 o."""
    o, po = o.float(), po.float()
    assert bool(((o - po).abs() <= 1e-3 + 1e-2 * po.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("page", [8, 16, 32, 64, 128, 48])
def test_paged_prefill_nan_slots_inside_a_tile_on_card(page):
    """K2 in bf16 at Llama-3-8B's heads with hist_len 3001, a multiple of
    none of the page sizes: the last page's unused slots hold NaN and fall
    inside a key tile, which the tensor-core kernel must zero before its
    products.
    Pages 8-128 load by TMA; 48 (neither divides the other's 64-key tile)
    by cp.async."""
    dev = _card()
    import chip_smoke
    from repro_torch.kernels.flash_attention import (
        paged_flash_prefill, paged_flash_prefill_plain)
    g = torch.Generator().manual_seed(2)
    hist, Sq = 3001, 200
    q = torch.randn(1, Sq, 32, 128, generator=g).to(dev, torch.bfloat16)
    kd = torch.randn(1, hist, 8, 128, generator=g).to(dev, torch.bfloat16)
    vd = torch.randn(1, hist, 8, 128, generator=g).to(dev, torch.bfloat16)
    kp, table = chip_smoke._pool_from_dense(kd, page, g.manual_seed(3))
    vp, _ = chip_smoke._pool_from_dense(vd, page, g.manual_seed(3))
    last = table[0, -1].long()
    kp[last, hist % page:] = float("nan")
    vp[last, hist % page:] = float("nan")
    hl = torch.tensor([hist], dtype=torch.int32, device=dev)
    qp = hist + torch.arange(Sq, dtype=torch.int32, device=dev)[None]
    o, lse = paged_flash_prefill(q, kp, vp, table, hl, qp)
    po, plse = paged_flash_prefill_plain(q, kp, vp, table, hl, qp)
    assert torch.isfinite(o.float()).all()
    _bf16_close(o, po)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_prefill_kernels_raise_on_unaligned_bf16(which):
    """bf16 K2 and K3 read q, k and v 16 bytes at a time: a contiguous
    view at an odd element offset raises at launch instead of faulting,
    and the card stays usable."""
    dev = _card()
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     paged_flash_prefill)

    def make(shape, shift):
        n = torch.Size(shape).numel()
        buf = torch.randn(n + 1, device=dev).to(torch.bfloat16)
        return buf[shift:shift + n].view(shape)

    S, page = 64, 16
    t = {n: make((1, S, 8 if n == "q" else 2, 128), int(n == which))
         for n in "qkv"}
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        flash_attention(t["q"], t["k"], t["v"], pos, pos)
    pools = {n: make((S // page, page, 2, 128), int(n == which))
             for n in "kv"}
    table = torch.arange(S // page, dtype=torch.int32, device=dev)[None]
    hl = torch.tensor([S], dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        paged_flash_prefill(t["q"], pools["k"], pools["v"], table, hl,
                            pos + S)
    aligned = {n: x.clone() for n, x in t.items()}
    o, _ = flash_attention(aligned["q"], aligned["k"], aligned["v"], pos,
                           pos)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_tile_classes_on_card(D):
    """K3 in bf16: key positions permuted across tiles (classified by
    position, not index), 17 queries (below one 128-row tile), and rows
    with no valid key (o = 0, lse = -1e30 exactly)."""
    dev = _card()
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator().manual_seed(4)
    for Sq, Sk, offset, perm in ((300, 300, 0, True), (17, 17, 0, False),
                                 (40, 40, -20, False)):
        q = torch.randn(1, Sq, 8, D, generator=g).to(dev, torch.bfloat16)
        k = torch.randn(1, Sk, 2, D, generator=g).to(dev, torch.bfloat16)
        v = torch.randn(1, Sk, 2, D, generator=g).to(dev, torch.bfloat16)
        qp = torch.arange(offset, offset + Sq, dtype=torch.int32,
                          device=dev)
        kp = torch.arange(Sk, dtype=torch.int32, device=dev)
        if perm:
            idx = torch.randperm(Sk, generator=g).to(dev)
            kp, k, v = kp[idx], k[:, idx], v[:, idx]
        o, lse = flash_attention(q, k, v, qp, kp)
        po, plse = flash_attention_plain(q, k, v, qp, kp)
        _bf16_close(o, po)
        torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)
        dead = plse <= -1e29
        assert bool((lse[dead] == -1e30).all())
        assert not o.transpose(1, 2)[dead].any()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("G", [6, 16])
def test_flash_attention_tile_classes_at_groups_6_and_16_on_card(G, D):
    """K3 in bf16 at GQA groups that are not a power of two (6: 21
    queries and 126 live rows in a 128-row tile) or fill a tile with 8
    queries (16): key positions permuted across tiles, 17 queries, rows
    with no valid key, and a window."""
    dev = _card()
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator().manual_seed(12)
    KVH = 2
    for Sq, Sk, offset, perm, window in ((300, 300, 0, True, None),
                                         (17, 17, 0, False, None),
                                         (40, 40, -20, False, None),
                                         (130, 250, 120, False, 64)):
        q = torch.randn(1, Sq, G * KVH, D, generator=g).to(dev,
                                                           torch.bfloat16)
        k = torch.randn(1, Sk, KVH, D, generator=g).to(dev, torch.bfloat16)
        v = torch.randn(1, Sk, KVH, D, generator=g).to(dev, torch.bfloat16)
        qp = torch.arange(offset, offset + Sq, dtype=torch.int32,
                          device=dev)
        kp = torch.arange(Sk, dtype=torch.int32, device=dev)
        if perm:
            idx = torch.randperm(Sk, generator=g).to(dev)
            kp, k, v = kp[idx], k[:, idx], v[:, idx]
        o, lse = flash_attention(q, k, v, qp, kp, window=window)
        po, plse = flash_attention_plain(q, k, v, qp, kp, window=window)
        _bf16_close(o, po)
        torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)
        dead = plse <= -1e29
        assert bool((lse[dead] == -1e30).all())
        assert not o.transpose(1, 2)[dead].any()


@pytest.mark.cuda
@pytest.mark.parametrize("page", [8, 64, 48])
@pytest.mark.parametrize("H,KVH", [(48, 8), (32, 2)])
def test_paged_prefill_nan_slots_at_groups_6_and_16_on_card(H, KVH, page):
    """K2 in bf16 at Nemotron-4-15B's heads (group 6) and ChatGLM3-6B's
    (group 16), head_dim 128, with NaN in the last page's unused slots
    inside a key tile (pages 8 and 64 by TMA, 48 by cp.async)."""
    dev = _card()
    import chip_smoke
    from repro_torch.kernels.flash_attention import (
        paged_flash_prefill, paged_flash_prefill_plain)
    g = torch.Generator().manual_seed(13)
    hist, Sq = 1001, 150
    q = torch.randn(1, Sq, H, 128, generator=g).to(dev, torch.bfloat16)
    kd = torch.randn(1, hist, KVH, 128, generator=g).to(dev, torch.bfloat16)
    vd = torch.randn(1, hist, KVH, 128, generator=g).to(dev, torch.bfloat16)
    kp, table = chip_smoke._pool_from_dense(kd, page, g.manual_seed(14))
    vp, _ = chip_smoke._pool_from_dense(vd, page, g.manual_seed(14))
    last = table[0, -1].long()
    kp[last, hist % page:] = float("nan")
    vp[last, hist % page:] = float("nan")
    hl = torch.tensor([hist], dtype=torch.int32, device=dev)
    qp = hist + torch.arange(Sq, dtype=torch.int32, device=dev)[None]
    for window in (None, 500):
        o, lse = paged_flash_prefill(q, kp, vp, table, hl, qp, window=window)
        po, plse = paged_flash_prefill_plain(q, kp, vp, table, hl, qp,
                                             window=window)
        assert torch.isfinite(o.float()).all()
        _bf16_close(o, po)
        torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)


_TOL = {torch.bfloat16: (1e-3, 1e-2), torch.float32: (1e-5, 1e-4)}


def _close_elementwise(o, po, dtype):
    """chip_smoke.py's elementwise check for o in ``dtype``."""
    atol, rtol = _TOL[dtype]
    o, po = o.float(), po.float()
    assert bool(((o - po).abs() <= atol + rtol * po.abs()).all())


def _paged_case(dev, g, lengths, H, KVH, D, page, dtype, nan_tail=True):
    """q, pools holding ``lengths`` keys per row (unused slots NaN, also
    inside the last page when ``nan_tail``), the table and the fused
    append's arguments."""
    import chip_smoke
    B, S = len(lengths), max(lengths) + 1
    q = torch.randn(B, H, D, generator=g).to(dev, dtype)
    kd = torch.randn(B, S, KVH, D, generator=g).to(dev, dtype)
    vd = torch.randn(B, S, KVH, D, generator=g).to(dev, dtype)
    kp, table = chip_smoke._pool_from_dense(kd, page, g.manual_seed(5))
    vp, _ = chip_smoke._pool_from_dense(vd, page, g.manual_seed(5))
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if nan_tail:
        f = torch.arange(table.shape[1] * page, device=dev)
        r, f = torch.nonzero(f[None] > ln[:, None], as_tuple=True)
        kp[table[r, f // page].long(), f % page] = float("nan")
        vp[table[r, f // page].long(), f % page] = float("nan")
    rows = torch.arange(B, device=dev)
    kw = dict(k_new=torch.randn(B, KVH, D, generator=g).to(dev, dtype),
              v_new=torch.randn(B, KVH, D, generator=g).to(dev, dtype),
              append_page=table[rows, (ln // page).long()],
              append_slot=ln % page)
    return q, kp, vp, table, ln, kw


def _check_paged(q, kp, vp, table, ln, kw, dtype):
    from repro_torch.kernels.flash_decode import (paged_flash_decode,
                                                  paged_flash_decode_plain)
    kp2, vp2 = kp.clone(), vp.clone()
    before = paged_flash_decode.launches
    o, lse = paged_flash_decode(q, kp, vp, table, ln, **kw)
    po, plse = paged_flash_decode_plain(q, kp2, vp2, table, ln, **kw)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    assert torch.isfinite(o.float()).all()
    _close_elementwise(o, po, dtype)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)
    # the fused append stored the bytes the plain version stores
    assert torch.equal(kp.nan_to_num(7.0), kp2.nan_to_num(7.0))
    assert torch.equal(vp.nan_to_num(7.0), vp2.nan_to_num(7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("page", [8, 16, 32, 64, 128])
def test_paged_decode_nan_slots_inside_a_tile_on_card(page):
    """K1 in bf16 at Llama-3-8B's heads: rows whose lengths are multiples
    of none of the page sizes leave NaN in the last page's unused slots,
    inside the kernel's 64-key tiles; they must stay out of every product
    (zero-filled, never multiplied by zero)."""
    dev = _card()
    g = torch.Generator().manual_seed(6)
    _check_paged(*_paged_case(dev, g, [3001, 700, 45], 32, 8, 128, page,
                              torch.bfloat16), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 6, 8, 16])
def test_paged_decode_append_slot_in_a_later_split_on_card(G, D, dtype):
    """The appended key lies in a tile that a block other than the
    writing one (split 0) loads, and the pool's slot holds NaN before the
    call: every block must take the row from k_new/v_new."""
    dev = _card()
    from repro_torch.kernels.flash_decode import plan_splits
    g = torch.Generator().manual_seed(7)
    KVH, page = 2, 16
    lengths = [1000, 333]
    q, kp, vp, table, ln, kw = _paged_case(dev, g, lengths, G * KVH, KVH,
                                           D, page, dtype)
    _, pps = plan_splits(table.shape[1], len(lengths), KVH, page)
    assert min(lengths) // page >= pps          # not in split 0's pages
    kp[kw["append_page"], kw["append_slot"]] = float("nan")
    vp[kw["append_page"], kw["append_slot"]] = float("nan")
    _check_paged(q, kp, vp, table, ln, kw, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,G,window,offset", [
    (203, 4, 50, 7), (1000, 8, 300, 33), (77, 1, 10, 0), (300, 6, 100, 5),
    (500, 16, 200, 0)])
def test_dense_decode_ragged_window_offset_on_card(S, G, window, offset,
                                                   dtype):
    """K4 over a cache whose S is not a multiple of the 64-key tile, with
    a window and a cache offset together; the slots outside the window
    hold NaN; a row with no valid key reads o = 0 and lse = -1e30."""
    dev = _card()
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    g = torch.Generator().manual_seed(8)
    KVH, D = 2, 128
    q = torch.randn(3, G * KVH, D, generator=g).to(dev, dtype)
    k = torch.randn(3, S, KVH, D, generator=g).to(dev, dtype)
    v = torch.randn(3, S, KVH, D, generator=g).to(dev, dtype)
    ln = torch.tensor([S + offset, 0, S // 2 + offset], dtype=torch.int32,
                      device=dev)
    pos = offset + torch.arange(S, device=dev)
    ok = (pos[None] < ln[:, None]) & (pos[None] >= ln[:, None] - window)
    k[~ok], v[~ok] = float("nan"), float("nan")
    o, lse = flash_decode(q, k, v, ln, window=window, kv_offset=offset)
    po, plse = flash_decode_plain(q, k, v, ln, window=window,
                                  kv_offset=offset)
    torch.cuda.synchronize()
    _close_elementwise(o, po, dtype)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)
    assert not o[1].any() and bool((lse[1] == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "k", "v", "k_new", "v_new"])
def test_decode_kernels_raise_on_unaligned_bf16(which):
    """K1 and K4 copy 16 bytes at a time: a contiguous bf16 view at an
    odd element offset raises at launch instead of faulting, and the card
    stays usable."""
    dev = _card()
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)

    def make(name, shape):
        n = torch.Size(shape).numel()
        shift = int(name == which)
        buf = torch.randn(n + 1, device=dev).to(torch.bfloat16)
        return buf[shift:shift + n].view(shape)

    B, KVH, D, page, npg = 2, 2, 128, 16, 4
    q = make("q", (B, 4 * KVH, D))
    pools = {n: make(n, (B * npg, page, KVH, D)) for n in "kv"}
    new = {n: make(n, (B, KVH, D)) for n in ("k_new", "v_new")}
    table = torch.arange(B * npg, dtype=torch.int32,
                         device=dev).reshape(B, npg)
    ln = torch.tensor([40, 9], dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        paged_flash_decode(q, pools["k"], pools["v"], table, ln,
                           k_new=new["k_new"], v_new=new["v_new"],
                           append_page=table[rows, (ln // page).long()],
                           append_slot=ln % page)
    if which in "qkv":
        cache = {n: make(n, (B, 64, KVH, D)) for n in "kv"}
        with pytest.raises(RuntimeError, match="CUDA error"):
            flash_decode(q, cache["k"], cache["v"], ln)
    o, _ = flash_decode(q.clone(), torch.zeros(B, 64, KVH, D, device=dev,
                                               dtype=torch.bfloat16),
                        torch.zeros(B, 64, KVH, D, device=dev,
                                    dtype=torch.bfloat16), ln)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("G", [3, 12, 32])
def test_decode_kernels_raise_on_other_groups(G):
    """K1 and K4 are built for the groups of ``flash_decode.GROUPS``; any
    other group raises before a launch (it never runs the plain
    version)."""
    dev = _card()
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    KVH, D, page = 2, 32, 16
    q = torch.zeros(2, G * KVH, D, device=dev)
    pool = torch.zeros(4, page, KVH, D, device=dev)
    table = torch.arange(4, dtype=torch.int32, device=dev).reshape(2, 2)
    ln = torch.tensor([20, 3], dtype=torch.int32, device=dev)
    before = (paged_flash_decode.launches, flash_decode.launches)
    with pytest.raises(ValueError, match="GQA group"):
        paged_flash_decode(q, pool, pool, table, ln)
    with pytest.raises(ValueError, match="GQA group"):
        flash_decode(q, torch.zeros(2, 32, KVH, D, device=dev),
                     torch.zeros(2, 32, KVH, D, device=dev), ln)
    assert (paged_flash_decode.launches, flash_decode.launches) == before


@pytest.mark.cuda
def test_decode_kernel_instances_ptxas_report_on_card():
    """K1/K4's split kernel is built for bf16 and fp32, head_dim 32, 64
    and 128, every GQA group of ``flash_decode.GROUPS`` and both modes
    (paged, dense): the build's ``-Xptxas -v`` report names each instance
    with its registers.  At head_dim 32 and 128 the instances at group 6,
    and at group 16 with head_dim 32, spill nothing; at head_dim 64 those
    at groups 1, 2, 4 (Whisper's path runs group 1) and 16.  The
    head_dim-128 instances at 16 spill a few bytes at 255 registers, the
    head_dim-64 ones at 8 (and fp32 at 6) a few at 168 (PERF.md section
    6)."""
    _card()
    import re
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import GROUPS
    _build.library("paged_decode")
    log = _build.BUILD / "paged_decode.log"
    report = chip_smoke._ptxas_report(log.read_text())
    found = {}
    for name, text in report.items():
        m = re.search(r"decode_split_kernel<(\w+), (?:\(int\))?(\d+), "
                      r"(?:\(int\))?(\d+), (?:\(bool\))?(\w+)>", name)
        if m:
            found[m.groups()] = text
    want = {(t, str(d), str(g), dense) for t in ("__nv_bfloat16", "float")
            for d in (32, 64, 128) for g in GROUPS for dense in ("0", "1")}
    assert set(found) == want, sorted(set(found) ^ want)
    assert all("registers" in text for text in found.values())
    for key, text in found.items():
        if ((key[1] != "64" and (key[2] == "6" or (key[2] == "16"
                                                   and key[1] == "32")))
                or (key[1] == "64" and key[2] in ("1", "2", "4", "16"))):
            assert "0 bytes spill stores, 0 bytes spill loads" in text, \
                (key, text)


# Whisper-medium's attention: 16 heads over 16 KV heads of 64 (MHA), 1500
# encoder frames, non-causal in the encoder and the cross attention
WHISPER_HEADS = dict(H=16, KVH=16, D=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,Sk", [(1500, 1500), (224, 1500), (17, 333)])
def test_flash_attention_noncausal_d64_on_card(Sq, Sk, dtype):
    """K3 at Whisper's heads without the causal mask, as its encoder
    (1500 x 1500) and cross attention (224 prompt tokens over 1500 frames)
    call it, and at 17 queries over 333 keys: Sq and Sk are multiples of
    neither the 128-row query tile nor the 64-key tile, so the last key
    tile is partial (rows past Sk arrive as zeros and are masked) and no
    tile is skipped."""
    dev = _card()
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator().manual_seed(15)
    h = WHISPER_HEADS
    B = 2
    q = torch.randn(B, Sq, h["H"], h["D"], generator=g).to(dev, dtype)
    k = torch.randn(B, Sk, h["KVH"], h["D"], generator=g).to(dev, dtype)
    v = torch.randn(B, Sk, h["KVH"], h["D"], generator=g).to(dev, dtype)
    qp = torch.arange(Sq, dtype=torch.int32, device=dev)
    kp = torch.arange(Sk, dtype=torch.int32, device=dev)
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, qp, kp, causal=False)
    po, plse = flash_attention_plain(q, k, v, qp, kp, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(o.float()).all()
    _close_elementwise(o, po, dtype)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("page", [8, 16, 64, 48])
def test_paged_prefill_nan_slots_d64_on_card(page, dtype):
    """K2 at head_dim 64 (one 128-byte panel: TMA boxes of 64 columns at
    pages 8, 16 and 64, cp.async at 48) with NaN in the last page's
    unused slots inside a key tile, with and without a window."""
    dev = _card()
    import chip_smoke
    from repro_torch.kernels.flash_attention import (
        paged_flash_prefill, paged_flash_prefill_plain)
    g = torch.Generator().manual_seed(16)
    hist, Sq, H, KVH, D = 1001, 150, 16, 16, 64
    q = torch.randn(1, Sq, H, D, generator=g).to(dev, dtype)
    kd = torch.randn(1, hist, KVH, D, generator=g).to(dev, dtype)
    vd = torch.randn(1, hist, KVH, D, generator=g).to(dev, dtype)
    kp, table = chip_smoke._pool_from_dense(kd, page, g.manual_seed(17))
    vp, _ = chip_smoke._pool_from_dense(vd, page, g.manual_seed(17))
    last = table[0, -1].long()
    kp[last, hist % page:] = float("nan")
    vp[last, hist % page:] = float("nan")
    hl = torch.tensor([hist], dtype=torch.int32, device=dev)
    qp = hist + torch.arange(Sq, dtype=torch.int32, device=dev)[None]
    for window in (None, 500):
        o, lse = paged_flash_prefill(q, kp, vp, table, hl, qp, window=window)
        po, plse = paged_flash_prefill_plain(q, kp, vp, table, hl, qp,
                                             window=window)
        assert torch.isfinite(o.float()).all()
        _close_elementwise(o, po, dtype)
        torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("page", [16, 64])
def test_paged_decode_nan_slots_d64_on_card(page, dtype):
    """K1 at Whisper's heads (group 1, head_dim 64: four ring stages of
    8 KB tiles in bf16) over rows whose unused slots hold NaN."""
    dev = _card()
    g = torch.Generator().manual_seed(18)
    h = WHISPER_HEADS
    _check_paged(*_paged_case(dev, g, [1500, 700, 45, 0], h["H"], h["KVH"],
                              h["D"], page, dtype), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,G,window,offset", [
    (1500, 1, None, 0), (203, 1, 50, 7), (300, 4, 100, 5), (500, 16, 200, 0)])
def test_dense_decode_d64_on_card(S, G, window, offset, dtype):
    """K4 at head_dim 64: Whisper's cross decode (every one of 1500 keys
    valid, 1500 not a multiple of the 64-key tile), and ragged caches with
    a window and an offset whose slots outside the window hold NaN; a row
    with no valid key reads o = 0 and lse = -1e30."""
    dev = _card()
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    g = torch.Generator().manual_seed(19)
    KVH, D = 2, 64
    q = torch.randn(3, G * KVH, D, generator=g).to(dev, dtype)
    k = torch.randn(3, S, KVH, D, generator=g).to(dev, dtype)
    v = torch.randn(3, S, KVH, D, generator=g).to(dev, dtype)
    ln = torch.tensor([S + offset, 0, S // 2 + offset], dtype=torch.int32,
                      device=dev)
    pos = offset + torch.arange(S, device=dev)
    ok = pos[None] < ln[:, None]
    if window is not None:
        ok &= pos[None] >= ln[:, None] - window
    k[~ok], v[~ok] = float("nan"), float("nan")
    o, lse = flash_decode(q, k, v, ln, window=window, kv_offset=offset)
    po, plse = flash_decode_plain(q, k, v, ln, window=window,
                                  kv_offset=offset)
    torch.cuda.synchronize()
    _close_elementwise(o, po, dtype)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)
    assert not o[1].any() and bool((lse[1] == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_kernels_raise_on_unaligned_bf16_at_d64(which):
    """At head_dim 64 too, bf16 K1-K4 read 16 bytes at a time: a
    contiguous view at an odd element offset raises at launch, and an
    aligned call afterwards runs."""
    dev = _card()
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     paged_flash_prefill)
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)

    def make(shape, shift):
        n = torch.Size(shape).numel()
        buf = torch.randn(n + 1, device=dev).to(torch.bfloat16)
        return buf[shift:shift + n].view(shape)

    S, page, KVH, D = 64, 16, 4, 64
    t = {n: make((1, S, KVH, D), int(n == which)) for n in "qkv"}
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        flash_attention(t["q"], t["k"], t["v"], pos, pos, causal=False)
    pools = {n: make((S // page, page, KVH, D), int(n == which))
             for n in "kv"}
    table = torch.arange(S // page, dtype=torch.int32, device=dev)[None]
    hl = torch.tensor([S - 1], dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        paged_flash_prefill(t["q"], pools["k"], pools["v"], table, hl,
                            pos + S)
    q1 = make((1, KVH, D), int(which == "q"))
    with pytest.raises(RuntimeError, match="CUDA error"):
        paged_flash_decode(q1, pools["k"], pools["v"], table, hl)
    with pytest.raises(RuntimeError, match="CUDA error"):
        flash_decode(q1, t["k"], t["v"], hl)
    aligned = {n: x.clone() for n, x in t.items()}
    o, _ = flash_attention(aligned["q"], aligned["k"], aligned["v"], pos,
                           pos, causal=False)
    od, _ = flash_decode(aligned["q"][:, 0], aligned["k"], aligned["v"], hl)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all() and torch.isfinite(
        od.float()).all()


@pytest.mark.cuda
def test_prefill_kernel_instances_ptxas_report_on_card():
    """K2/K3's kernels are built for head_dim 32, 64 and 128 in both
    dtypes, and at 64 and 128 the tensor-core kernel in both its TMA and
    its cp.async form; none of the head_dim-64 instances spills (PERF.md
    section 6)."""
    _card()
    import re
    import chip_smoke
    from repro_torch.kernels import _build
    _build.library("flash_attention")
    report = chip_smoke._ptxas_report(
        (_build.BUILD / "flash_attention.log").read_text())
    found = {}
    for name, text in report.items():
        m = re.search(r"attn_(tc|simt)_kernel<(?:\(int\))?(\d+), "
                      r"(?:\(bool\))?(\w+)(?:, (?:\(bool\))?(\w+))?>", name)
        if m:
            found[m.groups()] = text
    want = {("simt", str(d), paged, None) for d in (32, 64, 128)
            for paged in ("0", "1")}
    want |= {("tc", str(d), paged, tma) for d in (32, 64, 128)
             for paged in ("0", "1")
             for tma in (("0", "1") if d > 32 else ("0",))}
    assert set(found) == want, sorted(set(found) ^ want)
    for key, text in found.items():
        assert "registers" in text
        if key[1] == "64":
            assert "0 bytes spill stores, 0 bytes spill loads" in text, \
                (key, text)


# Qwen1.5-MoE-A2.7B's attention: 16 heads over 16 KV heads of 128 (GQA
# group 1), so K2/K3's 128-row tile holds 128 queries of one head
QWEN_HEADS = dict(H=16, KVH=16, D=128)


@pytest.mark.cuda
def test_paged_decode_at_qwen_heads_on_card():
    """K1 in bf16 at Qwen's heads over the smoke's decode batch, with
    lengths that leave NaN in the last pages' unused slots."""
    dev = _card()
    g = torch.Generator().manual_seed(9)
    h = QWEN_HEADS
    _check_paged(*_paged_case(dev, g, [6100, 4001, 2047, 509], h["H"],
                              h["KVH"], h["D"], 64, torch.bfloat16),
                 torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [3072, 17])
def test_prefill_kernels_at_qwen_heads_on_card(Sq):
    """K3 over a chunk's own keys and K2 over 3000 history tokens (the
    last page's unused slots NaN) at Qwen's heads in bf16, for the
    smoke's 3072-token chunk and for fewer queries than one tile."""
    dev = _card()
    import chip_smoke
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, paged_flash_prefill,
        paged_flash_prefill_plain)
    g = torch.Generator().manual_seed(10)
    H, KVH, D = QWEN_HEADS["H"], QWEN_HEADS["KVH"], QWEN_HEADS["D"]
    hist, page = 3000, 64
    q = torch.randn(1, Sq, H, D, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(1, Sq, KVH, D, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(1, Sq, KVH, D, generator=g).to(dev, torch.bfloat16)
    pos = torch.arange(Sq, dtype=torch.int32, device=dev)
    o, lse = flash_attention(q, k, v, pos, pos)
    po, plse = flash_attention_plain(q, k, v, pos, pos)
    _bf16_close(o, po)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)
    kd = torch.randn(1, hist, KVH, D, generator=g).to(dev, torch.bfloat16)
    vd = torch.randn(1, hist, KVH, D, generator=g).to(dev, torch.bfloat16)
    kp, table = chip_smoke._pool_from_dense(kd, page, g.manual_seed(11))
    vp, _ = chip_smoke._pool_from_dense(vd, page, g.manual_seed(11))
    last = table[0, -1].long()
    kp[last, hist % page:] = float("nan")
    vp[last, hist % page:] = float("nan")
    hl = torch.tensor([hist], dtype=torch.int32, device=dev)
    o, lse = paged_flash_prefill(q, kp, vp, table, hl, hist + pos[None])
    po, plse = paged_flash_prefill_plain(q, kp, vp, table, hl,
                                         hist + pos[None])
    assert torch.isfinite(o.float()).all()
    _bf16_close(o, po)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [False, True])
def test_moe_layer_full_width_bf16_on_card(gather):
    """One Qwen1.5-MoE-A2.7B MoE layer at published widths (60 experts of
    1408, top-4, capacity 1.25, shared 5632) in bf16 on the card against
    the same layer in fp32 on the CPU, on the same (bf16-valued) weights
    and 1400 tokens (three groups, the last padded).

    The card's router logits are the fp32 ones rounded to bf16, each off
    by at most 2^-9 of its size, so a token's top-4 set may differ only
    where its 4th and 5th fp32 logits lie within 2^-8 of the largest
    |logit| of the row: every differing token must be such a near tie.
    In each group, the (token, choice) pairs before the first token whose
    choices differ must get the same slot and capacity decision.  Tokens
    routed alike (same choices, same keeps) agree to 2^-5 of their row's
    largest |y| (bf16 GEMM outputs rounded at three stages).  The layer in
    bf16 on the CPU, on these inputs: 29 of 1536 token rows take another
    top-4 set, 239 are near ties, 63 of 1400 tokens are routed otherwise,
    and the alike tokens' worst |dy| is 0.0089 of their row's scale."""
    dev = _card()
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    from repro_torch.models.sharding import CPU_CTX, make_context
    cfg = get_config("qwen2-moe-a2.7b")
    m, d, E, k = cfg.moe, cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k
    g = torch.Generator().manual_seed(12)

    def w(*shape):
        return (torch.randn(*shape, generator=g)
                / shape[-2] ** 0.5).to(torch.bfloat16)

    fs = m.n_shared * m.d_shared
    p = {"router": w(d, E),
         "experts": {"wi": w(E, d, m.d_expert), "wg": w(E, d, m.d_expert),
                     "wo": w(E, m.d_expert, d)},
         "shared": {"wi": w(d, fs), "wg": w(d, fs), "wo": w(fs, d)}}
    x = torch.randn(1, 1400, d, generator=g).to(torch.bfloat16)
    routes = []
    route = moe._route

    def record(*a):
        routes.append(route(*a))
        return routes[-1]

    def tree(t, fn):
        return {n: tree(v, fn) if isinstance(v, dict) else fn(v)
                for n, v in t.items()}

    moe._route = record
    try:
        yb, _ = moe.moe_layer(
            x.to(dev), tree(p, lambda t: t.to(dev)), cfg,
            make_context("cuda").with_(moe_gather_dispatch=gather))
        yf, _ = moe.moe_layer(
            x.float(), tree(p, torch.Tensor.float),
            dataclasses.replace(cfg, dtype="float32"),
            CPU_CTX.with_(moe_gather_dispatch=gather))
    finally:
        moe._route = route
    rb = {n: t.cpu() for n, t in routes[0].items()}
    rf = routes[1]
    n_g, grp = rf["top_idx"].shape[:2]
    differs = (rb["top_idx"] != rf["top_idx"]).any(-1)          # (n, g)
    sets = (rb["top_idx"].sort(-1).values
            != rf["top_idx"].sort(-1).values).any(-1)
    logits = (x.float().reshape(-1, d) @ p["router"].float())
    logits = torch.cat([logits, torch.zeros(n_g * grp - logits.shape[0],
                                            E)]).reshape(n_g, grp, E)
    top = logits.sort(-1, descending=True).values
    near = (top[..., k - 1] - top[..., k]
            <= logits.abs().amax(-1) * 2.0 ** -8)
    assert not bool((sets & ~near).any()), "a top-4 set flipped without a tie"
    for n in range(n_g):
        first = int(differs[n].nonzero()[0]) if differs[n].any() else grp
        for key in ("top_idx", "within", "keep"):
            assert torch.equal(rb[key][n, :first], rf[key][n, :first])
    alike = ~differs & (rb["keep"] == rf["keep"]).all(-1)
    alike = alike.reshape(-1)[:x.shape[1]]
    yb, yf = yb.float().cpu().reshape(-1, d), yf.reshape(-1, d)
    scale = yf.abs().amax(-1, keepdim=True)
    ratio = ((yb - yf).abs() / scale)[alike]
    assert float(ratio.max()) <= 2.0 ** -5
    assert int(alike.sum()) > 0.9 * x.shape[1]
    print(f"moe layer on card: {int(sets.sum())} of {n_g * grp} token rows "
          f"route to another top-4 set ({int(near.sum())} near ties); "
          f"{int((~alike).sum())} of {x.shape[1]} tokens routed otherwise; "
          f"alike tokens' worst |dy| / row scale {float(ratio.max()):.4f}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_islands_on_card(dtype):
    """The mesh islands on 4 positions of the one card against the plain
    path on the same positions: ring attention (causal, window), the
    split-KV paged decode with its fused append (rows appending on every
    shard, a row of length 0, a stripe narrowed to 2 shards) and the
    ring-paged prefill over striped history (a scratch-padded column, a
    history length off the page grid), and the 3-dim fallbacks of
    ops.paged_prefill_attention / paged_decode_attention (K3 over the
    logical slab ++ chunk, K4 over the logical view)."""
    dev = _card()
    import numpy as np
    from repro_torch.core import ring_attention as ring
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import paged_flash_decode
    from repro_torch.launch.mesh import make_mesh
    dt = getattr(torch, dtype)
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    mesh = make_mesh((4,), ("x",), device="cuda")
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, dt)

    def close(a, b):
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol)

    B, S, H, KVH, D, page = 2, 256, 8, 2, 128, 16
    q, k, v = rnd(B, S, H, D), rnd(B, S, KVH, D), rnd(B, S, KVH, D)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    for window in (None, 40):
        before = flash_attention.launches
        got = ring.ring_attention(q, k, v, pos, pos, mesh=mesh, sp_axis="x",
                                  window=window)
        assert flash_attention.launches == before + 16
        close(got, ring.ring_attention(q, k, v, pos, pos, mesh=mesh,
                                       sp_axis="x", window=window,
                                       impl="ref"))
    # striped pools: 9 pages a row over 4 shards, local ids shuffled
    npg, bps = 9, 2 * 3
    lengths = torch.tensor([0, 135], dtype=torch.int32, device=dev)
    for active in (None, 2):
        n_act = active or 4
        cols = -(-npg // n_act)
        kp = [rnd(bps * 2 + 1, page, KVH, D) for _ in range(4)]
        vp = [rnd(bps * 2 + 1, page, KVH, D) for _ in range(4)]
        bt = torch.full((4, B, cols), bps * 2, dtype=torch.int32)
        perm = [np.random.default_rng(s).permutation(bps * 2)
                for s in range(4)]
        for b in range(B):
            for j in range(npg):
                s = j % n_act
                bt[s, b, j // n_act] = int(perm[s][b * cols + j // n_act])
        bt = bt.to(dev)
        qd, kn, vn = rnd(B, H, D), rnd(B, KVH, D), rnd(B, KVH, D)
        ref_k, ref_v = [x.clone() for x in kp], [x.clone() for x in vp]
        before = paged_flash_decode.launches
        o, _, _ = ring.sharded_paged_decode(
            qd, kp, vp, bt, lengths, mesh=mesh, split_axis="x", k_new=kn,
            v_new=vn, active_shards=active)
        assert paged_flash_decode.launches == before + 4
        po, _, _ = ring.sharded_paged_decode(
            qd, ref_k, ref_v, bt, lengths, mesh=mesh, split_axis="x",
            k_new=kn, v_new=vn, active_shards=active, impl="ref")
        close(o, po)
        for a, b in zip(kp + vp, ref_k + ref_v):
            assert torch.equal(a[:-1], b[:-1])
    hist = torch.tensor([37, 130], dtype=torch.int32, device=dev)
    Sq = 32
    qc, kc, vc = rnd(B, Sq, H, D), rnd(B, Sq, KVH, D), rnd(B, Sq, KVH, D)
    qpos = hist[:, None] + torch.arange(Sq, dtype=torch.int32, device=dev)
    for window in (None, 24):
        got = ring.ring_paged_prefill(qc, kc, vc, qpos, qpos, kp, vp, bt,
                                      hist, mesh=mesh, sp_axis="x",
                                      window=window)
        want = ring.ring_paged_prefill(qc, kc, vc, qpos, qpos, kp, vp, bt,
                                       hist, mesh=mesh, sp_axis="x",
                                       window=window, impl="ref")
        close(got, want)
        close(ops.paged_prefill_attention(qc, kc, vc, qpos, qpos, kp, vp,
                                          bt, hist, window=window),
              ops.paged_prefill_attention(qc, kc, vc, qpos, qpos, kp, vp,
                                          bt, hist, window=window,
                                          impl="ref"))
    close(ops.paged_decode_attention(qd, kp, vp, bt, hist),
          ops.paged_decode_attention(qd, kp, vp, bt, hist, impl="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_sliced_islands_and_restripe_on_card(dtype):
    """TP x SP on a 2 x 2 ("data" x "model") mesh of the one card: the
    split-KV paged decode over a head-sharded pool (K1 once per SP and TP
    position) and the ring-paged prefill and ring attention per head
    slice (K3 per position and ring step) against the plain path on the
    same positions, at Llama's GQA group (H 8 over KVH 2 per slice);
    then shard_restripe_kv_blocks across the positions of the card
    against the same exchange on CPU copies (bit-equal)."""
    dev = _card()
    import numpy as np
    from repro_torch.core import ring_attention as ring
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import (paged_flash_decode,
                                                  shard_restripe_kv_blocks)
    from repro_torch.launch.mesh import make_mesh
    dt = getattr(torch, dtype)
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda")
    g = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, dt)

    def close(a, b):
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol)

    B, H, KVH, D, page, npg, bps = 2, 16, 4, 128, 16, 9, 10
    # pools[s][t]: shard s's pages, head slice t (KVH / 2 heads)
    kp = [[rnd(bps + 1, page, KVH // 2, D) for _ in range(2)]
          for _ in range(2)]
    vp = [[rnd(bps + 1, page, KVH // 2, D) for _ in range(2)]
          for _ in range(2)]
    cols = -(-npg // 2)
    bt = torch.full((2, B, cols), bps, dtype=torch.int32)
    for s in range(2):
        perm = np.random.default_rng(s).permutation(bps)
        for b in range(B):
            for j in range(cols):
                if j * 2 + s < npg:
                    bt[s, b, j] = int(perm[b * cols + j])
    bt = bt.to(dev)
    lengths = torch.tensor([0, 135], dtype=torch.int32, device=dev)
    qd, kn, vn = rnd(B, H, D), rnd(B, KVH, D), rnd(B, KVH, D)
    ref_k = [[x.clone() for x in s] for s in kp]
    ref_v = [[x.clone() for x in s] for s in vp]
    before = paged_flash_decode.launches
    o, _, _ = ring.sharded_paged_decode(
        qd, kp, vp, bt, lengths, mesh=mesh, split_axis="data",
        head_axis="model", k_new=kn, v_new=vn)
    assert paged_flash_decode.launches == before + 4
    po, _, _ = ring.sharded_paged_decode(
        qd, ref_k, ref_v, bt, lengths, mesh=mesh, split_axis="data",
        head_axis="model", k_new=kn, v_new=vn, impl="ref")
    close(o, po)
    for a, b in zip(sum(kp + vp, []), sum(ref_k + ref_v, [])):
        assert torch.equal(a[:-1], b[:-1])
    hist = torch.tensor([37, 130], dtype=torch.int32, device=dev)
    Sq = 32
    qc, kc, vc = rnd(B, Sq, H, D), rnd(B, Sq, KVH, D), rnd(B, Sq, KVH, D)
    qpos = hist[:, None] + torch.arange(Sq, dtype=torch.int32, device=dev)
    kw = dict(mesh=mesh, sp_axis="data", head_axis="model",
              kv_head_axis="model")
    before = flash_attention.launches
    got = ring.ring_paged_prefill(qc, kc, vc, qpos, qpos, kp, vp, bt, hist,
                                  **kw)
    assert flash_attention.launches == before + 2 * 2 * 2 * 2
    close(got, ring.ring_paged_prefill(qc, kc, vc, qpos, qpos, kp, vp, bt,
                                       hist, impl="ref", **kw))
    before = flash_attention.launches
    got = ring.ring_attention(qc, kc, vc, qpos, qpos, **kw)
    assert flash_attention.launches == before + 2 * 2 * 2
    close(got, ring.ring_attention(qc, kc, vc, qpos, qpos, impl="ref", **kw))
    # a restripe exchange: 3 pages shard 0 -> 1 and 1 page 1 -> 0
    pools = [torch.randn(3, bps + 1, page, 2, D, generator=g).to(dev, dt)
             for _ in range(2)]
    host = [p.cpu() for p in pools]
    send = np.full((2, 2, 3), bps, np.int32)
    recv = np.full((2, 2, 3), bps, np.int32)
    send[0, 1], recv[1, 0] = [1, 4, 7], [0, 2, 9]
    send[1, 0, 0], recv[0, 1, 0] = 5, 3
    shard_restripe_kv_blocks(pools, send, recv)
    shard_restripe_kv_blocks(host, send, recv)
    for a, b in zip(pools, host):
        assert torch.equal(a[:, :-1].cpu(), b[:, :-1])
    assert torch.equal(pools[1][:, 2].cpu(), host[1][:, 2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_family_islands_on_card(dtype):
    """The islands of every family's sequence parallelism on 4 positions
    of the one card against the plain path on the same positions: the
    zigzag causal-skip ring (28 K3 calls: 4 at step 0, 2 a position at
    each later step), the split-KV dense decode with its in-shard write
    (rows ending inside a shard, on a shard boundary and shorter than a
    shard; a window straddling shards; one K4 a shard) and sp_ssd with
    an incoming state (one K5 a position)."""
    dev = _card()
    from repro_torch.core import ring_attention as ring
    from repro_torch.core import zigzag as zz
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.mesh import make_mesh
    dt = getattr(torch, dtype)
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    mesh = make_mesh((4,), ("x",), device="cuda")
    g = torch.Generator().manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev, dt)

    def close(a, b):
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol)

    B, S, H, KVH, D = 2, 512, 8, 2, 128
    q, k, v = rnd(B, S, H, D), rnd(B, S, KVH, D), rnd(B, S, KVH, D)
    pos = zz.zigzag_positions(S, 4, device=dev)[None].expand(B, S)
    before = flash_attention.launches
    got = ring.ring_attention(q, k, v, pos, pos, mesh=mesh, sp_axis="x",
                              zigzag_skip=True)
    assert flash_attention.launches == before + 28
    close(got, ring.ring_attention(q, k, v, pos, pos, mesh=mesh,
                                   sp_axis="x", impl="ref"))

    lens = torch.tensor([300, 383, 40, 127], dtype=torch.int32, device=dev)
    qd = rnd(4, H, D)
    kc, vc = rnd(4, S, KVH, D), rnd(4, S, KVH, D)
    kn, vn = rnd(4, KVH, D), rnd(4, KVH, D)
    for window in (None, 100):
        ks = [x.contiguous() for x in kc.chunk(4, dim=1)]
        vs = [x.contiguous() for x in vc.chunk(4, dim=1)]
        ks_r, vs_r = [x.clone() for x in ks], [x.clone() for x in vs]
        before = flash_decode.launches
        o, _, _ = ring.split_kv_decode(qd, ks, vs, lens, mesh=mesh,
                                       split_axis="x", window=window,
                                       k_new=kn, v_new=vn)
        assert flash_decode.launches == before + 4
        o_r, _, _ = ring.split_kv_decode(qd, ks_r, vs_r, lens, mesh=mesh,
                                         split_axis="x", window=window,
                                         k_new=kn, v_new=vn, impl="ref")
        close(o, o_r)
        assert all(torch.equal(a, b) for a, b in zip(ks, ks_r))

    Hs, P, N, chunk = 8, 64, 128, 64
    xbc = rnd(1, S, Hs * P + 2 * N)
    x = xbc[..., :Hs * P].reshape(1, S, Hs, P)
    Bm = xbc[..., Hs * P:Hs * P + N].reshape(1, S, 1, N)
    Cm = xbc[..., Hs * P + N:].reshape(1, S, 1, N)
    dts = torch.exp(torch.empty(1, S, Hs).uniform_(-6.9, -2.3,
                                                   generator=g)).to(dev)
    A = -torch.empty(Hs).uniform_(1.0, 16.0, generator=g).to(dev)
    h0 = (0.3 * torch.randn(1, Hs, P, N, generator=g)).to(dev)
    before = ssd_scan.launches
    y, h = ring.sp_ssd(x, dts, A, Bm, Cm, mesh=mesh, sp_axis="x",
                       chunk=chunk, h0=h0)
    assert ssd_scan.launches == before + 4
    y_r, h_r = ring.sp_ssd(x, dts, A, Bm, Cm, mesh=mesh, sp_axis="x",
                           chunk=chunk, h0=h0, impl="ref")
    close(y, y_r)
    torch.testing.assert_close(h, h_r, atol=1e-3, rtol=1e-3)


# ------------------------------------------------------------- training
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G,mode", [(1, "causal"), (4, "window"),
                                    (8, "noncausal"), (4, "causal")])
def test_flash_attention_fn_grads_on_card(G, mode, D, dtype):
    """``ops.attention`` on CUDA tensors that require a gradient runs K3
    once through ``FlashAttentionFn``; its out is K3's (within the
    kernel check) and its gradients for q, k and v (through out and lse)
    are autograd's through the plain version on the same inputs (the
    backward is that vector-Jacobian product)."""
    dev = _card()
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator().manual_seed(G * D)
    B, Sq, Sk, KVH = 2, 200, 333, 2
    causal, window = mode != "noncausal", 64 if mode == "window" else None

    def leaf(*shape):
        return torch.randn(*shape, generator=g).to(dev, dtype) \
            .requires_grad_()

    q, k, v = leaf(B, Sq, G * KVH, D), leaf(B, Sk, KVH, D), \
        leaf(B, Sk, KVH, D)
    qp = torch.arange(Sk - Sq, Sk, dtype=torch.int32, device=dev)
    kp = torch.arange(Sk, dtype=torch.int32, device=dev)
    go = torch.randn(B, Sq, G * KVH, D, generator=g).to(dev, dtype)
    gl = torch.randn(B, G * KVH, Sq, generator=g).to(dev)
    before = flash_attention.launches
    out, lse = ops.attention(q, k, v, qp, kp, causal=causal, window=window,
                             with_lse=True)
    assert flash_attention.launches == before + 1
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad((out, lse), (q, k, v), (go, gl))
    want_o, want_l = flash_attention_plain(q, k, v, qp, kp, causal=causal,
                                           window=window)
    want = torch.autograd.grad((want_o, want_l), (q, k, v), (go, gl))
    assert flash_attention.launches == before + 1
    atol, rtol = (1e-5, 1e-4) if dtype == torch.float32 else (1e-3, 1e-2)
    torch.testing.assert_close(out.float(), want_o.float(), atol=atol,
                               rtol=rtol)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,with_h0", [(512, True), (333, True),
                                       (333, False)])
def test_ssd_scan_fn_grads_on_card(S, with_h0, dtype):
    """``ops.ssd`` on CUDA tensors that require a gradient runs K5 once
    through ``SSDScanFn`` (x, B and C slices of one fused projection, a
    ragged last chunk at 333); its gradients for x, dt, A, B, C and h0
    are autograd's through the plain scan on the same inputs."""
    dev = _card()
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    g = torch.Generator().manual_seed(S)
    B, H, P, G, N, chunk = 2, 8, 64, 1, 128, 128
    xbc = torch.randn(B, S, H * P + 2 * G * N, generator=g).to(
        dev, dtype).requires_grad_()
    dt = torch.exp(torch.empty(B, S, H).uniform_(-6.9, -2.3, generator=g)
                   ).to(dev).requires_grad_()
    A = (-torch.empty(H).uniform_(1.0, 16.0, generator=g)).to(dev) \
        .requires_grad_()
    h0 = ((0.3 * torch.randn(B, H, P, N, generator=g)).to(dev)
          .requires_grad_() if with_h0 else None)
    gy = torch.randn(B, S, H, P, generator=g).to(dev, dtype)
    gh = torch.randn(B, H, P, N, generator=g).to(dev)
    leaves = (xbc, dt, A) + ((h0,) if with_h0 else ())

    def run(fn):
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
        Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
        y, h = fn(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)
        return y, torch.autograd.grad((y, h), leaves, (gy, gh))

    before = ssd_scan.launches
    y, got = run(ops.ssd)
    assert ssd_scan.launches == before + 1
    py, want = run(ssd_scan_plain)
    assert ssd_scan.launches == before + 1
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-3, 1e-2)
    torch.testing.assert_close(y.float(), py.float(), atol=atol, rtol=rtol)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)


@pytest.mark.cuda
def test_kernels_refuse_a_graph_they_would_cut():
    """A kernel wrapper called directly on CUDA tensors that require a
    gradient, with grad mode on, raises; under no_grad it runs."""
    dev = _card()
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    q = torch.randn(1, 64, 4, 64, device=dev, requires_grad=True)
    k = torch.randn(1, 64, 4, 64, device=dev)
    pos = torch.arange(64, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k, pos, pos)
    with torch.no_grad():
        flash_attention(q, k, k, pos, pos)
    x = torch.randn(1, 64, 2, 16, device=dev)
    bc = torch.randn(1, 64, 1, 16, device=dev)
    dt = torch.rand(1, 64, 2, device=dev)
    A = -torch.ones(2, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x, dt, A, bc, bc, chunk=32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-1.3b"])
def test_train_step_on_card(arch):
    """One step of the reduced config (fp32) on the card: the kernel path
    (K3 or K5 through its Function, each block under remat) gives the
    plain path's loss and gradients; a leaf the loss does not reach makes
    the step raise."""
    dev = _card()
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.optimizer import AdamW, tree_leaves, tree_map
    from repro_torch.training.train_loop import (loss_fn, make_train_step,
                                                 trainable)
    cfg = get_config(arch).reduced()
    ctx = make_context("cuda").with_(remat=True)
    batch = {k: torch.from_numpy(v.copy()).to(dev) for k, v in
             make_pipeline(cfg, 96, 2).batch(0).items()}
    params = init_params(cfg, seed=0, device=dev)
    kernel = ssd_scan if cfg.ssm is not None else flash_attention
    grads = {}
    for impl in (None, "ref"):
        before = kernel.launches
        tp = trainable(params)
        loss, _ = loss_fn(tp, cfg, ctx.with_(impl=impl), batch)
        loss.backward()
        # the forward and the remat recompute of each layer
        assert kernel.launches - before == (2 * cfg.n_layers
                                            if impl is None else 0)
        grads[impl] = (float(loss.detach()),
                       dict(tree_leaves(tree_map(lambda p: p.grad, tp))))
    (l_k, g_k), (l_p, g_p) = grads[None], grads["ref"]
    assert abs(l_k - l_p) <= 1e-5 * abs(l_p)
    for name, g in g_p.items():
        err = float((g_k[name] - g).abs().max())
        assert err <= 1e-3 * float(g.abs().max()) + 1e-8, (name, err)
    params["unused"] = torch.zeros(3, device=dev)
    step = make_train_step(cfg, ctx, AdamW())
    with pytest.raises(RuntimeError, match="unused"):
        step(trainable(params), AdamW().init(params), batch)


@pytest.mark.cuda
def test_op_profiler_does_not_wait_on_the_card():
    """``OpProfiler.op`` on the card queues its CUDA events and returns
    while the op still runs; ``collect()`` leaves an unfinished pair
    queued, ``collect(block=True)`` resolves it into one
    ``op_device_us`` sample of the op's device time."""
    dev = _card()
    from repro_torch.serving.telemetry import MetricsRegistry, OpProfiler
    m = MetricsRegistry()
    prof = OpProfiler(m, enabled=True, device=dev)
    torch.cuda.synchronize()
    with prof.op("sleep"):
        # 1e8 cycles: at least 50 ms at the H100's highest clock, 1.98 GHz
        torch.cuda._sleep(int(1e8))
    (name, _, end), = prof.pending
    assert name == "sleep" and not end.query()
    prof.collect()
    assert len(prof.pending) == 1 and "op_device_us/sleep" not in m.hists
    prof.collect(block=True)
    assert not prof.pending
    h = m.hists["op_device_us/sleep"]
    assert h.count == 1 and h.vmin >= 40e3


# ------------------------------------------------- the captured decode tick
def _tick_graph_run(arch: str, dev, preempt=(), eager: bool = False):
    """Six requests through one decode instance of reduced ``arch``
    (pages of 8 tokens, 4 rows, a host tier that takes swaps): admissions
    and evictions mid-run, tables that grow across width buckets, and the
    decode preemptions ``preempt`` ((rid, t) on the event clock) swapped
    out and back in.  ``eager`` runs every tick uncaptured, as a wrapped
    forward does.  Returns the drained engine, the pools' addresses
    before the run and the K1 launches it made."""
    import numpy as np

    import repro_torch.serving.engine as E
    from repro_torch.configs.registry import get_config
    from repro_torch.core.latency_model import table1_model
    from repro_torch.kernels.flash_decode import paged_flash_decode
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    from repro_torch.serving.request import Request
    from repro_torch.serving.simulator import ClusterSpec, make_policy
    cfg = get_config(arch).reduced()
    params = init_params(cfg, seed=0, device=dev)
    spec = ClusterSpec(n_prefill=4, n_decode=1, sp_candidates=(1, 2),
                       cache_slots=4 * 512)
    eng = E.ServingEngine(cfg, params, spec,
                          make_policy("tetris", table1_model(), spec),
                          ctx=make_context(dev), max_batch=4, max_seq=512,
                          block_size=8, preempt_policy="swap",
                          host_pool_blocks=512)
    rng = np.random.default_rng(0)
    for rid, n in enumerate((40, 100, 180, 60, 230, 90)):
        eng.submit(Request(rid=rid, arrival=0.05 * rid, prompt_len=n,
                           output_len=24),
                   rng.integers(0, cfg.vocab_size, n).astype(np.int32))
    for rid, t in preempt:
        eng.preempt(rid, at=t)
    ptrs = [p[part].data_ptr() for p in eng.dstates[0].kv.pools.values()
            for part in ("k", "v")]
    fwd = E.forward
    if eager:
        E.forward = lambda *a, **k: fwd(*a, **k)
    k1 = paged_flash_decode.launches
    try:
        eng.serve()
    finally:
        E.forward = fwd
    torch.cuda.synchronize()
    return eng, ptrs, paged_flash_decode.launches - k1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-1.3b", "qwen2-moe-a2.7b",
                                  "qwen2-vl-72b", "jamba-1.5-large-398b"])
def test_tick_graph_tokens_match_eager_ticks_on_card(arch):
    """The captured tick against the same ticks run eagerly, on reduced
    Yi-9B (paged GQA, K1), Mamba-2 (the batched state buffer), an MoE
    (routing over every row), Qwen2-VL (M-RoPE positions) and Jamba (all
    three): the greedy tokens of every request are identical through
    admissions, evictions, tables that cross width buckets and, with a
    Mamba layer, a swap-out and swap-in of a row; a graph is captured
    once per width and state buffer at most, every tick after the
    instance's first replays one, the pools stay where they were, and
    K1 launches as often."""
    dev = _card()
    calm, _, _ = _tick_graph_run(arch, dev)
    d = calm.dstates[0]
    state, attn = bool(d.state[0]), bool(d.kv.attn_layers)
    preempt = ()
    if state:
        tt = calm.reqs[2].token_times
        preempt = ((2, 0.5 * (tt[5] + tt[6])),)
    got, ptrs, k1 = _tick_graph_run(arch, dev, preempt)
    want, _, k1_eager = _tick_graph_run(arch, dev, preempt, eager=True)
    assert got.outputs == want.outputs
    assert all(len(v) > 24 for v in got.outputs.values())
    d = got.dstates[0]
    widths = len(d.graphs._tables) if attn else 1
    assert d.graphs.captures <= widths * (2 if state else 1)
    if attn:
        assert widths >= 2
    if state:
        assert got.swap_stats["swap_outs"] >= 1
        assert got.swap_stats["swap_ins"] >= 1
    assert got.metrics.counters["tick/graph_captures"].value == \
        d.graphs.captures
    assert ptrs == [p[part].data_ptr() for p in d.kv.pools.values()
                    for part in ("k", "v")]
    h = got.metrics.hists["tick_graph/replayed"]
    assert h.count > 20 and h.total == h.count - 1
    assert want.metrics.hists["tick_graph/replayed"].total == 0
    assert k1 == k1_eager
