"""The port's Mamba-2 path against the reference's, on the CPU.

The plain version of K5 (``ssd_scan_plain``) is held to the reference's
Pallas ``ssd_scan`` in interpret mode, the port's SSD oracles and its
causal conv to the reference's, and ``mamba_block`` to the reference's in
prefill, decode and across CDSP chunks (conv window and SSD state handed
over).  Inputs are made with numpy from a seed and handed to both
packages.  Tolerance: fp32 ``atol = rtol = 1e-4`` (the two sides sum in
different orders).  The arithmetic of K5's bf16 kernels (tensor cores,
``csrc/ssd_scan.cu``) is emulated in torch and held to the plain version
and the Pallas scan under chip_smoke.py's K5 check (y 1e-3 / 1e-2 after
the bf16 rounding, h_final 1e-4 / 1e-4), and, through chip_smoke.py's
per-call gate, on every scan call of a reduced bf16 Mamba-2 serving two
chunks.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import causal_depthwise_conv as j_conv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models.sharding import CPU_CTX as J_CTX
from repro.models.ssm import mamba_block as _j_mamba_block
from repro_torch.compat import causal_depthwise_conv
from repro_torch.configs.registry import get_config
from repro_torch.core.cdsp import prefill_chunk_paged
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.models.sharding import CPU_CTX
from repro_torch.models.ssm import mamba_block
from repro_torch.serving.cache_manager import PagedKVCache

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402  (the repo root: the smoke's K5 check)

TOL = dict(atol=1e-4, rtol=1e-4)
# one compile per shape instead of one per primitive
j_mamba_block = jax.jit(_j_mamba_block, static_argnums=(2, 3, 4))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _ssd_inputs(seed, B, S, H, P, G, N, h0=True):
    """The reference test's distributions (tests/test_kernels.py:109):
    softplus'd dt, A = -exp(normal), normal x/B/C/h0."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, S, H, P)
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    A = -np.exp(f(H))
    Bm, Cm = f(B, S, G, N), f(B, S, G, N)
    return x, dt, A, Bm, Cm, (f(B, H, P, N) if h0 else None)


SWEEP = [
    # B, S, H, P, G, N, chunk, h0      (tests/test_kernels.py sweep, plus)
    (1, 64, 2, 16, 1, 16, 16, True),
    (2, 128, 4, 16, 2, 32, 32, True),
    (2, 256, 8, 32, 1, 64, 64, True),
    (2, 100, 4, 16, 2, 16, 32, True),      # S not a multiple of the chunk
    (1, 40, 4, 16, 4, 16, 64, False),      # S below one chunk, G = H, no h0
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,h0", SWEEP)
def test_ssd_scan_plain_matches_pallas(B, S, H, P, G, N, chunk, h0):
    ins = _ssd_inputs(0, B, S, H, P, G, N, h0)
    x, dt, A, Bm, Cm, hz = ins
    j = [None if a is None else jnp.asarray(a) for a in ins]
    if S % min(chunk, S):
        # the Pallas kernel takes whole chunks; the reference pads in ops
        want_y, want_h = jops.ssd(*j[:5], h0=j[5], chunk=chunk,
                                  impl="interpret")
    else:
        want_y, want_h = j_ssd_scan(*j[:5], h0=j[5], chunk=min(chunk, S),
                                    interpret=True)
    t = [None if a is None else torch.from_numpy(a) for a in ins]
    got_y, got_h = ssd_scan(*t[:5], h0=t[5], chunk=chunk)
    _close(got_y, want_y)
    _close(got_h, want_h)
    assert ssd_scan.launches == 0           # CPU tensors: plain version
    # the dispatcher's two routes agree on the CPU
    oy, oh = ops.ssd(*t[:5], h0=t[5], chunk=chunk)
    assert torch.equal(oy, got_y) and torch.equal(oh, got_h)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,h0", SWEEP[:3])
def test_ssd_oracles_match_reference(B, S, H, P, G, N, chunk, h0):
    ins = _ssd_inputs(1, B, S, H, P, G, N, h0)
    j = [None if a is None else jnp.asarray(a) for a in ins]
    t = [None if a is None else torch.from_numpy(a) for a in ins]
    for jf, tf, kw in ((jref.ssd_ref, ref.ssd_ref, {}),
                       (jref.ssd_chunked_ref, ref.ssd_chunked_ref,
                        {"chunk": chunk})):
        want_y, want_h = jf(*j[:5], h0=j[5], return_state=True, **kw)
        got_y, got_h = tf(*t[:5], h0=t[5], return_state=True, **kw)
        _close(got_y, want_y)
        _close(got_h, want_h)
    # and the sequential and chunked oracles agree with each other
    _close(ref.ssd_chunked_ref(*t[:5], h0=t[5], chunk=chunk),
           ref.ssd_ref(*t[:5], h0=t[5]))


def test_ssd_decode_matches_reference_and_scan():
    B, S, H, P, G, N = 2, 6, 4, 16, 2, 16
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(2, B, S, H, P, G, N)
    h_t, h_j = torch.from_numpy(h0), jnp.asarray(h0)
    for s in range(S):
        args = (x[:, s], dt[:, s], A, Bm[:, s], Cm[:, s])
        y_t, h_t = ops.ssd_decode(*map(torch.from_numpy, args), h_t)
        y_j, h_j = jref.ssd_decode_ref(*map(jnp.asarray, args), h_j)
        _close(y_t, y_j)
        _close(h_t, h_j)
    # S one-token steps == one scan over the S tokens
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h0)]
    _, h_scan = ref.ssd_ref(*t[:5], h0=t[5], return_state=True)
    _close(h_t, h_scan)


@pytest.mark.parametrize("S,carry", [(12, False), (12, True), (2, True),
                                     (1, True)])
def test_causal_conv_matches_reference(S, carry):
    """With and without a carried window, and chunks shorter than K - 1."""
    rng = np.random.default_rng(3)
    B, K, ch = 2, 4, 24
    x = rng.standard_normal((B, S, ch)).astype(np.float32)
    w = rng.standard_normal((K, ch)).astype(np.float32)
    init = rng.standard_normal((B, K - 1, ch)).astype(np.float32) \
        if carry else None
    want = j_conv(jnp.asarray(x), jnp.asarray(w),
                  None if init is None else jnp.asarray(init))
    got = causal_depthwise_conv(torch.from_numpy(x), torch.from_numpy(w),
                                None if init is None
                                else torch.from_numpy(init))
    _close(got, want)


def _block_setup(reduced_params_cache):
    jcfg, jp = reduced_params_cache("mamba2-1.3b")
    cfg = get_config("mamba2-1.3b").reduced()
    tp = params_from_numpy(jp, cfg, device="cpu")
    lay = lambda tree: {k: v[0] for k, v in tree["blocks"]["0"].items()}
    return jcfg, cfg, lay(jp), lay(tp)


def _cache_close(got, want):
    for k in ("conv", "ssm"):
        _close(got[k], want[k])


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mamba_block_matches_reference(mode, reduced_params_cache):
    jcfg, cfg, jp, tp = _block_setup(reduced_params_cache)
    x = np.random.default_rng(4).standard_normal(
        (2, 45, cfg.d_model)).astype(np.float32)
    want, jc = j_mamba_block(jnp.asarray(x), jp, jcfg, J_CTX, mode)
    got, tc = mamba_block(torch.from_numpy(x), tp, cfg, CPU_CTX, mode)
    _close(got, want)
    if mode == "prefill":
        _cache_close(tc, jc)
    else:
        assert tc is None and jc is None


def test_mamba_block_decode_matches_reference(reduced_params_cache):
    jcfg, cfg, jp, tp = _block_setup(reduced_params_cache)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    _, jc = j_mamba_block(jnp.asarray(x), jp, jcfg, J_CTX, "prefill")
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    for _ in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jc = j_mamba_block(jnp.asarray(xt), jp, jcfg, J_CTX,
                                 "decode", cache=jc)
        got, tc = mamba_block(torch.from_numpy(xt), tp, cfg, CPU_CTX,
                              "decode", cache=tc)
        _close(got, want)
        _cache_close(tc, jc)


def test_mamba_block_chunk_handoff(reduced_params_cache):
    """CDSP chunks of 2, 1, 29 and 33 tokens (two shorter than the conv's
    K - 1 = 3; none a multiple of the scan chunk 32) hand the conv window
    and SSD state on; each chunk matches the reference's, and the whole
    equals one monolithic prefill."""
    jcfg, cfg, jp, tp = _block_setup(reduced_params_cache)
    x = np.random.default_rng(6).standard_normal(
        (1, 65, cfg.d_model)).astype(np.float32)
    jc = tc = None
    outs, off = [], 0
    for L in (2, 1, 29, 33):
        sl = x[:, off:off + L]
        want, jc = j_mamba_block(jnp.asarray(sl), jp, jcfg, J_CTX,
                                 "prefill", cache=jc)
        got, tc = mamba_block(torch.from_numpy(sl), tp, cfg, CPU_CTX,
                              "prefill", cache=tc)
        _close(got, want)
        _cache_close(tc, jc)
        outs.append(got)
        off += L
    mono, mc = mamba_block(torch.from_numpy(x), tp, cfg, CPU_CTX, "prefill")
    _close(torch.cat(outs, dim=1), mono)
    _cache_close(tc, mc)


# ------------- the arithmetic of K5's bf16 kernels (csrc/ssd_scan.cu)
def _split(a, parts=2):
    """fp32 ``a`` as the kernel enters it into bf16 products: a bf16 head
    and (``parts`` 2) the bf16 rounding of what the head left out."""
    out = []
    for _ in range(parts):
        out.append(a.bfloat16().float())
        a = a - out[-1]
    return out


def _k5_tc_emulation(x, dt, A, Bm, Cm, h0, chunk, *, score_parts=2):
    """K5's bf16 order and roundings in torch (fp32 products of
    bf16 operands).  Rows past S are zeros with dt = 0.  Per chunk:
    a_cum = cumsum(dt A); the chunk state (w x)^T B with w x as a bf16
    head plus tail (w_j = exp(a_total - a_cum_j) dt_j); the pass over
    chunks in fp32; C B^T from the bf16 rows; the scores
    S_ij = (C B^T)_ij exp(a_cum_i - a_cum_j) dt_j with keys j > i selected
    out before the exp (in 64-key tiles below the row's own, the decay as
    exp(a_cum_i - a_cum_r) exp(a_cum_r - a_cum_j), r the tile's last key),
    entering S x as a head plus (``score_parts`` 2) a tail; C h_prev^T
    with h_prev as a head plus tail, the row factor exp(a_cum_i) applied
    to the fp32 sum; y rounded once to x's dtype."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    pad = (-S) % chunk

    def zpad(a):
        return torch.cat([a, a.new_zeros((Bsz, pad) + a.shape[2:])], 1)

    x, dt, Bm, Cm = zpad(x), zpad(dt), zpad(Bm), zpad(Cm)
    nc, L = (S + pad) // chunk, chunk
    xf = x.float().reshape(Bsz, nc, L, H, P)
    dtf = dt.float().reshape(Bsz, nc, L, H)
    Bf = Bm.float().reshape(Bsz, nc, L, G, N).repeat_interleave(H // G, 3)
    Cf = Cm.float().reshape(Bsz, nc, L, G, N).repeat_interleave(H // G, 3)
    a_cum = torch.cumsum(dtf * A.float(), dim=2)              # (B,nc,L,H)
    a_tot = a_cum[:, :, -1]
    wx = xf * (torch.exp(a_tot[:, :, None] - a_cum) * dtf)[..., None]
    states = sum(torch.einsum("bclhp,bclhn->bchpn", t, Bf)
                 for t in _split(wx))
    h = (torch.zeros(Bsz, H, P, N) if h0 is None else h0.float())
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(a_tot[:, c])[..., None, None] + states[:, c]
    ac = a_cum.permute(0, 1, 3, 2)                            # (B,nc,H,L)
    dtk = dtf.permute(0, 1, 3, 2)[..., None, :]
    causal = torch.tril(torch.ones(L, L, dtype=torch.bool))
    seg = torch.where(causal, ac[..., :, None] - ac[..., None, :], 0.0)
    cb = torch.einsum("bcihn,bcjhn->bchij", Cf, Bf)
    s = torch.where(causal, cb * torch.exp(seg) * dtk, 0.0)
    # 64-key tiles below the row's own: exp(a_i - a_r) exp(a_r - a_j) with
    # r the tile's last key
    t = torch.arange(L) // 64
    ar = ac[..., torch.clamp(t * 64 + 63, max=L - 1)]          # (..., L) by j
    below = t[:, None] > t[None, :]
    s = torch.where(below, cb * torch.exp(ac[..., :, None] - ar[..., None, :])
                    * (torch.exp(ar - ac) * dtk[..., 0, :])[..., None, :], s)
    y = sum(torch.einsum("bcihn,bchpn->bcihp", Cf, t)
            for t in _split(torch.stack(h_prev, 1))) \
        * torch.exp(a_cum)[..., None]
    y = y + sum(torch.einsum("bchij,bcjhp->bcihp", t, xf)
                for t in _split(s, score_parts))
    return y.reshape(Bsz, nc * L, H, P)[:, :S].to(x.dtype), h


def _k5_case(seed=7, S=1024, H=4, P=64, G=1, N=128, chunk=256):
    """bf16 x/B/C, dt, A and h0 drawn as chip_smoke.py's K5 cases draw
    them (dt = exp(U(-6.9, -2.3)), A = -U(1, 16), h0 = 0.3 N(0, 1)), from
    a numpy seed."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, Bm, Cm = (torch.from_numpy(a).bfloat16()
                 for a in (f(1, S, H, P), f(1, S, G, N), f(1, S, G, N)))
    dt = torch.from_numpy(np.exp(rng.uniform(-6.9, -2.3, (1, S, H)))
                          .astype(np.float32))
    A = torch.from_numpy(-rng.uniform(1.0, 16.0, H).astype(np.float32))
    h0 = torch.from_numpy(0.3 * f(1, H, P, N))
    return x, dt, A, Bm, Cm, h0, chunk


def _k5_ratios(got, want):
    """chip_smoke.py's K5 check: (y ratio at bf16's 1e-3 / 1e-2, h_final
    ratio at 1e-4 / 1e-4); each passes at <= 1."""
    def ratio(g, w, atol, rtol):
        g, w = g.float(), w.float()
        return float(((g - w).abs() / (atol + rtol * w.abs())).max())
    return (ratio(got[0], want[0], 1e-3, 1e-2),
            ratio(got[1], want[1], 1e-4, 1e-4))


def test_k5_tensor_core_arithmetic_fits_the_smoke_check():
    """K5's bf16 arithmetic (C B^T from the bf16 rows; the scores, w x
    and h_prev each as a bf16 head plus tail) against the plain version
    and the reference's Pallas scan in interpret mode, under
    chip_smoke.py's unchanged K5 check."""
    x, dt, A, Bm, Cm, h0, chunk = case = _k5_case()
    got = _k5_tc_emulation(*case)
    assert torch.isfinite(got[0].float()).all()
    want = ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)
    assert max(_k5_ratios(got, want)) <= 1.0
    bf16 = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    jy, jh = j_ssd_scan(bf16(x), jnp.asarray(dt.numpy()),
                        jnp.asarray(A.numpy()), bf16(Bm), bf16(Cm),
                        h0=jnp.asarray(h0.numpy()), chunk=chunk,
                        interpret=True)
    pallas = (torch.tensor(np.asarray(jy.astype(jnp.float32))),
              torch.tensor(np.asarray(jh)))
    assert max(_k5_ratios(got, pallas)) <= 1.0


def test_k5_one_bf16_rounding_of_the_scores_misses_the_smoke_check():
    """Why K5's bf16 kernels keep the scores' tail: rounded once to bf16,
    the decay-weighted scores leave y outside the check."""
    x, dt, A, Bm, Cm, h0, chunk = case = _k5_case()
    got = _k5_tc_emulation(*case, score_parts=1)
    want = ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)
    assert _k5_ratios(got, want)[0] > 1.0


# ------------- chip_smoke.py's per-call K5 gate on a reduced Mamba-2
def _gate_scan(kind):
    """A scan in K5's place (ops.ssd_scan's arguments): the bf16 kernels'
    arithmetic, or the plain scan with the CDSP hand-off lost."""
    def scan(x, dt, A, Bm, Cm, *, h0=None, chunk=128):
        assert x.dtype == Bm.dtype == Cm.dtype == torch.bfloat16
        if kind == "h0_dropped":
            return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
        return _k5_tc_emulation(x, dt, A, Bm, Cm, h0, min(chunk, x.shape[1]))
    return scan


@pytest.mark.parametrize("kind,ok", [("tc_emulation", True),
                                     ("h0_dropped", False)])
def test_k5_per_call_gate_on_two_mamba2_chunks(kind, ok, monkeypatch):
    """chip_smoke.py's gate on the served Mamba-2 path, on the CPU: a bf16
    Mamba-2 cut to two layers and d_model 256 (8 SSD heads) at its
    published head shape (P 64, N 128, one group, chunk 256), weights from
    ``init_params``, prefills two 512-token chunks, the second from the
    first's state and conv window.  Each layer's scan call goes through
    the route it takes on the card with ``kind`` in the kernel's place and
    is held to the plain scan on the same inputs: K5's bf16 arithmetic
    passes on all four calls, a scan that drops the handed-in state does
    not, and each planted fault reads > 1 on both kept calls."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=2,
                              d_model=256, vocab_size=512)
    assert (cfg.dtype, cfg.ssm.head_dim, cfg.ssm.d_state,
            cfg.ssm.chunk_size) == ("bfloat16", 64, 128, 256)
    params = init_params(cfg, seed=0, device="cpu")
    none = PagedKVCache(cfg, 1, 64, device="cpu").pools      # no attention
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, 1024)))
    pos = torch.arange(1024, dtype=torch.int32)[None]

    def two_chunks():
        aux = None
        for off in (0, 512):
            _, _, aux = prefill_chunk_paged(
                params, cfg, CPU_CTX, toks[:, off:off + 512],
                pos[:, off:off + 512], none, [], off, aux)
        return aux

    # ops.ssd as on the card: through ops.ssd_scan, here ``kind``
    monkeypatch.setattr(ops, "use_kernel", lambda x, impl: impl is None)
    monkeypatch.setattr(ops, "ssd_scan", _gate_scan(kind))
    _, gate = chip_smoke.ssd_call_gate(two_chunks, cfg.n_layers)
    assert gate["calls"] == 4 and gate["ok"] is ok, gate
    assert (gate["worst_y"]["ratio"] <= 1.0) is ok
    assert sorted(gate["planted"]) == ["layer0_chunk2", "layer1_chunk2"]
    for faults in gate["planted"].values():
        assert sorted(faults) == sorted(chip_smoke.SSD_FAULTS)
        assert all(v > 1.0 for v in faults.values()), faults
