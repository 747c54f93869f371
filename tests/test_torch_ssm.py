"""The port's Mamba-2 path against the reference's, on the CPU.

The plain version of K5 (``ssd_scan_plain``) is held to the reference's
Pallas ``ssd_scan`` in interpret mode, the port's SSD oracles and its
causal conv to the reference's, and ``mamba_block`` to the reference's in
prefill, decode and across CDSP chunks (conv window and SSD state handed
over).  Inputs are made with numpy from a seed and handed to both
packages.  Tolerance: fp32 ``atol = rtol = 1e-4`` (the two sides sum in
different orders).
"""

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
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models.params import params_from_numpy
from repro_torch.models.sharding import CPU_CTX
from repro_torch.models.ssm import mamba_block

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
