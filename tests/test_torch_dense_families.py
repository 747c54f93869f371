"""The dense families' mechanisms in the port against the reference, on
the CPU: sliding-window attention, M-RoPE, padded query heads, and the two
sliding-window dense decode branches (the window slice and the ring
buffer).

The reference's model cases (``tests/test_models.py``:
``test_sliding_window_changes_logits``, ``test_mrope_equals_rope_for_text``,
``test_padded_heads_inert``; ``tests/test_optimizations.py``:
``test_windowed_decode_equals_full``, ``test_windowed_decode_multi_step``)
run here as parity tests: the same reduced configs, the reference's seeded
weights bridged through ``params_from_numpy``, the same numpy inputs
through both packages.  Logits and caches agree to fp32
``atol = rtol = 1e-4``; greedy tokens are identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.params import init_params as j_init_params
from repro.models.params import padded_head_indices as j_pads
from repro.models.sharding import CPU_CTX as J_CTX
from repro.models.transformer import forward as j_forward
from repro_torch.configs.registry import get_config
from repro_torch.models.params import (init_params, padded_head_indices,
                                       params_from_numpy)
from repro_torch.models.sharding import CPU_CTX
from repro_torch.models.transformer import forward

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 32


def _port(cfg):
    """The port's config with the same fields as the reference's ``cfg``
    (a reduced registry config, possibly ``dataclasses.replace``d)."""
    base = get_config(cfg.name.replace("-reduced", "")).reduced()
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if not dataclasses.is_dataclass(getattr(cfg, f.name))}
    return dataclasses.replace(base, **fields)


def _both(jp, cfg, tokens, positions):
    """Train-mode logits of the reference and of the port on the same
    weights and numpy inputs."""
    tp = params_from_numpy(jp, _port(cfg), device="cpu")
    want, _, _ = j_forward(jp, cfg, J_CTX, jnp.asarray(tokens),
                           jnp.asarray(positions), "train")
    got, _, _ = forward(tp, _port(cfg), CPU_CTX, torch.from_numpy(tokens),
                        torch.from_numpy(np.asarray(positions)), "train")
    return np.asarray(want), got.numpy()


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _pos(S_, offset=0, rows=None):
    pos = np.broadcast_to(np.arange(offset, offset + S_, dtype=np.int32),
                          (B, S_))
    if rows is not None:
        pos = np.broadcast_to(pos[None], (rows, B, S_))
    return pos.copy()


def test_sliding_window_changes_logits(reduced_params_cache):
    """``tests/test_models.py:99`` as a parity test: reduced yi-9b with a
    window of 8 agrees with the reference, and against the full model
    its early positions are unchanged and its last one differs."""
    cfg, jp = reduced_params_cache("yi-9b")
    S2 = 64
    tokens, pos = _tokens(cfg, 1, (B, S2)), _pos(S2)
    cfg_w = dataclasses.replace(cfg, sliding_window=8)
    want, win = _both(jp, cfg_w, tokens, pos)
    np.testing.assert_allclose(win, want, **TOL)
    _, full = _both(jp, cfg, tokens, pos)
    np.testing.assert_allclose(win[:, :8], full[:, :8], atol=2e-5,
                               rtol=2e-4)
    assert float(np.max(np.abs(win[:, -1] - full[:, -1]))) > 1e-4


def test_mrope_equals_rope_for_text(reduced_params_cache):
    """``tests/test_models.py:115`` as a parity test: reduced qwen2-vl-72b
    with identical temporal/height/width rows equals standard RoPE on
    those positions, in the port and against the reference."""
    cfg, jp = reduced_params_cache("qwen2-vl-72b")
    tokens, pos3 = _tokens(cfg, 1, (B, S)), _pos(S, rows=3)
    want, l_mrope = _both(jp, cfg, tokens, pos3)
    np.testing.assert_allclose(l_mrope, want, **TOL)
    cfg_std = dataclasses.replace(cfg, rope_type="standard")
    _, l_std = _both(jp, cfg_std, tokens, pos3[0])
    np.testing.assert_allclose(l_mrope, l_std, atol=1e-5, rtol=1e-5)


def test_mrope_sections_with_distinct_rows(reduced_params_cache):
    """M-RoPE positions whose three rows differ (an image's temporal,
    height and width indices): the port's sectioning agrees with the
    reference's, and the result differs from standard RoPE on any one
    row, so each section is driven by its own row."""
    from repro_torch.models.layers import mrope_sections
    cfg, jp = reduced_params_cache("qwen2-vl-72b")
    tokens = _tokens(cfg, 4, (B, S))
    t = np.arange(S, dtype=np.int32)
    pos3 = np.stack([np.broadcast_to(r, (B, S)) for r in
                     (t // 16, 3 + (t // 4) % 4, 7 + t % 4)]).astype(np.int32)
    want, got = _both(jp, cfg, tokens, pos3)
    np.testing.assert_allclose(got, want, **TOL)
    # head_dim 32 rotates 16 frequencies: sections (16, 24, 24) scale to
    # (4, 6, 6)
    assert mrope_sections(cfg.head_dim_, cfg.mrope_sections).tolist() == \
        [0] * 4 + [1] * 6 + [2] * 6
    cfg_std = dataclasses.replace(cfg, rope_type="standard")
    for row in range(3):
        _, std = _both(jp, cfg_std, tokens, pos3[row])
        assert float(np.max(np.abs(got - std))) > 1e-3


def test_padded_heads_inert(reduced_params_cache):
    """``tests/test_models.py:128`` as a parity test: reduced phi4-mini
    with its query heads padded to twice their number (pads interleaved
    per KV group, zero in wq and wo) agrees with the reference's padded
    model on the reference's padded tree, and stripping the pad heads
    gives the unpadded model's logits; the port's own init zeroes the
    same columns and rows."""
    cfg = get_config("phi4-mini-3.8b").reduced()
    jcfg, _ = reduced_params_cache("phi4-mini-3.8b")
    assert cfg.pad_heads_to == 0 == jcfg.pad_heads_to
    jcfg_pad = dataclasses.replace(jcfg, pad_heads_to=jcfg.n_heads * 2)
    cfg_pad = _port(jcfg_pad)
    import jax
    jp = j_init_params(jcfg_pad, jax.random.PRNGKey(0))
    pads = padded_head_indices(cfg_pad)
    assert pads == j_pads(jcfg_pad) and pads
    tokens, pos = _tokens(cfg, 1, (B, S)), _pos(S)
    want, logits = _both(jp, jcfg_pad, tokens, pos)
    np.testing.assert_allclose(logits, want, **TOL)
    dh = cfg.head_dim_
    keep = [h for h in range(cfg_pad.padded_heads) if h not in pads]
    cols = np.concatenate([np.arange(h * dh, (h + 1) * dh) for h in keep])
    blk = dict(jp["blocks"]["0"])
    blk["wq"] = np.asarray(blk["wq"])[..., cols]
    blk["wo"] = np.asarray(blk["wo"])[..., cols, :]
    jp2 = dict(jp, blocks={"0": blk})
    _, logits2 = _both(jp2, jcfg, tokens, pos)
    np.testing.assert_allclose(logits, logits2, atol=2e-5, rtol=2e-5)
    fresh = init_params(cfg_pad, seed=5, device="cpu")["blocks"]["0"]
    pad_cols = np.concatenate([np.arange(h * dh, (h + 1) * dh)
                               for h in pads])
    assert not fresh["wq"][..., pad_cols].any()
    assert not fresh["wo"][..., pad_cols, :].any()
    assert fresh["wq"][..., cols].any() and fresh["wo"][..., cols, :].any()


# ------------------------------------------- sliding-window dense decode
def _pad_caches(caches, S_max):
    """Attention k/v caches (n_blocks, B, S, KVH, D) padded with zeros to
    S_max along the sequence."""
    out = {}
    for key, ent in caches.items():
        kv = {}
        for part, a in ent["self"].items():
            a = np.asarray(a)
            z = np.zeros(a.shape[:2] + (S_max - a.shape[2],) + a.shape[3:],
                         a.dtype)
            kv[part] = np.concatenate([a, z], axis=2)
        out[key] = {"self": kv}
    return out


def _decode(side, params, cfg, ctx, tok, clen, caches):
    """One dense decode step on one side: (logits, caches) as numpy."""
    if side == "ref":
        lg, _, c = j_forward(params, cfg, ctx, jnp.asarray(tok),
                             jnp.asarray(clen[:, None]), "decode",
                             caches={k: {"self": {p: jnp.asarray(a)
                                                  for p, a in e["self"].items()}}
                                     for k, e in caches.items()},
                             cache_len=jnp.asarray(clen))
    else:
        lg, _, c = forward(params, cfg, ctx, torch.from_numpy(tok),
                           torch.from_numpy(clen[:, None]), "decode",
                           caches={k: {"self": {p: torch.from_numpy(a.copy())
                                                for p, a in e["self"].items()}}
                                   for k, e in caches.items()},
                           cache_len=torch.from_numpy(clen))
    return np.asarray(lg), {k: {"self": {p: np.asarray(a)
                                          for p, a in e["self"].items()}}
                            for k, e in c.items()}


def _prefill(jp, cfg, S0, seed):
    tokens = _tokens(cfg, seed, (B, S0))
    plog, _, caches = j_forward(jp, cfg, J_CTX, jnp.asarray(tokens),
                                jnp.asarray(_pos(S0)), "prefill")
    tok = np.asarray(jnp.argmax(plog[:, 0, :cfg.vocab_size], -1)
                     )[:, None].astype(np.int32)
    return tok, caches


def test_windowed_decode_equals_full(reduced_params_cache):
    """``tests/test_optimizations.py:55`` as a parity test: reduced yi-9b
    with a window of 8 over a 128-slot buffer; one decode step attending
    over the window + 8 slice (``ctx.window_slice``) gives the
    reference's logits and caches, and the port's full-buffer step's."""
    cfg, jp = reduced_params_cache("yi-9b")
    cfg = dataclasses.replace(cfg, sliding_window=8)
    tp = params_from_numpy(jp, _port(cfg), device="cpu")
    tok, caches = _prefill(jp, cfg, 48, 1)
    caches = _pad_caches(caches, 128)
    clen = np.full((B,), 48, np.int32)
    want, want_c = _decode("ref", jp, cfg, J_CTX.with_(window_slice=True,
                                                       window=8),
                           tok, clen, caches)
    ctx = CPU_CTX.with_(window_slice=True, window=8)
    got, got_c = _decode("port", tp, _port(cfg), ctx, tok, clen, caches)
    base, base_c = _decode("port", tp, _port(cfg), CPU_CTX, tok, clen,
                           caches)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, base, **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(got_c["0"]["self"][k],
                                   want_c["0"]["self"][k], **TOL)
        # layer 1's new K/V follows layer 0's attention, summed over
        # another set of keys
        np.testing.assert_allclose(got_c["0"]["self"][k],
                                   base_c["0"]["self"][k], atol=1e-5)


def test_windowed_decode_multi_step(reduced_params_cache):
    """``tests/test_optimizations.py:87`` as a parity test: reduced
    mixtral-8x22b (window 8, MoE) over a 128-slot buffer; five greedy
    window-slice steps give the reference's tokens, step for step, and
    the port's full-buffer steps' tokens."""
    cfg, jp = reduced_params_cache("mixtral-8x22b")
    assert cfg.sliding_window == 8
    tp = params_from_numpy(jp, _port(cfg), device="cpu")
    tok, caches = _prefill(jp, cfg, 40, 2)
    caches = _pad_caches(caches, 128)
    jctx = J_CTX.with_(window_slice=True, window=8)
    tctx = CPU_CTX.with_(window_slice=True, window=8)
    sides = {"ref": [jp, cfg, jctx, tok, caches],
             "port": [tp, _port(cfg), tctx, tok, caches],
             "full": [tp, _port(cfg), CPU_CTX, tok, caches]}
    clen = np.full((B,), 40, np.int32)
    for _ in range(5):
        toks = {}
        for name, st in sides.items():
            lg, st[4] = _decode("ref" if name == "ref" else "port", st[0],
                                st[1], st[2], st[3], clen, st[4])
            st[3] = np.argmax(lg[:, 0, :cfg.vocab_size], -1)[:, None] \
                .astype(np.int32)
            toks[name] = st[3]
        np.testing.assert_array_equal(toks["port"], toks["ref"])
        np.testing.assert_array_equal(toks["port"], toks["full"])
        clen = clen + 1


def test_ring_cache_decode_matches_reference(reduced_params_cache):
    """The ring-buffer branch (``ctx.ring_cache``): reduced yi-9b with a
    window of 8 keeps only the last 8 tokens, token t in slot t % 8.
    Three decode steps from a 20-token prefill (the buffer wraps) give
    the reference's logits and buffers, and the logits of a full
    128-slot buffer under the same window."""
    cfg, jp = reduced_params_cache("yi-9b")
    cfg = dataclasses.replace(cfg, sliding_window=8)
    tp = params_from_numpy(jp, _port(cfg), device="cpu")
    S0, W = 20, 8
    tok, caches = _prefill(jp, cfg, S0, 3)
    ring = {}
    for key, ent in caches.items():
        ring[key] = {"self": {}}
        for part, a in ent["self"].items():
            a = np.asarray(a)
            r = np.zeros(a.shape[:2] + (W,) + a.shape[3:], a.dtype)
            for t in range(S0 - W, S0):
                r[:, :, t % W] = a[:, :, t]
            ring[key]["self"][part] = r
    full = _pad_caches(caches, 128)
    jctx = J_CTX.with_(ring_cache=True)
    tctx = CPU_CTX.with_(ring_cache=True)
    clen = np.full((B,), S0, np.int32)
    jring, tring, tok_j, tok_t = ring, ring, tok, tok
    for _ in range(3):
        want, jring = _decode("ref", jp, cfg, jctx, tok_j, clen, jring)
        got, tring = _decode("port", tp, _port(cfg), tctx, tok_t, clen,
                             tring)
        base, full = _decode("port", tp, _port(cfg), CPU_CTX, tok_t, clen,
                             full)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, base, **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(tring["0"]["self"][k],
                                       jring["0"]["self"][k], **TOL)
        tok_j = np.argmax(want[:, 0, :cfg.vocab_size], -1)[:, None] \
            .astype(np.int32)
        tok_t = np.argmax(got[:, 0, :cfg.vocab_size], -1)[:, None] \
            .astype(np.int32)
        np.testing.assert_array_equal(tok_t, tok_j)
        clen = clen + 1


@pytest.mark.parametrize("arch", ["chatglm3-6b", "nemotron-4-15b",
                                  "llama3-70b"])
def test_published_widths_match_the_reference(arch):
    """The registered configs carry the reference's published fields
    (source included), so the widths the card serves are the reference's."""
    from repro.configs.registry import get_config as j_get_config
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
