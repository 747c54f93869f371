"""Whisper's encoder-decoder path in the port against the reference, on the
CPU: the parameter tree (cross-attention leaves, learned position tables,
the encoder), ``forward`` in prefill and train with encoder frames, and the
path the card runs — ``chunked_prefill`` with the frames as one decoder
chunk, ``history_to_decode_caches`` with the cross KV, then dense decode
ticks whose cross attention reads that cache.

The reduced config (2 decoder + 2 encoder layers, d_model 256, 16 encoder
frames) gets the reference's seeded weights, bridged through
``params_from_numpy``, and the same numpy inputs in both packages.  Logits
agree to fp32 ``atol = 2e-5, rtol = 2e-4`` (the reference's own
prefill-vs-train tolerance, ``tests/test_models.py``); greedy tokens are
identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cdsp import chunked_prefill as j_chunked_prefill
from repro.core.cdsp import history_to_decode_caches as j_to_decode
from repro.models.sharding import CPU_CTX as J_CTX
from repro.models.transformer import forward as j_forward
from repro_torch.configs.registry import get_config
from repro_torch.core.cdsp import chunked_prefill, history_to_decode_caches
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.models.sharding import CPU_CTX
from repro_torch.models.transformer import forward

ARCH = "whisper-medium"
TOL = dict(atol=2e-5, rtol=2e-4)
B, S = 2, 12


@pytest.fixture(scope="module")
def whisper(reduced_params_cache):
    jcfg, jp = reduced_params_cache(ARCH)
    cfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((B, cfg.cross_kv_len, cfg.d_model)
                                 ).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return (cfg, jcfg, jp, params_from_numpy(jp, cfg, device="cpu"),
            frames, tok)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def test_param_tree_leaves_equal_the_reference(whisper):
    """Every leaf of the reference's tree (the cross-attention leaves
    ``normx``/``x_*``, ``pos_emb``, the encoder's blocks, final norm and
    positions) is in the port's bridged tree with the same values; the
    port's own seeded init follows the reference's rules for them."""
    cfg, _, jp, tp, _, _ = whisper
    want = dict(_flat(jp))
    got = dict(_flat(tp))
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(a),
                                      err_msg="/".join(path))
    blk = got[("blocks", "0", "x_wq")]
    assert blk.shape == (cfg.n_blocks, cfg.d_model,
                         cfg.n_heads * cfg.head_dim)
    assert got[("encoder", "blocks", "0", "wq")].shape[0] == \
        cfg.n_encoder_layers
    fresh = init_params(cfg, seed=1, device="cpu")
    b0 = fresh["blocks"]["0"]
    assert not b0["bq"].any() and b0["x_bq"].any()   # reference's rule
    assert torch.equal(b0["normx"], torch.ones_like(b0["normx"]))
    assert b0["normx"].dtype == torch.float32
    assert torch.equal(fresh["encoder"]["final_norm"],
                       torch.ones(cfg.d_model))
    assert fresh["pos_emb"].shape == (cfg.max_position, cfg.d_model)


def test_prefill_matches_reference(whisper):
    """Prefill logits and the self and cross caches of every decoder layer
    equal the reference's; the prefill row equals the train logits at the
    last position.  (Train logits against the reference's:
    ``tests/test_torch_models.py::test_forward_matches_reference``, at
    this file's tolerance too.)"""
    mode = "prefill"
    cfg, jcfg, jp, tp, frames, tok = whisper
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want, _, jc = j_forward(jp, jcfg, J_CTX, jnp.asarray(tok),
                            jnp.asarray(pos), mode,
                            encoder_frames=jnp.asarray(frames))
    got, aux, tc = forward(tp, cfg, CPU_CTX, torch.from_numpy(tok),
                           torch.from_numpy(pos), mode,
                           encoder_frames=torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0
    for part in ("self", "cross"):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tc["0"][part][kv].numpy(),
                                       np.asarray(jc["0"][part][kv]), **TOL)
    assert tc["0"]["cross"]["k"].shape == (
        cfg.n_blocks, B, cfg.cross_kv_len, cfg.n_kv_heads, cfg.head_dim)
    train, _, _ = forward(tp, cfg, CPU_CTX, torch.from_numpy(tok),
                          torch.from_numpy(pos), "train",
                          encoder_frames=torch.from_numpy(frames))
    np.testing.assert_allclose(got[:, 0].numpy(), train[:, -1].numpy(),
                               **TOL)


def test_chunked_prefill_then_dense_decode_matches_reference(whisper):
    """The card's Whisper path: the decoder prompt as one CDSP chunk with
    the frames, the hand-off to dense decode caches (the cross KV carried),
    then 8 greedy ticks (self attention over the dense cache, cross
    attention over the fixed cross cache): logits close and tokens
    identical to the reference's, tick by tick."""
    cfg, jcfg, jp, tp, frames, tok = whisper
    ticks = 8
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want, jh = j_chunked_prefill(jp, jcfg, J_CTX, jnp.asarray(tok),
                                 jnp.asarray(pos), [S],
                                 encoder_frames=jnp.asarray(frames))
    got, th = chunked_prefill(tp, cfg, CPU_CTX, torch.from_numpy(tok),
                              torch.from_numpy(pos), [S],
                              encoder_frames=torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jc, jlen = j_to_decode(jcfg, jh, S + ticks)
    tc, tlen = history_to_decode_caches(cfg, th, S + ticks)
    assert set(tc["0"]) == {"self", "cross"}
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    for kv in ("k", "v"):
        np.testing.assert_allclose(tc["0"]["cross"][kv].numpy(),
                                   np.asarray(jc["0"]["cross"][kv]), **TOL)
    jt = np.argmax(np.asarray(want)[:, 0, :cfg.vocab_size], -1)
    tt = np.argmax(got[:, 0, :cfg.vocab_size].numpy(), -1)
    np.testing.assert_array_equal(tt, jt)
    j_toks, t_toks = [jt], [tt]
    # every tick has the same shapes: one compile of the reference's tick
    j_tick = jax.jit(lambda t, c, cl: j_forward(
        jp, jcfg, J_CTX, t, cl[:, None], "decode", caches=c, cache_len=cl))
    for _ in range(ticks):
        want, _, jc = j_tick(jnp.asarray(jt[:, None].astype(np.int32)), jc,
                             jlen)
        got, _, tc = forward(tp, cfg, CPU_CTX,
                             torch.from_numpy(tt[:, None].astype(np.int32)),
                             tlen[:, None], "decode", caches=tc,
                             cache_len=tlen)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        jt = np.argmax(np.asarray(want)[:, 0, :cfg.vocab_size], -1)
        tt = np.argmax(got[:, 0, :cfg.vocab_size].numpy(), -1)
        j_toks.append(jt)
        t_toks.append(tt)
        jlen, tlen = jlen + 1, tlen + 1
    np.testing.assert_array_equal(np.stack(t_toks), np.stack(j_toks))
    # decode hands the cross cache back as it was given
    assert tc["0"]["cross"]["k"] is th["0"]["cross"]["k"]


def test_encoder_decoder_needs_frames_and_one_chunk(whisper):
    cfg, _, _, tp, frames, tok = whisper
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    with pytest.raises(ValueError, match="encoder_frames"):
        forward(tp, cfg, CPU_CTX, torch.from_numpy(tok), pos, "prefill")
    with pytest.raises(ValueError, match="one chunk"):
        chunked_prefill(tp, cfg, CPU_CTX, torch.from_numpy(tok), pos,
                        [4, S - 4], encoder_frames=torch.from_numpy(frames))


def test_serve_cli_refuses_whisper():
    """The serving engine takes no encoder frames (nor does the
    reference's): the CLI says so before it builds an engine."""
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve_main(["--arch", ARCH, "--device", "cpu", "--requests", "1"])


def test_published_widths_match_the_reference():
    """The registered config carries the reference's published fields
    (source included); its tree holds 945,637,376 parameters with the two
    65,536-row position tables (``param_count``, the reference's estimate,
    says 878,280,704)."""
    from repro.configs.registry import get_config as j_get_config
    from repro.models.params import param_shapes as j_param_shapes
    from repro_torch.models.params import param_shapes
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_get_config(ARCH))
    shapes = param_shapes(cfg)
    assert shapes == j_param_shapes(j_get_config(ARCH))
    n = sum(int(np.prod(s)) for _, s in _flat(shapes))
    assert n == 945_637_376
    assert cfg.param_count() == 878_280_704
    assert cfg.head_dim_ == 64 and cfg.n_kv_heads == cfg.n_heads
