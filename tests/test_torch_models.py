"""The port's models (dense decoder, Mamba-2, MoE and the Whisper
encoder-decoder) against the reference, on the CPU.

Both packages get the same weights (the reference's seeded init, bridged
through ``params_from_numpy``) and the same numpy inputs (Whisper also
the same encoder frames).  Logits agree to fp32 ``atol = rtol = 1e-4``;
greedy tokens are identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import generate_dense
from repro.models.params import param_shapes as j_param_shapes
from repro.models.sharding import CPU_CTX as J_CTX
from repro.models.transformer import forward as j_forward
from repro_torch.models.params import (count_params, init_params,
                                       param_shapes, params_from_numpy)
from repro_torch.models.sharding import CPU_CTX, make_context
from repro_torch.models.transformer import forward

DENSE_FAMILIES = ["chatglm3-6b", "nemotron-4-15b", "phi4-mini-3.8b",
                  "llama3-70b", "qwen2-vl-72b", "mixtral-8x22b"]
ARCHS = ["llama3-8b", "yi-9b", "mamba2-1.3b", "qwen2-moe-a2.7b",
         *DENSE_FAMILIES, "whisper-medium", "jamba-1.5-large-398b"]
ATTN_ARCHS = ["llama3-8b", "yi-9b", "qwen2-moe-a2.7b", *DENSE_FAMILIES]
TOL = dict(atol=1e-4, rtol=1e-4)


def _positions(cfg, B, S, offset=0):
    """(B, S) int32 positions, as (3, B, S) identical rows for M-RoPE
    (text tokens: temporal, height and width positions agree)."""
    pos = np.broadcast_to(np.arange(offset, offset + S, dtype=np.int32),
                          (B, S))
    if cfg.rope_type == "mrope":
        pos = np.broadcast_to(pos[None], (3, B, S))
    return pos.copy()


def _frames(cfg, B):
    """The stubbed audio frontend's (B, cross_kv_len, d_model) encoder
    frames of an encoder-decoder, from a seed; None for a decoder."""
    if not cfg.encoder_decoder:
        return None
    return np.random.default_rng(5).standard_normal(
        (B, cfg.cross_kv_len, cfg.d_model)).astype(np.float32)


def _enc_kw(frames, to):
    """``encoder_frames=`` for one package (``to``: jnp.asarray or
    torch.from_numpy), or nothing."""
    return {} if frames is None else {"encoder_frames": to(frames)}


def _port_cfg(cfg):
    from repro_torch.configs.registry import get_config
    return get_config(cfg.name.replace("-reduced", "")).reduced()


def _bridged(reduced_params_cache, name):
    cfg, jp = reduced_params_cache(name)
    return cfg, jp, params_from_numpy(jp, _port_cfg(cfg), device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_param_tree_matches_reference(name, reduced_params_cache):
    cfg, jp, tp = _bridged(reduced_params_cache, name)
    assert dataclasses.asdict(_port_cfg(cfg)) == dataclasses.asdict(cfg)
    assert param_shapes(_port_cfg(cfg)) == j_param_shapes(cfg)
    assert count_params(tp) == sum(np.size(x) for x in jax.tree.leaves(jp))
    fresh = init_params(_port_cfg(cfg), seed=3, device="cpu")
    again = init_params(_port_cfg(cfg), seed=3, device="cpu")
    mat = "wq" if "wq" in fresh["blocks"]["0"] else "wxbc"
    assert torch.equal(fresh["blocks"]["0"][mat], again["blocks"]["0"][mat])
    assert torch.equal(fresh["final_norm"], torch.ones(cfg.d_model))
    if cfg.ssm is not None:
        # the reference's SSM rules: softplus(dt_bias) in [1e-3, 1e-1],
        # -A = exp(A_log) in [1, 16], D and the gate norm at one, fp32
        b = fresh["blocks"]["0"]
        sp = torch.nn.functional.softplus(b["dt_bias"])
        assert sp.min() >= 1e-3 * 0.999 and sp.max() <= 1e-1 * 1.001
        a = torch.exp(b["A_log"])
        assert a.min() >= 1.0 and a.max() <= 16.0
        assert torch.equal(b["D"], torch.ones_like(b["D"]))
        assert not b["conv_b"].any()
        assert all(b[k].dtype == torch.float32
                   for k in ("dt_bias", "A_log", "D", "norm"))


def test_entry_points_default_to_cuda():
    """Without a card, asking for the default device raises instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_context()


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_matches_reference(name, mode, reduced_params_cache):
    cfg, jp, tp = _bridged(reduced_params_cache, name)
    rng = np.random.default_rng(0)
    B, S = 2, 24
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = _positions(cfg, B, S)
    frames = _frames(cfg, B)
    want, want_aux, jc = j_forward(jp, cfg, J_CTX, jnp.asarray(tok),
                                   jnp.asarray(pos), mode,
                                   **_enc_kw(frames, jnp.asarray))
    got, aux, tc = forward(tp, _port_cfg(cfg), CPU_CTX,
                           torch.from_numpy(tok), torch.from_numpy(pos), mode,
                           **_enc_kw(frames, torch.from_numpy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if frames is not None:
        # the encoder-decoder is also held at the reference's own
        # prefill-vs-train tolerance (tests/test_torch_whisper.py)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-4)
    # the MoE layers' summed load-balance loss (0 without MoE layers)
    assert abs(float(aux) - float(want_aux)) <= 1e-5
    assert (float(aux) > 0) == (cfg.moe is not None)
    if mode == "prefill":
        # attention: the chunk's k/v; Mamba-2: its conv window and state
        for part, want_c in jc["0"]["self"].items():
            np.testing.assert_allclose(tc["0"]["self"][part].numpy(),
                                       np.asarray(want_c), **TOL)


@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_paged_decode_matches_reference(name, reduced_params_cache):
    """One fused paged decode tick: logits and the written pools agree;
    the port writes its pools in place and hands back the same tensors."""
    cfg, jp, tp = _bridged(reduced_params_cache, name)
    rng = np.random.default_rng(1)
    B, page, n_pages = 3, 8, 16
    nb, kvh, dh = cfg.n_blocks, cfg.n_kv_heads, cfg.head_dim_
    shape = (nb, n_pages + 1, page, kvh, dh)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    bt = rng.permutation(n_pages)[:B * 3].reshape(B, 3).astype(np.int32)
    bt[2] = n_pages                               # an idle, padded row
    clen = np.asarray([5, 19, 0], np.int32)
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    bt_b = np.broadcast_to(bt, (nb, B, 3)).copy()
    jc = {"0": {"self": {"k": jnp.asarray(kp), "v": jnp.asarray(vp),
                         "block_table": jnp.asarray(bt_b)}}}
    dpos = clen[:, None]
    if cfg.rope_type == "mrope":
        dpos = np.broadcast_to(dpos[None], (3, B, 1)).copy()
    want, _, jn = j_forward(jp, cfg, J_CTX, jnp.asarray(tok),
                            jnp.asarray(dpos), "decode", caches=jc,
                            cache_len=jnp.asarray(clen))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tcache = {"0": {"self": {"k": tk, "v": tv,
                             "block_table": torch.from_numpy(bt_b)}}}
    got, _, tn = forward(tp, _port_cfg(cfg), CPU_CTX, torch.from_numpy(tok),
                         torch.from_numpy(dpos), "decode",
                         caches=tcache, cache_len=torch.from_numpy(clen))
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want)[:2], **TOL)
    assert tn["0"]["self"]["k"] is tk and tn["0"]["self"]["v"] is tv
    for t, j in ((tk, jn["0"]["self"]["k"]), (tv, jn["0"]["self"]["v"])):
        np.testing.assert_allclose(t[:, :-1].numpy(), np.asarray(j)[:, :-1],
                                   **TOL)


def test_ssm_decode_matches_reference(reduced_params_cache):
    """Mamba-2 decode ticks from a prefill's (conv window, state) caches:
    logits and the stepped caches agree."""
    cfg, jp, tp = _bridged(reduced_params_cache, "mamba2-1.3b")
    rng = np.random.default_rng(1)
    B, S = 2, 20
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    _, _, jc = j_forward(jp, cfg, J_CTX, jnp.asarray(tok), jnp.asarray(pos),
                         "prefill")
    tc = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jc)
    for s in range(S, S + 3):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        clen = np.full((B,), s, np.int32)
        want, _, jc = j_forward(jp, cfg, J_CTX, jnp.asarray(nxt),
                                jnp.asarray(clen[:, None]), "decode",
                                caches=jc, cache_len=jnp.asarray(clen))
        got, _, tc = forward(tp, _port_cfg(cfg), CPU_CTX,
                             torch.from_numpy(nxt),
                             torch.from_numpy(clen[:, None]), "decode",
                             caches=tc, cache_len=torch.from_numpy(clen))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for part in ("conv", "ssm"):
            np.testing.assert_allclose(tc["0"]["self"][part].numpy(),
                                       np.asarray(jc["0"]["self"][part]),
                                       **TOL)


def _generate(params, cfg, prompt, n, frames=None):
    toks = [int(t) for t in prompt]
    for _ in range(n):
        t = torch.tensor(toks)[None]
        pos = torch.from_numpy(_positions(cfg, 1, len(toks)))
        logits, _, _ = forward(params, cfg, CPU_CTX, t, pos, "train",
                               **_enc_kw(frames, torch.from_numpy))
        toks.append(int(torch.argmax(logits[0, -1, :cfg.vocab_size])))
    return toks[len(prompt):]


def _generate_ref(params, cfg, prompt, n, frames=None):
    """conftest.generate_dense with (3, B, S) positions, which the
    reference's M-RoPE requires, or with the encoder frames of an
    encoder-decoder (its forward jitted: one compile of both stacks a
    step instead of an eager scan of each)."""
    toks = list(prompt)
    fwd = j_forward
    if frames is not None:
        fwd = jax.jit(lambda p, t, pos: j_forward(
            p, cfg, J_CTX, t, pos, "train",
            encoder_frames=jnp.asarray(frames)))
    for _ in range(n):
        args = (params, jnp.asarray(toks)[None],
                jnp.asarray(_positions(cfg, 1, len(toks))))
        logits, _, _ = (fwd(*args) if frames is not None
                        else fwd(args[0], cfg, J_CTX, *args[1:], "train"))
        toks.append(int(jnp.argmax(logits[0, -1, :cfg.vocab_size])))
    return toks[len(prompt):]


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_tokens_match_generate_dense(name, reduced_params_cache):
    cfg, jp, tp = _bridged(reduced_params_cache, name)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 17)
    frames = _frames(cfg, 1)
    ref = (_generate_ref if cfg.rope_type == "mrope" or cfg.encoder_decoder
           else generate_dense)
    assert (_generate(tp, _port_cfg(cfg), prompt, 6, frames)
            == ref(jp, cfg, prompt, 6, *(() if frames is None
                                         else (frames,))))


def test_moe_capacity_drops_tokens(reduced_params_cache):
    """The reference's ``tests/test_models.py::test_moe_capacity_drops_tokens``
    on reduced Qwen1.5-MoE: with a tiny capacity factor the routed output
    differs from the dropless one (tokens over capacity fall back to the
    residual path), and equals the reference's under the same capacity."""
    cfg, jp, tp = _bridged(reduced_params_cache, "qwen2-moe-a2.7b")
    jtight, ttight = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=0.25)) for c in (cfg, _port_cfg(cfg)))
    rng = np.random.default_rng(1)
    B, S = 2, 24
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    t_tok, t_pos = torch.from_numpy(tok), torch.from_numpy(pos)
    a, _, _ = forward(tp, _port_cfg(cfg), CPU_CTX, t_tok, t_pos, "train")
    b, _, _ = forward(tp, ttight, CPU_CTX, t_tok, t_pos, "train")
    assert float((a - b).abs().max()) > 1e-4
    want, _, _ = j_forward(jp, jtight, J_CTX, jnp.asarray(tok),
                           jnp.asarray(pos), "train")
    np.testing.assert_allclose(b.numpy(), np.asarray(want), **TOL)
