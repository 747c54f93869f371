"""The port's dense decoder against the reference model, on the CPU.

Both packages get the same weights (the reference's seeded init, bridged
through ``params_from_numpy``) and the same numpy inputs.  Logits agree to
fp32 ``atol = rtol = 1e-4``; greedy tokens are identical.
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

ARCHS = ["llama3-8b", "yi-9b"]
TOL = dict(atol=1e-4, rtol=1e-4)


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
    assert torch.equal(fresh["blocks"]["0"]["wq"], again["blocks"]["0"]["wq"])
    assert torch.equal(fresh["final_norm"], torch.ones(cfg.d_model))


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
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want, _, jc = j_forward(jp, cfg, J_CTX, jnp.asarray(tok),
                            jnp.asarray(pos), mode)
    got, _, tc = forward(tp, _port_cfg(cfg), CPU_CTX, torch.from_numpy(tok),
                         torch.from_numpy(pos), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if mode == "prefill":
        for part in ("k", "v"):
            np.testing.assert_allclose(tc["0"]["self"][part].numpy(),
                                       np.asarray(jc["0"]["self"][part]),
                                       **TOL)


@pytest.mark.parametrize("name", ARCHS)
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
    want, _, jn = j_forward(jp, cfg, J_CTX, jnp.asarray(tok),
                            jnp.asarray(clen[:, None]), "decode", caches=jc,
                            cache_len=jnp.asarray(clen))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tcache = {"0": {"self": {"k": tk, "v": tv,
                             "block_table": torch.from_numpy(bt_b)}}}
    got, _, tn = forward(tp, _port_cfg(cfg), CPU_CTX, torch.from_numpy(tok),
                         torch.from_numpy(clen[:, None]), "decode",
                         caches=tcache, cache_len=torch.from_numpy(clen))
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want)[:2], **TOL)
    assert tn["0"]["self"]["k"] is tk and tn["0"]["self"]["v"] is tv
    for t, j in ((tk, jn["0"]["self"]["k"]), (tv, jn["0"]["self"]["v"])):
        np.testing.assert_allclose(t[:, :-1].numpy(), np.asarray(j)[:, :-1],
                                   **TOL)


def _generate(params, cfg, prompt, n):
    toks = [int(t) for t in prompt]
    for _ in range(n):
        t = torch.tensor(toks)[None]
        pos = torch.arange(len(toks), dtype=torch.int32)[None]
        logits, _, _ = forward(params, cfg, CPU_CTX, t, pos, "train")
        toks.append(int(torch.argmax(logits[0, -1, :cfg.vocab_size])))
    return toks[len(prompt):]


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_tokens_match_generate_dense(name, reduced_params_cache):
    cfg, jp, tp = _bridged(reduced_params_cache, name)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 17)
    assert (_generate(tp, _port_cfg(cfg), prompt, 6)
            == generate_dense(jp, cfg, prompt, 6))
