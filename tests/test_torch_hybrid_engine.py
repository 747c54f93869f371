"""The hybrid (reduced Jamba-1.5-Large) through the port's ServingEngine
against the reference engine on the CPU, and the layer cut phase serve
runs on the card (the published layers 0-4) against the reference's
forward.

One request of the hybrid carries KV pages for its attention layers and
SSM aux state (the SSD state and conv window) for its Mamba layers,
from chunk to chunk and into the decode batch.  The engine clock is
modelled, so the records must match exactly.  Both engines run once, on
the ``multichunk_paged`` trace of ``tests/test_torch_engine.py`` (two
chunks a prompt, SP 1 -> 2), and the module's cases share the run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.params import init_params as j_init_params
from repro.models.sharding import CPU_CTX as J_CTX
from repro.models.transformer import forward as j_forward
from repro_torch.configs.registry import get_config
from repro_torch.models.params import params_from_numpy
from repro_torch.models.sharding import CPU_CTX
from repro_torch.models.transformer import forward
from repro_torch.serving.engine import PagedDecodeState
from port_fixtures import (one_torch_thread,  # noqa: F401
                           reference_compile_cache)
from test_torch_engine import SCENARIOS, _run, _trace

pytestmark = pytest.mark.usefixtures("reference_compile_cache")
ARCH = "jamba-1.5-large-398b"
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def engines(reduced_params_cache):
    """Both engines on the hybrid's ``multichunk_paged`` trace, and what
    each admitted request carried into the port's decode batch:
    {rid: (pages, {layer: aux state parts})}."""
    sc = SCENARIOS["multichunk_paged"]
    jcfg, jp = reduced_params_cache(ARCH)
    cfg = get_config(ARCH).reduced()
    tp = params_from_numpy(jp, cfg, device="cpu")
    reqs = _trace(cfg, **sc["trace"])
    ref = _run("ref", jp, jcfg, sc["spec"], sc["policy"], reqs, sc["engine"])
    held = {}
    insert = PagedDecodeState.insert

    def recording(self, row, rid, aux_history, cache_len, last_token,
                  blocks, *args, **kw):
        insert(self, row, rid, aux_history, cache_len, last_token, blocks,
               *args, **kw)
        held[rid] = (len(blocks), {k: sorted(v["self"]) for k, v in
                                   self.row_state(rid).items()})

    PagedDecodeState.insert = recording
    try:
        port = _run("port", tp, cfg, sc["spec"], sc["policy"], reqs,
                    sc["engine"])
    finally:
        PagedDecodeState.insert = insert
    return cfg, ref, port, held


def test_hybrid_engine_records_match_reference(engines):
    cfg, ref, port, _ = engines
    assert port.outputs == ref.outputs
    assert port.chunk_log == ref.chunk_log
    assert port.preempt_log == ref.preempt_log
    assert port.mixed_stats == ref.mixed_stats
    assert port.swap_stats == ref.swap_stats
    assert all(len(v) > 0 for v in port.outputs.values())
    assert all(len(r.chunk_plan) == 2 for r in port.reqs.values())


def test_hybrid_requests_carry_pages_and_ssm_state(engines):
    """Each admitted request held KV pages (its attention layers') and,
    for every Mamba layer, the SSD state and conv window."""
    cfg, _, port, held = engines
    mamba = {str(i) for i, s in enumerate(cfg.pattern) if s.mixer == "mamba"}
    assert any(s.mixer == "attn" for s in cfg.pattern) and mamba
    assert sorted(held) == sorted(port.reqs)
    for rid, (pages, aux) in held.items():
        need = -(-port.reqs[rid].prompt_len
                 // SCENARIOS["multichunk_paged"]["engine"]["block_size"])
        assert pages >= need > 0
        assert set(aux) == mamba
        assert all(parts == ["conv", "ssm"] for parts in aux.values())


def _cut(cfg, n: int):
    """The published layers 0..n-1 of a period, as one block (the cut
    chip_smoke.py serves at full width)."""
    return dataclasses.replace(cfg, n_layers=n, pattern=cfg.pattern[:n])


@pytest.fixture(scope="module")
def layer_cut(reduced_params_cache):
    jcfg = _cut(reduced_params_cache(ARCH)[0], 5)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = _cut(get_config(ARCH).reduced(), 5)
    return jcfg, jp, cfg, params_from_numpy(jp, cfg, device="cpu")


def test_layer_cut_forward_matches_reference(layer_cut):
    """Jamba's layers 0-4 (Mamba at 0-3, MoE at 1 and 3, attention at 4)
    at reduced widths: the prefill's logits and caches, then one paged
    decode tick from those caches (the attention layer's KV in pages,
    the Mamba layers' SSD state and conv window), agree with the
    reference's on the same weights."""
    jcfg, jp, cfg, tp = layer_cut
    assert [s.mixer for s in cfg.pattern] == ["mamba"] * 4 + ["attn"]
    assert [s.ffn for s in cfg.pattern] == ["dense", "moe"] * 2 + ["dense"]
    rng = np.random.default_rng(2)
    B, S, page = 2, 20, 8
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want, _, jc = j_forward(jp, jcfg, J_CTX, jnp.asarray(tok),
                            jnp.asarray(pos), "prefill")
    got, _, tc = forward(tp, cfg, CPU_CTX, torch.from_numpy(tok),
                         torch.from_numpy(pos), "prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key, ent in jc.items():
        for part, w in ent["self"].items():
            np.testing.assert_allclose(tc[key]["self"][part].numpy(),
                                       np.asarray(w), **TOL)

    # the prefill's KV into pages (row r on pages 3r .. 3r + 2), then one
    # tick at position S: the same numpy caches to both packages
    npg = -(-(S + 1) // page)
    k = np.asarray(jc["4"]["self"]["k"])            # (nb, B, S, KVH, D)
    v = np.asarray(jc["4"]["self"]["v"])
    pools = {p: np.zeros((1, B * npg + 1, page) + k.shape[3:], np.float32)
             for p in "kv"}
    bt = np.arange(B * npg, dtype=np.int32).reshape(B, npg)
    for r in range(B):
        for p, src in (("k", k), ("v", v)):
            flat = np.zeros((npg * page,) + k.shape[3:], np.float32)
            flat[:S] = src[0, r]
            pools[p][0, bt[r]] = flat.reshape((npg, page) + k.shape[3:])
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    clen = np.full((B,), S, np.int32)

    def caches(to):
        out = {key: {"self": {p: to(np.array(a))
                              for p, a in ent["self"].items()}}
               for key, ent in jc.items() if key != "4"}
        out["4"] = {"self": {"k": to(pools["k"].copy()),
                             "v": to(pools["v"].copy()),
                             "block_table": to(bt[None].copy())}}
        return out

    want, _, jn = j_forward(jp, jcfg, J_CTX, jnp.asarray(nxt),
                            jnp.asarray(clen[:, None]), "decode",
                            caches=caches(jnp.asarray),
                            cache_len=jnp.asarray(clen))
    got, _, tn = forward(tp, cfg, CPU_CTX, torch.from_numpy(nxt),
                         torch.from_numpy(clen[:, None]), "decode",
                         caches=caches(torch.from_numpy),
                         cache_len=torch.from_numpy(clen))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("0", "3"):
        for part in ("conv", "ssm"):
            np.testing.assert_allclose(tn[key]["self"][part].numpy(),
                                       np.asarray(jn[key]["self"][part]),
                                       **TOL)
    for part in ("k", "v"):
        np.testing.assert_allclose(tn["4"]["self"][part][:, :-1].numpy(),
                                   np.asarray(jn["4"]["self"][part])[:, :-1],
                                   **TOL)
