"""CDSP chunked prefill in the port: chunked equals monolithic (attention
over the concatenated history; for Mamba-2 the SSD state and conv window
handed from chunk to chunk), and the paged chunk path equals the
reference's ``prefill_chunk_paged`` on the same weights, tokens and page
layout (fp32, ``atol = rtol = 1e-4``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cdsp import prefill_chunk_paged as j_prefill_chunk_paged
from repro.models.sharding import CPU_CTX as J_CTX
from repro.serving.cache_manager import PagedKVCache as JPagedKVCache
from repro_torch.configs.registry import get_config
from repro_torch.core.cdsp import (chunked_prefill, history_to_decode_caches,
                                   prefill_chunk_paged)
from repro_torch.models.params import params_from_numpy
from repro_torch.models.sharding import CPU_CTX
from repro_torch.models.transformer import forward
from repro_torch.serving.cache_manager import PagedKVCache

B = 2


def _setup(reduced_params_cache, name):
    jcfg, jp = reduced_params_cache(name)
    cfg = get_config(name).reduced()
    return cfg, jcfg, jp, params_from_numpy(jp, cfg, device="cpu")


def _tokens(cfg, S, seed, batch=B):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, S)))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(batch, S)
    return tok, pos


@pytest.mark.parametrize("name", ["llama3-8b", "yi-9b", "mamba2-1.3b",
                                  "qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("chunks", [[16, 48], [8, 24, 32], [1, 63]])
def test_chunked_equals_monolithic(name, chunks, reduced_params_cache):
    cfg, _, _, params = _setup(reduced_params_cache, name)
    tok, pos = _tokens(cfg, sum(chunks), 1)
    mono, _, _ = forward(params, cfg, CPU_CTX, tok, pos, "prefill")
    chunked, _ = chunked_prefill(params, cfg, CPU_CTX, tok, pos, chunks)
    np.testing.assert_allclose(chunked.numpy(), mono.numpy(), atol=5e-5,
                               rtol=2e-3)


@pytest.mark.parametrize("name", ["llama3-8b", "yi-9b", "qwen2-moe-a2.7b"])
def test_paged_chunks_match_reference(name, reduced_params_cache):
    """The engine's chunk path: each chunk attends to earlier chunks
    through the page pool and scatters its own KV into pages."""
    cfg, jcfg, jp, params = _setup(reduced_params_cache, name)
    page, chunks = 8, [13, 24, 19]
    S = sum(chunks)
    tok, pos = _tokens(cfg, S, 2, batch=1)
    n = -(-S // page)
    blocks = list(np.random.default_rng(3).permutation(2 * n)[:n])
    jkv = JPagedKVCache(jcfg, 2 * n, page)
    tkv = PagedKVCache(cfg, 2 * n, page, device="cpu")
    off = 0
    for L in chunks:
        hist = blocks[:-(-off // page)]
        sl = slice(off, off + L)
        want, jnc, _ = j_prefill_chunk_paged(
            jp, jcfg, J_CTX, jnp.asarray(tok[:, sl].numpy()),
            jnp.asarray(pos[:, sl].numpy()), jkv.pools, hist, off)
        jkv.write_chunk(blocks, jnc, jnp.asarray(pos[:, sl].numpy()))
        got, tnc, aux = prefill_chunk_paged(params, cfg, CPU_CTX,
                                            tok[:, sl], pos[:, sl],
                                            tkv.pools, hist, off)
        tkv.write_chunk(blocks, tnc, pos[:, sl])
        assert aux is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        off += L
    for part in ("k", "v"):
        np.testing.assert_allclose(tkv.pools["0"][part].numpy(),
                                   np.asarray(jkv.pools["0"][part]),
                                   atol=1e-4, rtol=1e-4)


def test_decode_after_chunked_handoff(reduced_params_cache):
    """Dense history -> decode caches: the next decode step equals the
    full forward's last position."""
    cfg, _, _, params = _setup(reduced_params_cache, "yi-9b")
    S = 48
    tok, pos = _tokens(cfg, S, 4)
    clog, hist = chunked_prefill(params, cfg, CPU_CTX, tok, pos, [16, 8, 24])
    caches, _ = history_to_decode_caches(cfg, hist, max_seq=96)
    ntok = torch.argmax(clog[:, 0, :cfg.vocab_size], -1)[:, None]
    clen = torch.full((B,), S, dtype=torch.int32)
    dlog, _, _ = forward(params, cfg, CPU_CTX, ntok, clen[:, None], "decode",
                         caches=caches, cache_len=clen)
    full, _, _ = forward(params, cfg, CPU_CTX, torch.cat([tok, ntok], 1),
                         torch.arange(S + 1, dtype=torch.int32)[None]
                         .expand(B, S + 1), "train")
    np.testing.assert_allclose(dlog[:, 0].numpy(), full[:, -1].numpy(),
                               atol=5e-5, rtol=2e-3)
