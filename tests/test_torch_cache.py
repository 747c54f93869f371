"""The port's cache manager: the BlockManager properties of
``tests/test_block_manager.py`` re-run against the port's copy, and the
PagedKVCache page operations held to the reference's on the same data."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.serving.cache_manager as port_cm
from repro.configs.registry import get_config as j_get_config
from repro.serving.cache_manager import PagedKVCache as JPagedKVCache
from repro.serving.kv_offload import HostKVPool as JHostKVPool
from repro_torch.configs.registry import get_config
from repro_torch.serving.cache_manager import PagedKVCache
from repro_torch.serving.kv_offload import HostKVPool

# --- the reference's BlockManager properties, run against the port's copy:
# the test module's source with its import pointed at repro_torch, executed
# here so pytest collects every property under this file
_SRC = (Path(__file__).with_name("test_block_manager.py").read_text()
        .replace("from repro.serving.cache_manager",
                 "from repro_torch.serving.cache_manager"))
_ns = {"__name__": __name__, "__file__": __file__}
exec(compile(_SRC, "test_block_manager.py (against repro_torch)", "exec"),
     _ns)
assert _ns["BlockManager"] is port_cm.BlockManager
globals().update({k: v for k, v in _ns.items() if k.startswith("test_")})


# --------------------------------------------------------- page round trip
PAGE, TOTAL = 8, 10


def _caches():
    jcfg = j_get_config("yi-9b").reduced()
    cfg = get_config("yi-9b").reduced()
    return (jcfg, JPagedKVCache(jcfg, TOTAL, PAGE),
            cfg, PagedKVCache(cfg, TOTAL, PAGE, device="cpu"))


def _same(tkv, jkv):
    for part in ("k", "v"):
        np.testing.assert_array_equal(tkv.pools["0"][part].numpy(),
                                      np.asarray(jkv.pools["0"][part]))


def test_paged_kv_cache_ops_match_reference():
    """write_chunk, copy_within, read_blocks, host store + copy_from
    (swap-in), device copy_from (admission) and adopt: the port mutates its
    pool tensors in place, byte-identical to the reference's pools."""
    jcfg, jkv, cfg, tkv = _caches()
    rng = np.random.default_rng(0)
    nb, kvh, dh = cfg.n_blocks, cfg.n_kv_heads, cfg.head_dim_
    live = {p: tkv.pools["0"][p] for p in ("k", "v")}
    blocks = [7, 2, 5]
    off = 0
    for L in (11, 9):
        kv = {p: rng.standard_normal((nb, 1, L, kvh, dh)).astype(np.float32)
              for p in ("k", "v")}
        pos = np.arange(off, off + L, dtype=np.int32)[None]
        jkv.write_chunk(blocks, {"0": {"self": {
            p: jnp.asarray(a) for p, a in kv.items()}}}, jnp.asarray(pos))
        tkv.write_chunk(blocks, {"0": {"self": {
            p: torch.from_numpy(a) for p, a in kv.items()}}},
            torch.from_numpy(pos))
        off += L
    _same(tkv, jkv)
    jkv.copy_within(5, 9)
    tkv.copy_within(5, 9)
    _same(tkv, jkv)
    got = tkv.read_blocks([2, 9])
    want = jkv.read_blocks([2, 9])
    np.testing.assert_array_equal(got["0"]["k"].numpy(), want["0"]["k"])
    # host tier round trip: store pages, then swap them into other blocks
    jhost, thost = JHostKVPool(jcfg, 4, PAGE), HostKVPool(cfg, 4, PAGE)
    jhost.store([1, 3], want)
    thost.store([1, 3], got)
    jkv.copy_from(jhost, [3, 1], [0, 4])
    tkv.copy_from(thost, [3, 1], [0, 4])
    _same(tkv, jkv)
    # admission: device pool to device pool
    jdst, tdst = JPagedKVCache(jcfg, TOTAL, PAGE), PagedKVCache(
        cfg, TOTAL, PAGE, device="cpu")
    jdst.copy_from(jkv, [7, 2, 5], [1, 6, 3])
    tdst.copy_from(tkv, [7, 2, 5], [1, 6, 3])
    _same(tdst, jdst)
    assert all(tkv.pools["0"][p] is live[p] for p in ("k", "v"))
    tkv.adopt({"0": {"self": dict(live)}})
    with pytest.raises(RuntimeError, match="in place"):
        tkv.adopt({"0": {"self": {p: t.clone() for p, t in live.items()}}})
    # a striped pool lives on a mesh's positions: none given, it refuses
    with pytest.raises(ValueError, match="mesh"):
        PagedKVCache(cfg, TOTAL, PAGE, kv_shards=2, device="cpu")
