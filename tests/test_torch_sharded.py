"""The port's sequence-parallel islands against the reference on the CPU.

The reference proves its sharded paths in multi-device programs
(tests/dist_progs), which tier-1 skips.  Here the port's islands, driven
by one process over a 4-position CPU mesh (launch/mesh.py), are held to
the reference's single-device functions on the same numpy inputs, and to
the reference's own island bodies run under ``jax.vmap`` with a named
axis (vmap gives ``lax.psum``, ``axis_index``, ``all_gather`` and
``ppermute`` the semantics of a one-device mesh axis)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ring_attention as j_ring
from repro.kernels import ops as j_ops
from repro.kernels.ref import attention_ref as j_attention_ref
from repro.kernels.ref import decode_attention_ref as j_decode_ref
from repro.kernels.ref import paged_prefill_attention_ref as j_prefill_ref
from repro.models.sharding import CPU_CTX as J_CPU_CTX
from repro.models.transformer import forward as j_forward
from repro_torch.configs.registry import get_config
from repro_torch.core import ring_attention as t_ring
from repro_torch.core.cdsp import prefill_chunk
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.ref import sharded_pool_view
from repro_torch.launch.mesh import Mesh, make_context, make_mesh
from repro_torch.models.params import params_from_numpy
from repro_torch.models.sharding import ExecContext
from repro_torch.serving.cache_manager import PagedKVCache
from stripe_util import stripe_pool

ATOL = 1e-5          # fp32 on both sides, one softmax vs merged partials


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _mesh(n=4, axis="x"):
    return make_mesh((n,), (axis,), device="cpu")


# ------------------------------------------------------------------- mesh
def test_mesh_positions_contexts_and_collectives():
    """Axis positions are row-major; the serve_paged context puts both
    roles on "data"; ring_shift is ppermute j -> j + 1; split/unsplit
    round-trip."""
    from repro_torch.launch.mesh import all_gather, ring_shift, split, unsplit
    m = Mesh(("data", "model"), (2, 3), ["cpu"] * 6)
    assert m.shape == {"data": 2, "model": 3}
    assert m.positions("data") == (m.devices[0], m.devices[3])
    assert len(m.positions("model")) == 3
    ctx = make_context(make_mesh((4, 1), ("data", "model"), device="cpu"),
                       "serve_paged")
    assert (ctx.sp_axis, ctx.kv_split_axis, ctx.tp_axis) == ("data", "data",
                                                           None)
    assert ctx.pool_shards("prefill") == ctx.pool_shards("decode") == 4
    assert ctx.pool_head_axis(8) is None and ctx.device == torch.device("cpu")
    assert ctx.with_(active_pool_shards=2).active_shards("decode") == 2
    assert make_context(ctx.mesh, "prefill").pool_shards("decode") == 1
    with pytest.raises(ValueError):
        make_context(ctx.mesh, "train")
    with pytest.raises(ValueError):
        ExecContext(mesh=ctx.mesh, sp_axis="sp")
    devs = ctx.mesh.positions("data")
    xs = [torch.full((2,), float(i)) for i in range(4)]
    assert [int(x[0]) for x in ring_shift(xs, devs)] == [3, 0, 1, 2]
    assert all_gather(xs, devs[0]).shape == (4, 2)
    x = torch.arange(24.).reshape(1, 8, 3)
    parts = split(x, devs)
    assert [p.shape[1] for p in parts] == [2] * 4
    assert all(p.is_contiguous() for p in parts)
    assert torch.equal(unsplit(parts, devs[0]), x)


# --------------------------------------------------------------- ring
@pytest.mark.parametrize("window", [None, 13])
def test_ring_attention_matches_reference(window):
    """ring_attention on a 4-position mesh (contiguous layout; shapes of
    dist_progs/ring_attention_prog.py) against the reference's
    attention_ref and its ring body under vmap; atol 1e-5."""
    rng = np.random.default_rng(0)
    B, S, H, KVH, D, n = 2, 64, 8, 2, 32, 4
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (H, KVH, KVH))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    got = t_ring.ring_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                mesh=_mesh(n), sp_axis="x", window=window)
    want = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(pos), jnp.asarray(pos), window=window)
    _close(got, want)

    def shards(a):                                  # (n, B, S/n, ...)
        return jnp.asarray(np.stack(np.split(a, n, axis=1)))

    body = functools.partial(j_ring.ring_attention_local, axis_name="x",
                             window=window, impl="ref")
    o_j, _ = jax.vmap(body, axis_name="x")(*map(shards, (q, k, v, pos, pos)))
    _close(got, np.concatenate(list(np.asarray(o_j)), axis=1))


# ------------------------------------------------------ striped pool layout
@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_paged_layout_matches_unsharded_oracle(n_shards):
    """tests/test_prefix_sharing.py's striped-layout check: the same numpy
    striped pools and tables through the reference's and the port's
    ops.paged_decode_attention / ops.paged_prefill_attention (plain path);
    the logical view equals the dense KV exactly; atol 1e-5."""
    rng = np.random.default_rng(5)
    B, H, KVH, D, page, npg = 2, 4, 2, 16, 8, 6
    S = page * npg
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    kp, vp, bt = stripe_pool(rng, n_shards, k, v, page)
    # the port's striped pool: one (bps + 1, page, KVH, D) tensor a shard
    tkp, tvp = [_t(x) for x in kp], [_t(x) for x in vp]
    assert torch.equal(sharded_pool_view(tkp, _t(bt)), _t(k))
    lengths = np.asarray([19, 42], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    for window in (None, 8):
        got = t_ops.paged_decode_attention(_t(q), tkp, tvp, _t(bt),
                                           _t(lengths), window=window)
        want = j_ops.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(lengths), window=window,
            impl="ref")
        _close(got, want)
        _close(got, j_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lengths),
                                 window=window))
    Sq = 8
    qc = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, Sq, KVH, D)).astype(np.float32)
    vc = rng.standard_normal((B, Sq, KVH, D)).astype(np.float32)
    pos = np.stack([np.arange(l, l + Sq, dtype=np.int32) for l in lengths])
    got = t_ops.paged_prefill_attention(_t(qc), _t(kc), _t(vc), _t(pos),
                                        _t(pos), tkp, tvp, _t(bt),
                                        _t(lengths))
    want = j_ops.paged_prefill_attention(
        *map(jnp.asarray, (qc, kc, vc, pos, pos, kp, vp, bt, lengths)),
        impl="ref")
    _close(got, want)


# ---------------------------------------------------- sharded paged decode
def _striped(rng, n_phys, n_act, k, v, page):
    """A striped pool over ``n_act`` of ``n_phys`` shards: the shards past
    the live stripe hold nothing and their table rows are all-scratch."""
    kp, vp, bt = stripe_pool(rng, n_act, k, v, page)
    pad = n_phys - n_act
    kp = np.concatenate([kp, np.zeros((pad,) + kp.shape[1:], np.float32)])
    vp = np.concatenate([vp, np.zeros((pad,) + vp.shape[1:], np.float32)])
    bt = np.concatenate([bt, np.full((pad,) + bt.shape[1:], kp.shape[1] - 1,
                                     np.int32)])
    return kp, vp, bt


@pytest.mark.parametrize("active", [None, 2])
def test_sharded_paged_decode_matches_reference(active):
    """The split-KV paged decode with the fused append on 4 positions:
    rows whose append lands on each shard and a row of length 0, over the
    full stripe and a stripe narrowed to 2 shards.  o against the
    reference's decode_attention_ref over the unsharded cache with the
    token appended, and o and the pools against the reference's island
    body under vmap; atol 1e-5 (pools exact outside the scratch pages)."""
    rng = np.random.default_rng(3)
    n, B, H, KVH, D, page, npg = 4, 5, 4, 2, 16, 8, 6
    S = page * npg
    # appends at positions 0, 13, 19, 27, 38: logical pages 0..4, so over
    # the full stripe shards 0, 1, 2, 3, 0
    lengths = np.asarray([0, 13, 19, 27, 38], np.int32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    kp, vp, bt = _striped(rng, n, active or n, k, v, page)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    tkp, tvp = [_t(x) for x in kp], [_t(x) for x in vp]
    live = [x for x in tkp]
    o, k_out, v_out = t_ring.sharded_paged_decode(
        _t(q), tkp, tvp, _t(bt), _t(lengths), mesh=_mesh(n), split_axis="x",
        k_new=_t(kn), v_new=_t(vn), active_shards=active)
    assert k_out is tkp and all(a is b for a, b in zip(k_out, live))
    k_app, v_app = k.copy(), v.copy()
    k_app[np.arange(B), lengths] = kn
    v_app[np.arange(B), lengths] = vn
    _close(o, j_decode_ref(*map(jnp.asarray, (q, k_app, v_app, lengths + 1))))

    body = functools.partial(j_ring.sharded_paged_decode_local,
                             axis_name="x", impl="ref", active_shards=active)
    o_j, kp_j, vp_j = jax.vmap(
        lambda kl, vl, b: body(jnp.asarray(q), kl, vl, b,
                               jnp.asarray(lengths), k_new=jnp.asarray(kn),
                               v_new=jnp.asarray(vn)),
        axis_name="x")(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt))
    _close(o, o_j[0])
    # without an append: the cache as it now stands, lengths + 1 keys
    o2, _, _ = t_ring.sharded_paged_decode(
        _t(q), tkp, tvp, _t(bt), _t(lengths + 1), mesh=_mesh(n),
        split_axis="x", active_shards=active)
    _close(o2, o)
    for got, want in ((tkp, kp_j), (tvp, vp_j)):
        np.testing.assert_array_equal(torch.stack(got)[:, :-1].numpy(),
                                      np.asarray(want)[:, :-1])


# ------------------------------------------------------ ring paged prefill
@pytest.mark.parametrize("window", [None, 10])
def test_ring_paged_prefill_matches_reference(window):
    """A chunk of 16 queries over striped history on 4 positions: history
    lengths 19 and 42 (not page multiples), 6 pages striped over 4 shards
    (shards 2 and 3 carry a scratch-padded column).  Against the
    reference's paged_prefill_attention_ref over the logical view and its
    ring body under vmap; atol 1e-5."""
    rng = np.random.default_rng(9)
    n, B, H, KVH, D, page, npg, Sq = 4, 2, 4, 2, 16, 8, 6, 16
    S = page * npg
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    kp, vp, bt = stripe_pool(rng, n, k, v, page)
    assert (bt[2:, :, -1] == kp.shape[1] - 1).all()     # padded columns
    hist = np.asarray([19, 42], np.int32)
    qc = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, Sq, KVH, D)).astype(np.float32)
    vc = rng.standard_normal((B, Sq, KVH, D)).astype(np.float32)
    pos = np.stack([np.arange(l, l + Sq, dtype=np.int32) for l in hist])
    got = t_ring.ring_paged_prefill(
        _t(qc), _t(kc), _t(vc), _t(pos), _t(pos), [_t(x) for x in kp],
        [_t(x) for x in vp], _t(bt), _t(hist), mesh=_mesh(n), sp_axis="x",
        window=window)
    want = j_prefill_ref(*map(jnp.asarray, (qc, kc, vc, pos, pos, kp, vp,
                                            bt, hist)), window=window)
    _close(got, want)

    def shards(a):
        return jnp.asarray(np.stack(np.split(a, n, axis=1)))

    body = functools.partial(j_ring.ring_paged_prefill_local, axis_name="x",
                             window=window, impl="ref")
    o_j, _ = jax.vmap(
        lambda a, b, c, d, e, f, g, h: body(a, b, c, d, e, f, g, h,
                                            jnp.asarray(hist)),
        axis_name="x")(*map(shards, (qc, kc, vc, pos, pos)),
                       jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt))
    _close(got, np.concatenate(list(np.asarray(o_j)), axis=1))


# ---------------------------------------------------- striped PagedKVCache
def test_striped_pool_page_ops_keep_logical_content():
    """The striped PagedKVCache against an unsharded one fed the same
    operations: a chunk scatter over striped block ids, copy-on-write
    within a shard, host swap-in, and copies sharded <-> unsharded; every
    page's logical content (read_blocks) stays equal, and the per-shard
    pools stacked are the reference's (nb, n, bps + 1, page, KVH, D)
    layout."""
    from repro_torch.serving.cache_manager import BlockManager
    cfg = get_config("yi-9b").reduced()
    n, total, page = 4, 32, 8
    mesh = _mesh(n, "data")
    sh = PagedKVCache(cfg, total, page, kv_shards=n, mesh=mesh,
                      shard_axis="data")
    flat = PagedKVCache(cfg, total, page, device="cpu")
    assert torch.stack(sh.pools["0"]["k"], dim=1).shape == (
        cfg.n_blocks, n, total // n + 1, page, cfg.n_kv_heads, cfg.head_dim_)
    bm = BlockManager(total_blocks=total, block_size=page, kv_shards=n)
    bm.open(0)
    bm.extend(0, 45)
    blocks = bm.allocs[0]                              # striped global ids
    rng = np.random.default_rng(1)
    kv = {"0": {"self": {p: _t(rng.standard_normal(
        (cfg.n_blocks, 1, 45, cfg.n_kv_heads, cfg.head_dim_)).astype(
            np.float32)) for p in ("k", "v")}}}
    pos = torch.arange(45, dtype=torch.int32)[None]
    sh.write_chunk(blocks, kv, pos)
    flat.write_chunk(blocks, kv, pos)

    def same(ids):
        a, b = sh.read_blocks(ids)["0"], flat.read_blocks(ids)["0"]
        for p in ("k", "v"):
            assert torch.equal(a[p], b[p])

    same(blocks)
    spare = bm.shard_free[bm.shard_of(blocks[2])][0]
    sh.copy_within(blocks[2], spare)
    flat.copy_within(blocks[2], spare)
    same([spare] + blocks)
    host = sh.read_blocks(blocks)                      # swap-out staging
    dst = [bm.shard_free[i % n][1 + i // n] for i in range(len(blocks))]

    class Host:
        pools = host
    sh.copy_from(Host, range(len(blocks)), dst)
    flat.copy_from(Host, range(len(blocks)), dst)
    same(dst + blocks)
    # a decode pool of another size (position-local admission copy)
    sh2 = PagedKVCache(cfg, 2 * total, page, kv_shards=n, mesh=mesh,
                       shard_axis="data")
    bm2 = BlockManager(total_blocks=2 * total, block_size=page, kv_shards=n)
    bm2.open(0)
    bm2.extend(0, 45)
    sh2.copy_from(sh, blocks, bm2.allocs[0])
    flat2 = PagedKVCache(cfg, total, page, device="cpu")
    flat2.copy_from(sh2, bm2.allocs[0], dst)           # sharded -> flat
    sh3 = PagedKVCache(cfg, total, page, kv_shards=n, mesh=mesh,
                       shard_axis="data")
    sh3.copy_from(flat2, dst, blocks)                  # flat -> sharded
    for p in ("k", "v"):
        assert torch.equal(sh3.read_blocks(blocks)["0"][p],
                           flat.read_blocks(blocks)["0"][p])
    with pytest.raises(NotImplementedError, match="later slice"):
        sh.restripe([(blocks[0], dst[1])])


# ------------------------------------------------------- CDSP SP change
def test_cdsp_sp_change_matches_monolithic(reduced_params_cache,
                                           monkeypatch):
    """dist_progs/cdsp_submesh_prog.py: chunk 0 (32 tokens) rings over 2
    positions, its dense history is rebalanced onto 4 (the ring splits it
    evenly), chunk 1 (64 tokens) rings over 4 attending to it.  Against
    the reference's monolithic prefill logits at the program's limits
    (atol 2e-4, rtol 2e-3)."""
    import repro_torch.models.attention as t_attn
    jcfg, jp = reduced_params_cache("yi-9b")
    cfg = get_config("yi-9b").reduced()
    params = params_from_numpy(jp, cfg, device="cpu")
    B, L0, L1 = 2, 32, 64
    S = L0 + L1
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         jcfg.vocab_size))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    ref, _, _ = j_forward(jp, jcfg, J_CPU_CTX, jnp.asarray(tokens),
                          jnp.asarray(pos), "prefill")
    rings = []
    ring = t_attn.ring_attention

    def spy(*a, mesh, **kw):
        rings.append(len(mesh.positions(kw["sp_axis"])))
        return ring(*a, mesh=mesh, **kw)

    monkeypatch.setattr(t_attn, "ring_attention", spy)
    ctx2 = ExecContext(mesh=_mesh(2, "sp"), sp_axis="sp")
    ctx4 = ExecContext(mesh=_mesh(4, "sp"), sp_axis="sp")
    tt, tp = torch.from_numpy(tokens), torch.from_numpy(pos)
    _, hist = prefill_chunk(params, cfg, ctx2, tt[:, :L0], tp[:, :L0])
    logits, _ = prefill_chunk(params, cfg, ctx4, tt[:, L0:], tp[:, L0:],
                              hist)
    assert rings == [2] * cfg.n_layers + [4] * cfg.n_layers
    _close(logits.numpy(), ref, atol=2e-4, rtol=2e-3)
