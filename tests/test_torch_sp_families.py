"""Sequence parallelism for every family, held to the reference on the CPU.

The port's zigzag layout, the zigzag causal-skip ring, the dense split-KV
decode (with the in-island scatter, a window and the collapsed split),
the sequence-parallel SSD scan and expert-parallel MoE run on CPU meshes
driven by one process (launch/mesh.py).  Each is held to the reference's
single-device functions on the same numpy inputs, and, where the
reference has an island body, to that body run under ``jax.vmap`` with a
named axis (vmap gives ``psum``, ``axis_index``, ``all_gather`` and
``ppermute`` the semantics of a one-device mesh axis).  The whole
sharded forwards follow dist_progs/sharded_model_prog.py (yi-9b, Mamba-2
and Jamba prefill and decode; EP in a train forward of Jamba and
Mixtral), and the Mamba-2 engine and the Qwen engine with EP on a
4-position serve_paged mesh give the reference engine's tokens."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.chunk_planner as j_cp
import repro.serving.simulator as j_sim
import repro_torch.core.chunk_planner as t_cp
import repro_torch.serving.simulator as t_sim
from repro.core import ring_attention as j_ring
from repro.core import zigzag as j_zz
from repro.core.latency_model import table1_model as j_table1
from repro.kernels.ref import attention_ref as j_attention_ref
from repro.kernels.ref import decode_attention_ref as j_decode_ref
from repro.kernels.ref import ssd_ref as j_ssd_ref
from repro.models import moe as j_moe
from repro.models.sharding import CPU_CTX as J_CPU_CTX
from repro.models.ssm import mamba_block as j_mamba_block
from repro.models.transformer import forward as j_forward
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import ring_attention as t_ring
from repro_torch.core import zigzag as t_zz
from repro_torch.core.cdsp import shard_dense_caches
from repro_torch.core.latency_model import table1_model as t_table1
from repro_torch.kernels import ops as t_ops
from repro_torch.launch.mesh import make_context, make_mesh
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm
from repro_torch.models.params import params_from_numpy
from repro_torch.models.sharding import CPU_CTX, ExecContext
from repro_torch.models.transformer import _slice
from repro_torch.models.transformer import forward as t_forward
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from test_torch_engine import _two_chunk
from port_fixtures import one_torch_thread  # noqa: F401

ATOL = 1e-5          # fp32 on both sides, one softmax vs merged partials
SSD_ATOL = 2e-4      # the reference's own (dist_progs/ring_attention_prog)
FWD = dict(atol=2e-4, rtol=2e-3)     # dist_progs/sharded_model_prog.py


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _shards(a, n, axis=1):                       # (n, ...) for vmap
    return jnp.asarray(np.stack(np.split(np.asarray(a), n, axis=axis)))


def _counting(monkeypatch, module, name):
    """Count the calls of ``module.name`` (the results unchanged)."""
    orig = getattr(module, name)
    calls = []

    def rec(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, rec)
    return calls


# ------------------------------------------------------------------ zigzag
@pytest.mark.parametrize("S,n", [(8, 1), (16, 2), (64, 4), (96, 3),
                                 (128, 8)])
def test_zigzag_functions_match_reference(S, n):
    """The permutations, their inverse, the striped layout and the
    imbalance equal the reference's; shard / unshard / positions on
    tensors equal its jnp versions."""
    perm = t_zz.zigzag_permutation(S, n)
    assert np.array_equal(perm, j_zz.zigzag_permutation(S, n))
    assert np.array_equal(t_zz.inverse_permutation(perm),
                          j_zz.inverse_permutation(perm))
    assert np.array_equal(t_zz.striped_permutation(S, n),
                          j_zz.striped_permutation(S, n))
    assert t_zz.workload_imbalance(perm, n) == \
        j_zz.workload_imbalance(perm, n)
    assert t_zz.workload_imbalance(perm, n) == pytest.approx(1.0)
    x = np.random.default_rng(S).standard_normal((2, S, 3)).astype(
        np.float32)
    z = t_zz.zigzag_shard(_t(x), n)
    assert np.array_equal(z.numpy(), np.asarray(j_zz.zigzag_shard(
        jnp.asarray(x), n)))
    assert torch.equal(t_zz.zigzag_unshard(z, n), _t(x))
    assert np.array_equal(t_zz.zigzag_shard(_t(x[0]), n, dim=0).numpy(),
                          np.asarray(j_zz.zigzag_shard(jnp.asarray(x[0]), n,
                                                       axis=0)))
    pos = t_zz.zigzag_positions(S, n, offset=5)
    assert pos.dtype == torch.int32
    assert np.array_equal(pos.numpy(), np.asarray(
        j_zz.zigzag_positions(S, n, offset=5)))
    with pytest.raises(ValueError):
        t_zz.zigzag_permutation(S + 1, n)


# ------------------------------------------------------------ zigzag ring
@pytest.mark.parametrize("mesh_shape", [(4,), (4, 2)])
def test_zigzag_ring_matches_reference(mesh_shape, monkeypatch):
    """ring_attention with zigzag_skip on a (4,) mesh and on a (4, 2)
    ("sp", "tp") mesh (query heads over TP, the 2 KV heads replicated and
    sliced per call), shapes of dist_progs/ring_attention_prog.py: held
    to attention_ref on the natural order and to the reference's
    causal-skip body under vmap; atol 1e-5.  Each SP line launches 1
    attention call a position at step 0 and 2 at each later step."""
    rng = np.random.default_rng(0)
    B, S, H, KVH, D, n = 2, 64, 8, 2, 32, 4
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (H, KVH, KVH))
    qz, kz, vz = (np.asarray(j_zz.zigzag_shard(jnp.asarray(x), n))
                  for x in (q, k, v))
    pos = np.broadcast_to(j_zz.zigzag_permutation(S, n).astype(np.int32),
                          (B, S)).copy()
    axes = ("sp", "tp")[:len(mesh_shape)]
    mesh = make_mesh(mesh_shape, axes, device="cpu")
    head_axis = "tp" if len(mesh_shape) == 2 else None
    calls = _counting(monkeypatch, t_ops, "attention")
    got = t_ring.ring_attention(_t(qz), _t(kz), _t(vz), _t(pos), _t(pos),
                                mesh=mesh, sp_axis="sp", head_axis=head_axis,
                                zigzag_skip=True)
    tp = mesh_shape[1] if head_axis else 1
    assert len(calls) == tp * (n + 2 * n * (n - 1))
    want = j_attention_ref(*map(jnp.asarray, (q, k, v)), jnp.arange(S),
                           jnp.arange(S))
    _close(t_zz.zigzag_unshard(got, n), want)
    # the same without the skip: n * n calls a line, the same result
    calls.clear()
    plain = t_ring.ring_attention(_t(qz), _t(kz), _t(vz), _t(pos), _t(pos),
                                  mesh=mesh, sp_axis="sp",
                                  head_axis=head_axis)
    assert len(calls) == tp * n * n
    _close(plain, got)

    body = functools.partial(j_ring.ring_attention_local, axis_name="sp",
                             impl="ref", zigzag_skip=True)
    if head_axis is None:
        o_j, _ = jax.vmap(body, axis_name="sp")(
            *(_shards(x, n) for x in (qz, kz, vz, pos, pos)))
        want_body = np.concatenate(list(np.asarray(o_j)), axis=1)
    else:
        body = functools.partial(body, head_shard_axis="tp")
        qs = jnp.asarray(np.stack([np.stack(np.split(s, tp, axis=2))
                                   for s in np.split(qz, n, axis=1)]))
        inner = jax.vmap(body, in_axes=(0, None, None, None, None),
                         axis_name="tp")
        o_j, _ = jax.vmap(inner, axis_name="sp")(
            qs, *(_shards(x, n) for x in (kz, vz, pos, pos)))
        o_j = np.asarray(o_j)                       # (n, tp, B, S/n, H/tp, D)
        want_body = np.concatenate(
            [np.concatenate(list(o_j[i]), axis=2) for i in range(n)],
            axis=1)
    _close(got, want_body)


# ---------------------------------------------------- split-KV dense decode
def test_split_kv_decode_matches_reference(monkeypatch):
    """split_kv_decode over a 64-slot cache in 4 shards of 16, the new
    token scattered into its shard: rows ending inside a shard, exactly
    on a shard boundary (the new token opens the next shard) and shorter
    than one shard; a window of 13 straddling shards; the collapsed
    ("sp", "tp") split on a (4, 2) mesh (8 shards of 8); and
    sharded_cache_update.  The shard lists are written in place and equal
    the reference's scattered cache exactly; o within atol 1e-5 of
    decode_attention_ref and of the reference's split body under vmap.
    One K4 (decode_attention) call a shard."""
    rng = np.random.default_rng(1)
    B, S, H, KVH, D, n = 4, 64, 8, 2, 32, 4
    k, v = (rng.standard_normal((B, S, KVH, D)).astype(np.float32)
            for _ in range(2))
    lens = np.asarray([37, 47, 5, 61], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, KVH, D)).astype(np.float32)
              for _ in range(2))
    mesh = make_mesh((n,), ("sp",), device="cpu")
    ks = list(torch.chunk(_t(k).clone(), n, dim=1))
    vs = list(torch.chunk(_t(v).clone(), n, dim=1))
    ks, vs = [x.contiguous() for x in ks], [x.contiguous() for x in vs]
    calls = _counting(monkeypatch, t_ops, "decode_attention")
    o, k_out, v_out = t_ring.split_kv_decode(
        _t(q), ks, vs, _t(lens), mesh=mesh, split_axis="sp",
        k_new=_t(kn), v_new=_t(vn))
    assert k_out is ks and v_out is vs and len(calls) == n
    k_ref, v_ref = k.copy(), v.copy()
    k_ref[np.arange(B), lens] = kn
    v_ref[np.arange(B), lens] = vn
    assert torch.equal(torch.cat(ks, 1), _t(k_ref))
    assert torch.equal(torch.cat(vs, 1), _t(v_ref))
    want = j_decode_ref(*map(jnp.asarray, (q, k_ref, v_ref, lens + 1)))
    _close(o, want)
    body = functools.partial(j_ring.split_kv_decode_local, axis_name="sp",
                             impl="ref")
    o_j = jax.vmap(body, in_axes=(None, 0, 0, None), axis_name="sp")(
        jnp.asarray(q), _shards(k_ref, n), _shards(v_ref, n),
        jnp.asarray(lens + 1))
    _close(o, o_j[0])

    # a window of 13 that straddles shards, no new token
    o_w, _, _ = t_ring.split_kv_decode(_t(q), ks, vs, _t(lens + 1),
                                       mesh=mesh, split_axis="sp", window=13)
    _close(o_w, j_decode_ref(*map(jnp.asarray, (q, k_ref, v_ref, lens + 1)),
                             window=13))

    # the collapsed split over both axes of a (4, 2) mesh: 8 shards, index
    # row-major (reference _axis_index_multi)
    mesh2 = make_mesh((4, 2), ("sp", "tp"), device="cpu")
    calls.clear()
    o_c, _, _ = t_ring.split_kv_decode(
        _t(q), list(torch.chunk(_t(k_ref), 8, dim=1)),
        list(torch.chunk(_t(v_ref), 8, dim=1)), _t(lens + 1), mesh=mesh2,
        split_axis=("sp", "tp"))
    assert len(calls) == 8
    _close(o_c, want)
    with pytest.raises(ValueError, match="shards"):
        t_ring.split_kv_decode(_t(q), _t(k_ref), _t(v_ref), _t(lens),
                               mesh=mesh, split_axis="sp")

    # sharded_cache_update alone: the token lands in its shard only
    ks2 = [x.clone() for x in torch.chunk(_t(k), n, dim=1)]
    vs2 = [x.clone() for x in torch.chunk(_t(v), n, dim=1)]
    t_ring.sharded_cache_update(ks2, vs2, _t(kn), _t(vn), _t(lens),
                                mesh=mesh, split_axis="sp")
    assert torch.equal(torch.cat(ks2, 1), _t(k_ref))
    assert torch.equal(torch.cat(vs2, 1), _t(v_ref))


# ------------------------------------------------------- sequence-parallel SSD
def _ssd_inputs(rng, B=2, S=64, H=4, P=16, G=1, N=8):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((H,))).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("mesh_shape", [(4,), (4, 2)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_sp_ssd_matches_reference(mesh_shape, with_h0, monkeypatch):
    """sp_ssd over 4 positions (shapes of dist_progs/ring_attention_prog),
    with and without an incoming state, and on a (4, 2) ("sp", "tp") mesh
    with the heads over TP: y and the final state held to ssd_ref and to
    the reference's sp_ssd_local under vmap, atol 2e-4; one scan call a
    position and TP index."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(np.random.default_rng(2))
    n, chunk = 4, 8
    axes = ("sp", "tp")[:len(mesh_shape)]
    mesh = make_mesh(mesh_shape, axes, device="cpu")
    head_axis = "tp" if len(mesh_shape) == 2 else None
    calls = _counting(monkeypatch, t_ops, "ssd")
    y, h = t_ring.sp_ssd(*map(_t, (x, dt, A, Bm, Cm)), mesh=mesh,
                         sp_axis="sp", chunk=chunk,
                         h0=_t(h0) if with_h0 else None, head_axis=head_axis)
    assert len(calls) == n * (mesh_shape[1] if head_axis else 1)
    y_r, h_r = j_ssd_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                         h0=jnp.asarray(h0) if with_h0 else None,
                         return_state=True)
    _close(y, y_r, atol=SSD_ATOL, rtol=SSD_ATOL)
    _close(h, h_r, atol=SSD_ATOL, rtol=SSD_ATOL)
    body = functools.partial(j_ring.sp_ssd_local, axis_name="sp",
                             chunk=chunk, impl="ref",
                             h0=jnp.asarray(h0) if with_h0 else None)
    y_j, h_j = jax.vmap(body, in_axes=(0, 0, None, 0, 0), axis_name="sp")(
        _shards(x, n), _shards(dt, n), jnp.asarray(A), _shards(Bm, n),
        _shards(Cm, n))
    _close(y, np.concatenate(list(np.asarray(y_j)), axis=1), atol=SSD_ATOL,
           rtol=SSD_ATOL)
    _close(h, h_j[-1], atol=SSD_ATOL, rtol=SSD_ATOL)


@pytest.mark.parametrize("S,sp", [(128, True), (24, False)])
def test_mamba_block_sp_ssd_or_fallback(S, sp, reduced_params_cache,
                                        monkeypatch):
    """mamba_block on a 4-position mesh takes sp_ssd where the chunk
    divides into whole scan chunks a position (128 / 4 = 32, the reduced
    chunk) and falls back to one scan where it does not (24 / 4 = 6):
    outputs and caches (with an incoming conv window and state) held to
    the reference's single-device block, atol 2e-4."""
    jcfg, jp = reduced_params_cache("mamba2-1.3b")
    cfg = get_config("mamba2-1.3b").reduced()
    params = params_from_numpy(jp, cfg, device="cpu")
    p_t = _slice(params["blocks"]["0"], 0)
    p_j = jax.tree.map(lambda a: a[0], jp["blocks"]["0"])
    rng = np.random.default_rng(3)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_ch = d_in + 2 * s.ngroups * s.d_state
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    cache = {"conv": rng.standard_normal((2, s.d_conv - 1, conv_ch)).astype(
        np.float32), "ssm": 0.1 * rng.standard_normal(
            (2, H, s.head_dim, s.d_state)).astype(np.float32)}
    ctx = make_context(make_mesh((4,), ("data",), device="cpu"), "prefill")
    calls = _counting(monkeypatch, t_ssm, "sp_ssd")
    out, c = t_ssm.mamba_block(_t(x), p_t, cfg, ctx, "prefill",
                               cache={k: _t(v) for k, v in cache.items()})
    assert len(calls) == (1 if sp else 0)
    out_j, c_j = j_mamba_block(jnp.asarray(x), p_j, jcfg, J_CPU_CTX,
                               "prefill", cache=jax.tree.map(jnp.asarray,
                                                             cache))
    _close(out, out_j, atol=SSD_ATOL, rtol=SSD_ATOL)
    _close(c["ssm"], c_j["ssm"], atol=SSD_ATOL, rtol=SSD_ATOL)
    _close(c["conv"], c_j["conv"])


# ------------------------------------------------------------ expert parallel
def _moe_case(reduced_params_cache, arch):
    jcfg, jp = reduced_params_cache(arch)
    cfg = get_config(arch).reduced()
    params = params_from_numpy(jp, cfg, device="cpu")
    key = next(k for k, sp in enumerate(cfg.pattern) if sp.ffn == "moe")
    p_t = _slice(params["blocks"][str(key)]["moe"], 0)
    p_j = jax.tree.map(lambda a: a[0], jp["blocks"][str(key)]["moe"])
    return jcfg, cfg, p_j, p_t


@pytest.mark.parametrize("case", ["prefill_chunk", "tick"])
def test_moe_ep_matches_reference(case, reduced_params_cache, monkeypatch):
    """moe_layer under EP on a 4-position mesh (4 experts, one a
    position): a 2048-token chunk of a serve_paged context (4 groups of
    512 over the SP axis: one part a position) and a one-token tick of
    4 rows (no token axes: one part); routing identical to the
    reference's on the same tokens, y within atol 1e-5 of the
    reference's moe_layer (gather dispatch, the dispatch EP runs) and
    aux within rtol 1e-4.  A chunk of 1024 tokens (2 groups) does not
    divide over the token axis and takes the local branch, as in the
    reference."""
    jcfg, cfg, p_j, p_t = _moe_case(reduced_params_cache, "qwen2-moe-a2.7b")
    B, S = (1, 2048) if case == "prefill_chunk" else (4, 1)
    x = np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    ctx = make_context(make_mesh((4,), ("data",), device="cpu"),
                       "serve_paged").with_(moe_ep=True)
    routes = []
    route = t_moe._route

    def rec(xt, *a):
        r = route(xt, *a)
        routes.append(r["top_idx"])
        return r

    monkeypatch.setattr(t_moe, "_route", rec)
    t_moe.ep_calls = 0
    y, aux = t_moe.moe_layer(_t(x), p_t, cfg, ctx)
    assert t_moe.ep_calls == 1
    assert len(routes) == (4 if case == "prefill_chunk" else 1)
    y_j, aux_j = j_moe.moe_layer(jnp.asarray(x), p_j, jcfg,
                                 J_CPU_CTX.__class__(moe_gather_dispatch=True))
    _close(y, y_j)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-4)
    g = min(j_moe.GROUP_SIZE, B * S)
    xt, _, _ = j_moe._group_tokens(jnp.asarray(x), g)
    C = j_moe._capacity(g, cfg.moe.top_k, cfg.moe.n_experts,
                        cfg.moe.capacity_factor)
    r_j = j_moe._route(xt, p_j["router"], jcfg.moe, cfg.moe.n_experts, C)
    assert np.array_equal(torch.cat(routes).numpy(),
                          np.asarray(r_j["top_idx"]))
    if case == "prefill_chunk":
        t_moe.ep_calls = 0
        t_moe.moe_layer(_t(x[:, :1024]), p_t, cfg, ctx)
        assert t_moe.ep_calls == 0
        # no EP without a mesh, or with experts that do not divide
        t_moe.moe_layer(_t(x), p_t, cfg, CPU_CTX.with_(moe_ep=True))
        three = make_context(make_mesh((3,), ("data",), device="cpu"),
                             "serve_paged").with_(moe_ep=True)
        t_moe.moe_layer(_t(x[:, :1536]), p_t, cfg, three)
        assert t_moe.ep_calls == 0


# ------------------------------------------------------- sharded forwards
def _bridged(reduced_params_cache, arch):
    jcfg, jp = reduced_params_cache(arch)
    cfg = get_config(arch).reduced()
    return jcfg, jp, cfg, params_from_numpy(jp, cfg, device="cpu")


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b"])
def test_sharded_forward_matches_reference(arch, reduced_params_cache,
                                           monkeypatch):
    """dist_progs/sharded_model_prog.py on a (4, 2) ("data" x "model")
    CPU mesh: prefill with SP over "data" and TP over "model" (yi-9b in
    zigzag order with the causal skip, the SSM models contiguous through
    sp_ssd: 128 tokens, 32 a position, whole reduced scan chunks), then a
    decode tick on caches padded by 64 and split over "model" (the
    attention layers' split-KV decode, K4 per shard), each held to the
    reference's single-device forward at atol 2e-4 / rtol 2e-3."""
    jcfg, jp, cfg, params = _bridged(reduced_params_cache, arch)
    has_mamba = any(s.mixer == "mamba" for s in cfg.pattern)
    has_attn = any(s.mixer == "attn" for s in cfg.pattern)
    B, S = 4, 128 if has_mamba else 64
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    ref_logits, _, caches = j_forward(jp, jcfg, J_CPU_CTX,
                                      jnp.asarray(tokens), jnp.asarray(pos),
                                      "prefill")
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    ctx = ExecContext(mesh=mesh, sp_axis="data", tp_axis="model",
                      zigzag_skip=not has_mamba)
    if has_mamba:
        tok_in, pos_in = tokens, pos
    else:
        perm = j_zz.zigzag_permutation(S, 4)
        tok_in, pos_in = tokens[:, perm], pos[:, perm]
    sp_calls = _counting(monkeypatch, t_ssm, "sp_ssd")
    att_calls = _counting(monkeypatch, t_ops, "attention")
    got, _, _ = t_forward(params, cfg, ctx, _t(tok_in), _t(pos_in),
                          "prefill")
    _close(got, ref_logits, **FWD)
    n_mamba = cfg.n_blocks * sum(s.mixer == "mamba" for s in cfg.pattern)
    assert len(sp_calls) == n_mamba
    if not has_mamba:
        # 2 TP lines x (4 + 2 * 3 * 4) zigzag calls a layer
        assert len(att_calls) == cfg.n_layers * 2 * 28

    def pad(d):
        out = {}
        for k_, v_ in d.items():
            if isinstance(v_, dict):
                out[k_] = pad(v_)
            elif k_ in ("k", "v") and v_.shape[2] == S:
                z = jnp.zeros(v_.shape[:2] + (64,) + v_.shape[3:], v_.dtype)
                out[k_] = jnp.concatenate([v_, z], axis=2)
            else:
                out[k_] = v_
        return out

    caches_p = pad(caches)
    ntok = np.asarray(jnp.argmax(ref_logits[:, 0, :cfg.vocab_size], -1)
                      )[:, None].astype(np.int32)
    clen = np.full((B,), S, np.int32)
    ref_d, _, ref_c = j_forward(jp, jcfg, J_CPU_CTX, jnp.asarray(ntok),
                                jnp.asarray(clen[:, None]), "decode",
                                caches=caches_p, cache_len=jnp.asarray(clen))
    ctx_d = make_context(mesh, "decode")
    assert (ctx_d.dp_axis, ctx_d.kv_split_axis) == ("data", "model")
    t_caches = shard_dense_caches(cfg, jax.tree.map(_t, caches_p), ctx_d)
    dec_calls = _counting(monkeypatch, t_ops, "decode_attention")
    got_d, _, t_c = t_forward(params, cfg, ctx_d, _t(ntok), _t(clen[:, None]),
                              "decode", caches=t_caches, cache_len=_t(clen))
    _close(got_d, ref_d, **FWD)
    n_attn = cfg.n_blocks * sum(s.mixer == "attn" for s in cfg.pattern)
    assert len(dec_calls) == 2 * n_attn
    for i, spec in enumerate(cfg.pattern):
        c = t_c[str(i)]["self"]
        if spec.mixer == "attn":
            assert isinstance(c["k"], list) and len(c["k"]) == 2
            # the token's projections differ by rounding between the
            # packages; the other slots are the caches handed in
            _close(torch.cat(c["k"], dim=2), ref_c[str(i)]["self"]["k"],
                   **FWD)
            assert torch.equal(torch.cat(c["k"], dim=2)[:, :, :S],
                               t_caches[str(i)]["self"]["k"][0].new_tensor(
                                   np.asarray(caches_p[str(i)]["self"]["k"])
                               )[:, :, :S])
        else:
            _close(c["ssm"], ref_c[str(i)]["self"]["ssm"], **FWD)
    assert has_attn or not dec_calls


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "mixtral-8x22b"])
def test_expert_parallel_train_forward_matches_reference(
        arch, reduced_params_cache):
    """EP in a train forward on a (4, 2) ("data" x "model") mesh
    (dp_axis "data", tp_axis "model", moe_ep): 4 x 512 tokens, 4 groups
    of 512 over the 4-wide data axis, each position owning one of the 4
    experts; logits within atol 2e-4 / rtol 2e-3 of the reference's
    single-device forward (einsum dispatch) and aux within rtol 1e-4.
    Every MoE layer takes EP."""
    jcfg, jp, cfg, params = _bridged(reduced_params_cache, arch)
    B, S = 4, 512
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    ref, aux_ref, _ = j_forward(jp, jcfg, J_CPU_CTX, jnp.asarray(tokens),
                                jnp.asarray(pos), "train")
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    ctx = ExecContext(mesh=mesh, dp_axis="data", tp_axis="model",
                      moe_ep=True)
    t_moe.ep_calls = 0
    got, aux, _ = t_forward(params, cfg, ctx, _t(tokens), _t(pos), "train")
    n_moe = cfg.n_blocks * sum(s.ffn == "moe" for s in cfg.pattern)
    assert t_moe.ep_calls == n_moe
    _close(got, ref, **FWD)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-4)


# ------------------------------------------------------------------ engines
def _engine(Eng, Req, sim, cp, table1, cfg, params, prompts, out_len,
            **kw):
    spec = sim.ClusterSpec(n_prefill=8, n_decode=1, sp_candidates=(1, 2, 4))
    eng = Eng(cfg, params, spec,
              _two_chunk(sim, cp, parallel=True)(table1(), spec),
              max_batch=4, max_seq=512, block_size=16, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Req(rid=i, arrival=0.001 * i, prompt_len=len(p),
                       output_len=out_len), p)
    return eng.serve()


@pytest.mark.parametrize("arch,lens,ep", [
    ("mamba2-1.3b", (64, 256), False),
    ("qwen2-moe-a2.7b", (64, 128), True)])
def test_mesh_engine_matches_reference_engine(arch, lens, ep,
                                              reduced_params_cache,
                                              monkeypatch):
    """The port's engine on a 4-position serve_paged CPU mesh gives the
    reference's single-device engine's tokens.  Mamba-2: prompts of 64
    and 256 tokens in two chunks each; the 32-token chunks fall back to
    one scan (8 tokens a position), the 128-token chunks run sp_ssd (32,
    the reduced scan chunk).  Qwen1.5-MoE with moe_ep: every tick's MoE
    layers take EP (a tick has no token axes)."""
    jcfg, jp, cfg, params = _bridged(reduced_params_cache, arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lens]
    ctx = make_context(make_mesh((4,), ("data",), device="cpu"),
                       "serve_paged").with_(moe_ep=ep)
    sp_calls = _counting(monkeypatch, t_ssm, "sp_ssd")
    t_moe.ep_calls = 0
    got = _engine(TEngine, TRequest, t_sim, t_cp, t_table1, cfg, params,
                  prompts, 4, ctx=ctx)
    want = _engine(JEngine, JRequest, j_sim, j_cp, j_table1, jcfg, jp,
                   prompts, 4)
    assert got == want
    if ep:
        n_moe = cfg.n_blocks * sum(s.ffn == "moe" for s in cfg.pattern)
        assert t_moe.ep_calls > 0 and t_moe.ep_calls % n_moe == 0
    else:
        assert len(sp_calls) == 2 * cfg.n_layers


@pytest.mark.parametrize("branch", ["window_slice", "ring_cache"])
def test_split_dense_decode_window_branches_match_reference(
        branch, reduced_params_cache, monkeypatch):
    """The sliding-window branches of dense decode on a cache split 4 ways
    (reduced Mixtral, window 8): window_slice writes the token with
    sharded_cache_update and attends over the window's keys gathered from
    the shards (one K4 call); ring_cache writes the ring slot and runs the
    split-KV decode over the shards' live slots (one K4 a shard).  Logits
    and caches held to the reference's single-device decode with the same
    branch at atol 2e-4 / rtol 2e-3."""
    jcfg, jp, cfg, params = _bridged(reduced_params_cache, "mixtral-8x22b")
    W = cfg.sliding_window
    S_max, clen = (64, 40) if branch == "window_slice" else (W, 13)
    B = 2
    rng = np.random.default_rng(8)
    caches = {}
    for i, spec in enumerate(cfg.pattern):
        shape = (cfg.n_blocks, B, S_max, cfg.n_kv_heads, cfg.head_dim_)
        caches[str(i)] = {"self": {
            "k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}}
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    lens = np.asarray([clen, clen - 3], np.int32)
    j_ctx = J_CPU_CTX.__class__(**{branch: True})
    ref, _, ref_c = j_forward(jp, jcfg, j_ctx, jnp.asarray(tok),
                              jnp.asarray(lens[:, None]), "decode",
                              caches=jax.tree.map(jnp.asarray, caches),
                              cache_len=jnp.asarray(lens))
    ctx = make_context(make_mesh((1, 4), ("data", "model"), device="cpu"),
                       "decode").with_(**{branch: True})
    t_caches = shard_dense_caches(cfg, jax.tree.map(_t, caches), ctx)
    calls = _counting(monkeypatch, t_ops, "decode_attention")
    got, _, t_c = t_forward(params, cfg, ctx, _t(tok), _t(lens[:, None]),
                            "decode", caches=t_caches, cache_len=_t(lens))
    _close(got, ref, **FWD)
    assert len(calls) == cfg.n_layers * (1 if branch == "window_slice"
                                         else 4)
    for i in range(len(cfg.pattern)):
        for name in ("k", "v"):
            _close(torch.cat(t_c[str(i)]["self"][name], dim=2),
                   ref_c[str(i)]["self"][name], **FWD)
