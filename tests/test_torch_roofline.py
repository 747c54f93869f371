"""The port's static step analysis against the reference: model flops,
collective wire bytes, parameter placements, the layer stack's bytes a
device, the step builders' abstract inputs and placements on the
production meshes, the blocked plain attention, and the dry run's counts
of a reduced Llama on a (2, 2) CPU mesh.

The reference side runs on ``jax.sharding.AbstractMesh``, so no devices
are made; ``repro.launch.dryrun`` is never imported (it sets a 512-device
XLA flag when imported)."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from port_fixtures import one_torch_thread  # noqa: F401

from repro.configs import registry as jreg
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import params as jparams
from repro_torch.configs import registry
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.mesh import (make_context, make_mesh,
                                     make_production_mesh)
from repro_torch.models import params
from repro_torch.models.config import INPUT_SHAPES

NAMES = registry.NAMES
MODES = ("train", "prefill", "decode", "serve_paged")


def _abstract_mesh(multi_pod: bool):
    from jax.sharding import AbstractMesh
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _flat(tree, path=()):
    """{path: leaf} of nested dicts and named tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, registry.TensorSpec):
        out = {}
        for f in tree._fields:
            out.update(_flat(getattr(tree, f), path + (f,)))
        return out
    return {path: tree}


def _jspec(x):
    """A reference PartitionSpec (or NamedSharding) as a tuple."""
    return tuple(getattr(x, "spec", x))


# ------------------------------------------------------------- model flops
def test_model_flops_every_config_and_shape():
    for name in NAMES:
        for sn in INPUT_SHAPES:
            want = jroof.model_flops(jreg.get_config(name),
                                     jreg.INPUT_SHAPES[sn])
            got = roofline.model_flops(registry.get_config(name),
                                       INPUT_SHAPES[sn])
            assert got == want, (name, sn)


# the five collectives of tests/test_roofline.py's HLO, as records
HLO = """
  %ag = bf16[16,1024,512]{2,1,0} all-gather(bf16[16,64,512] %x), replica_groups=[16,16]<=[256], dimensions={1}
  %ar.start = f32[4096,4096]{1,0} all-reduce-start(f32[4096,4096] %g), replica_groups=[16,16]<=[256]
  %rs = f32[64,512]{1,0} reduce-scatter(%y), replica_groups={{0,1,2,3}, {4,5,6,7}}
  %cp = bf16[2,2048,128]{2,1,0} collective-permute(%kv), source_target_pairs={{0,1},{1,2}}
  %a2a = (f32[1,64]{1,0}, f32[1,64]{1,0}) all-to-all(%p, %q), replica_groups=[2,8]<=[16]
"""
RECORDS = [
    {"kind": "all-gather", "result_bytes": 16 * 1024 * 512 * 2, "group": 16},
    {"kind": "all-reduce", "result_bytes": 4096 * 4096 * 4, "group": 16},
    {"kind": "reduce-scatter", "result_bytes": 64 * 512 * 4, "group": 4},
    # no replica groups: the reference's default group of 8
    {"kind": "collective-permute", "result_bytes": 2 * 2048 * 128 * 2,
     "group": 8},
    {"kind": "all-to-all", "result_bytes": 2 * 64 * 4, "group": 8},
]


def test_collective_wire_bytes_match_reference():
    assert roofline.collective_bytes(RECORDS) == jroof.collective_bytes(HLO)


def test_port_collectives_are_recorded():
    """The mesh's own collectives land in the record with their result
    bytes and group sizes."""
    from repro_torch.launch import mesh as tmesh
    m = make_mesh((4,), ("data",), device="cpu")
    devs = m.positions("data")
    x = torch.zeros(2, 8, 3)
    with tmesh.recording_collectives() as recs:
        parts = tmesh.split(x, devs)
        parts = tmesh.ring_shift(parts, devs)
        tmesh.unsplit(parts, devs[0])
        tmesh.all_gather(parts, devs[0])
    assert [(r["kind"], r["result_bytes"], r["group"]) for r in recs] == [
        ("scatter", 192, 4), ("collective-permute", 48, 4),
        ("all-gather", 192, 4), ("all-gather", 192, 4)]
    assert devs.ids == (0, 1, 2, 3)
    assert roofline.collective_bytes(recs)["total"] == 48 + 3 * 144


# ---------------------------------------------------------- placements
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_reference(name):
    jcfg, cfg = jreg.get_config(name), registry.get_config(name)
    am = _abstract_mesh(False)
    mesh = make_production_mesh(device="meta")
    for mode in MODES:
        for s2d in (False, True):
            want = _flat(jparams.param_specs(
                jcfg, jmesh.make_context(am, mode).with_(
                    shard2d_weights=s2d)))
            got = _flat(params.param_specs(
                cfg, make_context(mesh, mode).with_(shard2d_weights=s2d)))
            assert got == {k: _jspec(v) for k, v in want.items()}, \
                (name, mode, s2d)


def test_scanned_param_bytes_match_reference():
    am = _abstract_mesh(False)
    mesh = make_production_mesh(device="meta")
    for name in NAMES:
        for b in (2, 4):
            assert steps.scanned_param_bytes_per_dev(
                registry.get_config(name), mesh, dtype_bytes=b) == \
                jsteps.scanned_param_bytes_per_dev(
                    jreg.get_config(name), am, dtype_bytes=b), name


def test_scanned_param_bytes_shard2d_match_reference(monkeypatch):
    """Under the shard2d variant's overrides the layer stack's bytes a
    device are the reference's placement with ``shard2d_weights`` (the
    reference's function builds its own context: it is given the
    variant's here), and fewer than without them."""
    ov = dryrun.VARIANTS["shard2d"]
    monkeypatch.setattr(jsteps, "make_context",
                        lambda m, mode: jmesh.make_context(m, mode).with_(
                            **ov))
    am = _abstract_mesh(False)
    mesh = make_production_mesh(device="meta")
    for name in NAMES:
        cfg = registry.get_config(name)
        got = steps.scanned_param_bytes_per_dev(cfg, mesh, ctx_overrides=ov)
        assert got == jsteps.scanned_param_bytes_per_dev(
            jreg.get_config(name), am), name
        assert got <= steps.scanned_param_bytes_per_dev(cfg, mesh), name
    llama = registry.get_config("llama3-8b")
    assert steps.scanned_param_bytes_per_dev(llama, mesh, ctx_overrides=ov) \
        < steps.scanned_param_bytes_per_dev(llama, mesh)


def test_abstract_params_match_reference():
    for name in NAMES:
        for dt in ("bfloat16", "float32"):
            want = _flat(jparams.abstract_params(jreg.get_config(name), dt))
            got = _flat(params.abstract_params(registry.get_config(name),
                                               dt))
            assert {k: (tuple(v.shape), str(v.dtype)) for k, v in
                    want.items()} == {
                k: (v.shape, str(v.dtype).split(".")[-1])
                for k, v in got.items()}, (name, dt)


@pytest.mark.parametrize("name", NAMES)
def test_build_step_args_and_placements_match_reference(name):
    """Every supported shape and variant on both production meshes: the
    abstract inputs' shapes and dtypes, and every leaf's placement."""
    jcfg, cfg = jreg.get_config(name), registry.get_config(name)
    for multi_pod in (False, True):
        am = _abstract_mesh(multi_pod)
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        for sn, shape in INPUT_SHAPES.items():
            if not registry.supports_shape(cfg, shape):
                continue
            for var, ov in dryrun.VARIANTS.items():
                _, jsh, jargs = jsteps.build_step(
                    jcfg, jreg.INPUT_SHAPES[sn], am, ctx_overrides=ov)
                _, place, args = steps.build_step(cfg, shape, mesh,
                                                  ctx_overrides=ov)
                want = {k: (tuple(v.shape), str(v.dtype))
                        for k, v in _flat(dict(enumerate(jargs))).items()}
                got = {k: (v.shape, str(v.dtype).split(".")[-1])
                       for k, v in _flat(dict(enumerate(args))).items()}
                tag = (name, sn, var, multi_pod)
                assert got == want, tag
                wp = {k: _jspec(v)
                      for k, v in _flat(dict(enumerate(jsh))).items()}
                gp = _flat(dict(enumerate(place)))
                assert gp == wp, tag


# --------------------------------------------------- blocked attention
@pytest.mark.parametrize("case", ["causal", "window", "ragged_gqa"])
def test_attention_ref_blocked_matches_reference(case):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops, ref as tref
    rng = np.random.default_rng(3)
    B, Sq, Sk, H, KVH, D = 2, 300, 300, 4, 4, 16
    window, block = None, 64
    if case == "window":
        window = 37
    if case == "ragged_gqa":
        Sq, Sk, KVH, block = 77, 190, 2, 32
    q = rng.standard_normal((B, Sq, H, D), np.float32)
    k = rng.standard_normal((B, Sk, KVH, D), np.float32)
    v = rng.standard_normal((B, Sk, KVH, D), np.float32)
    q_pos = np.arange(Sk - Sq, Sk, dtype=np.int32)
    kv_pos = np.arange(Sk, dtype=np.int32)
    want_o, want_l = jref.attention_ref_blocked(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)), causal=True,
        window=window, with_lse=True, block_q=block)
    got_o, got_l = tref.attention_ref_blocked(
        *(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)),
        causal=True, window=window, with_lse=True, block_q=block)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               atol=1e-5, rtol=1e-5)
    # the ops route: impl="ref_blocked" on any device is this function
    o = ops.attention(*(torch.from_numpy(a) for a in
                        (q, k, v, q_pos, kv_pos)), window=window,
                      impl="ref_blocked")
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=1e-5,
                               rtol=1e-5)


# --------------------------------------------------------------- dry run
def _closed_form(cfg, shape) -> float:
    """Matmul flops of the plain path of a dense model's prefill or
    decode step: the projections, the FFN, the unembedding of the last
    (prefill) or only (decode) position, and the whole score matrix's
    two products (the plain attention computes every pair, causal or
    not)."""
    B, S = shape.global_batch, shape.seq_len
    d, dh = cfg.d_model, cfg.head_dim_
    H, KVH = cfg.padded_heads, cfg.n_kv_heads
    proj = d * H * dh + 2 * d * KVH * dh + H * dh * d
    ffn = (3 if cfg.mlp_type == "swiglu" else 2) * d * cfg.d_ff
    q_len = S if shape.kind == "prefill" else 1
    attn = 4 * B * H * dh * q_len * S
    return cfg.n_layers * (2 * B * q_len * (proj + ffn) + attn) \
        + 2 * B * d * cfg.padded_vocab


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k"])
def test_dryrun_counts_closed_form_and_extrapolates(kind):
    cfg = dataclasses.replace(registry.get_config("llama3-8b").reduced(),
                              n_layers=4)
    shape = dataclasses.replace(INPUT_SHAPES[kind], seq_len=64,
                                global_batch=2)
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    totals = {}
    for nb in (1, 2, 4):
        c = dryrun.count_step(dryrun._depth(cfg, nb), shape, mesh)
        totals[nb] = sum(c["flops"].values())
        assert totals[nb] == _closed_form(dryrun._depth(cfg, nb), shape)
        # the ring / split-KV islands put work on every position
        assert len(c["flops"]) == (4 if kind == "prefill_32k" else 2)
    ext = dryrun.extrapolated_cost(cfg, shape, mesh)
    assert sum(ext["flops"].values()) == totals[1] + 3 * (totals[2]
                                                          - totals[1])
    assert sum(ext["flops"].values()) == totals[4]
    rec = dryrun.step_record(cfg, shape, mesh)
    assert rec["position"] == 0 and 0 < rec["flops_share"] < 1
    # position 0 holds every weight, the inputs and (decode) its cache
    # shard
    n_param = sum(math.prod(s.shape) * 2 for s in _flat(
        params.abstract_params(cfg)).values())
    assert rec["argument_bytes"] >= n_param
    if kind == "prefill_32k":
        assert rec["collectives"]["collective-permute"] > 0


def test_dryrun_cli_writes_a_record(tmp_path, monkeypatch):
    """The CLI at a reduced config on a (2, 2) mesh: the record carries
    the reference's fields on the H100's peaks."""
    cfg = registry.get_config("llama3-8b").reduced()
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    monkeypatch.setattr(
        dryrun, "make_production_mesh",
        lambda multi_pod=False, device=None: make_mesh(
            (2, 2), ("data", "model"), device=device))
    monkeypatch.setitem(dryrun.INPUT_SHAPES, "decode_32k", dataclasses.replace(
        INPUT_SHAPES["decode_32k"], seq_len=64, global_batch=2))
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    rec = json.loads((tmp_path / "llama3-8b_decode_32k_pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert rec["data_values"] == {"cache_len": 63, "positions": 63}
    r = rec["roofline"]
    for k in ("hlo_flops_per_dev", "hlo_bytes_per_dev", "coll_bytes_per_dev",
              "peak_mem_per_dev", "compute_s", "memory_s", "memory_adj_s",
              "collective_s", "model_flops_total", "useful_ratio",
              "bottleneck", "bottleneck_hlo"):
        assert k in r
    assert r["compute_s"] == r["hlo_flops_per_dev"] / 989e12
    assert r["memory_s"] == r["hlo_bytes_per_dev"] / 3.35e12
    assert rec["argument_bytes"] > 0 and rec["temp_bytes"] > 0
    assert rec["placement"] == dryrun.PLACEMENT
    # shard2d moves only the reference placement's stack bytes: the port
    # runs the step with every weight whole on position 0, as ring_cache
    recs = {}
    for var in ("ring_cache", "shard2d"):
        dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                     "--variant", var, "--out", str(tmp_path)])
        recs[var] = json.loads(
            (tmp_path / f"llama3-8b_decode_32k_pod16x16_{var}.json")
            .read_text())
    a, b = recs["ring_cache"], recs["shard2d"]
    assert b["scanned_param_bytes"] < a["scanned_param_bytes"]
    for k in ("argument_bytes", "temp_bytes", "roofline"):
        assert b[k] == a[k], k


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_counts_every_step_of_every_config(name):
    """Every supported shape of the reduced config counts on a (2, 2)
    mesh of meta positions, plain and under the "optimized" variant (the
    zigzag ring and the ring-buffer cache), MoE configs also under
    expert parallelism: position 0 is the busiest and every count is
    there."""
    cfg = registry.get_config(name).reduced()
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    variants = ("", "optimized") + (("moe_ep",) if cfg.moe else ())
    for sn, shape in INPUT_SHAPES.items():
        if not registry.supports_shape(cfg, shape):
            continue
        shape = dataclasses.replace(
            shape, seq_len={"decode": 256, "train": 128,
                            "prefill": 128}[shape.kind],
            global_batch=min(shape.global_batch, 4))
        for var in variants:
            rec = dryrun.step_record(cfg, shape, mesh, dryrun.VARIANTS[var])
            assert rec["position"] == 0 and rec["flops"] > 0, (sn, var)
            assert rec["bytes accessed"] > 0 and rec["argument_bytes"] > 0
