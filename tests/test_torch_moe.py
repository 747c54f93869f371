"""The port's MoE layer against the reference's on the CPU.

Both packages get the same numpy inputs and weights at Qwen1.5-MoE's
published routing (60 experts, top-4, capacity factor 1.25, one shared
expert block) and narrow widths (d_model 64, d_expert 32, shared 32).  The
routing tensors (``top_idx``, ``keep``, ``within``) must be equal exactly,
ties among the gates included; the layer's output agrees to fp32
``atol = rtol = 1e-5`` and the load-balance loss to 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as j_moe
from repro.configs.registry import get_config as j_get_config
from repro.models.sharding import CPU_CTX as J_CTX
from repro_torch.configs.registry import get_config
from repro_torch.models import moe
from repro_torch.models.sharding import CPU_CTX

D, D_EXPERT, D_SHARED = 64, 32, 32
TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = 1e-6
DISPATCH = ["einsum", "gather"]
# the reference's functions compiled whole: one compile per shape instead
# of one per operation
J_LAYER = jax.jit(j_moe.moe_layer, static_argnums=(2, 3))
J_ROUTE = jax.jit(j_moe._route, static_argnums=(2, 3, 4))


def _cfgs(cf=1.25, mlp_type="swiglu", dtype="float32"):
    """(reference cfg, port cfg): reduced Qwen1.5-MoE with the published
    routing at narrow widths."""
    out = []
    for base in (j_get_config, get_config):
        c = base("qwen2-moe-a2.7b").reduced()
        m = dataclasses.replace(c.moe, n_experts=60, top_k=4,
                                d_expert=D_EXPERT, n_shared=1,
                                d_shared=D_SHARED, capacity_factor=cf)
        out.append(dataclasses.replace(c, d_model=D, moe=m,
                                       mlp_type=mlp_type, dtype=dtype))
    return out


def _weights(cfg, seed, integer=False):
    """numpy MoE leaves with the reference's names and shapes; with
    ``integer`` the router holds small integers, so that on integer inputs
    every router logit is exact and equal gates tie exactly."""
    rng = np.random.default_rng(seed)
    m = cfg.moe
    mats = ("wi", "wg", "wo") if cfg.mlp_type == "swiglu" else ("wi", "wo")

    def ffn(lead, f):
        return {k: (rng.standard_normal(lead + ((f, D) if k == "wo"
                                                else (D, f)))
                    / np.sqrt(f if k == "wo" else D)).astype(np.float32)
                for k in mats}

    router = (rng.integers(-2, 3, (D, m.n_experts)) if integer
              else rng.standard_normal((D, m.n_experts)) / np.sqrt(D))
    return {"router": router.astype(np.float32),
            "experts": ffn((m.n_experts,), m.d_expert),
            "shared": ffn((), m.n_shared * m.d_shared)}


def _jax_tree(w):
    return {k: (_jax_tree(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in w.items()}


def _port_params(w, dtype):
    return {k: (_port_params(v, dtype) if isinstance(v, dict)
                else torch.from_numpy(v).to(dtype)) for k, v in w.items()}


def _routes(jcfg, tcfg, x, w):
    """Both packages' routing of x (B, S, d) numpy fp32, grouped as
    ``moe_layer`` groups it."""
    B, S, _ = x.shape
    m = jcfg.moe
    g = min(moe.GROUP_SIZE, B * S)
    C = moe._capacity(g, m.top_k, m.n_experts, m.capacity_factor)
    assert C == j_moe._capacity(g, m.top_k, m.n_experts, m.capacity_factor)
    jxt, _, _ = j_moe._group_tokens(jnp.asarray(x), g)
    jr = J_ROUTE(jxt, jnp.asarray(w["router"]), m, m.n_experts, C)
    txt, _, _ = moe._group_tokens(torch.from_numpy(x), g)
    tr = moe._route(txt, torch.from_numpy(w["router"]), tcfg.moe,
                    m.n_experts, C)
    return jr, tr, C


def _check(x, dispatch, cf=1.25, mlp_type="swiglu", w=None):
    """Routing equal exactly, y and aux within TOL and AUX_TOL, for x
    (B, S, d) numpy fp32 and the weights ``w`` (default: seed 0)."""
    jcfg, tcfg = _cfgs(cf, mlp_type)
    w = _weights(jcfg, 0) if w is None else w
    jr, tr, C = _routes(jcfg, tcfg, x, w)
    for key in ("top_idx", "keep", "within"):
        np.testing.assert_array_equal(tr[key].numpy(), np.asarray(jr[key]))
    gather = dispatch == "gather"
    want, jaux = J_LAYER(jnp.asarray(x), _jax_tree(w), jcfg,
                         J_CTX.with_(moe_gather_dispatch=gather))
    got, aux = moe.moe_layer(torch.from_numpy(x),
                             _port_params(w, torch.float32), tcfg,
                             CPU_CTX.with_(moe_gather_dispatch=gather))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    return tr, C


def _x(B, S, seed=1, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-2, 3, (B, S, D)).astype(np.float32)
    return rng.standard_normal((B, S, D)).astype(np.float32)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_prefill_groups_with_padding_match_reference(dispatch):
    """1400 tokens: two full groups of 512 and one padded by 136 zero
    rows, which are routed and take capacity (C = 44)."""
    tr, C = _check(_x(2, 700), dispatch)
    assert C == 44 and tuple(tr["top_idx"].shape) == (3, 512, 4)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_decode_tick_capacity_one_matches_reference(dispatch):
    """A decode tick of four rows is one group of 4 (g < 16): C = 1, so
    each expert takes one (token, choice) and the rest are dropped.  Rows
    2 and 3 are the same token, as the engine's idle rows are: all of
    row 3's choices find their experts full."""
    x = _x(4, 1)
    x[3] = x[2]
    tr, C = _check(x, dispatch)
    assert C == 1 and not bool(tr["keep"][0, 3].any())


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_tight_capacity_drops_match_reference(dispatch):
    """Capacity factor 0.25: C = 8 per expert for 300 tokens' 1200
    choices, so many are dropped."""
    tr, C = _check(_x(1, 300), dispatch, cf=0.25)
    assert C == 8 and not bool(tr["keep"].all())


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_tied_gates_route_as_reference(dispatch):
    """Integer router weights and inputs make every logit exact, and each
    column appears three times (60 experts = 20 triples), so gates tie in
    threes and the top 4 splits a triple: the lower index must win, and
    the capacity order must follow."""
    w = _weights(_cfgs()[0], 0, integer=True)
    w["router"] = np.repeat(w["router"][:, :20], 3, axis=1)
    tr, _ = _check(_x(2, 150, integer=True), dispatch, w=w)
    gates = tr["gates"]
    assert bool(((gates[..., :, None] == gates[..., None, :]).sum(-1)
                 > 1).all())
    # within a triple the lower indices come first
    assert bool((tr["top_idx"][..., 0] % 3 == 0).all())
    assert not bool(tr["keep"].all())


def test_top_k_stable_orders_ties_by_index():
    x = torch.tensor([[0.5, 1.0, 0.5, 1.0, 0.25, 0.5]])
    vals, idx = moe.top_k_stable(x, 4)
    assert idx.tolist() == [[1, 3, 0, 2]]
    assert vals.tolist() == [[1.0, 1.0, 0.5, 0.5]]


@pytest.mark.parametrize("mlp_type", ["relu2", "gelu"])
def test_other_expert_activations_match_reference(mlp_type):
    """relu² (Nemotron's) and gelu with the tanh approximation, which is
    ``jax.nn.gelu``'s default, in the routed and the shared experts."""
    _check(_x(1, 40), "einsum", mlp_type=mlp_type)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_bf16_layer_within_one_ulp_of_reference(dispatch):
    """bf16 activations and weights on both sides, with the reference's
    casts: the routing is still equal, and y is within one bf16 ulp at
    the scale of its largest element (2^(floor(log2 max|y|) - 7)).  Not
    closer: the frameworks round differently inside an op (JAX's silu is
    five bf16 operations, torch's one fp32 evaluation rounded once; one
    ulp apart on ~40% of the gate's elements), and those one-ulp steps
    reach y's small elements as a few of their own ulps."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    x = _x(2, 300)
    w = _weights(jcfg, 0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    m = jcfg.moe
    C = moe._capacity(512, m.top_k, m.n_experts, m.capacity_factor)
    jr = J_ROUTE(j_moe._group_tokens(jx, 512)[0], jnp.asarray(w["router"]),
                 m, m.n_experts, C)
    tr = moe._route(moe._group_tokens(xb, 512)[0],
                    torch.from_numpy(w["router"]), tcfg.moe, m.n_experts, C)
    for key in ("top_idx", "keep", "within"):
        np.testing.assert_array_equal(tr[key].numpy(), np.asarray(jr[key]))
    gather = dispatch == "gather"
    want, _ = J_LAYER(jx, _jax_tree(w), jcfg,
                      J_CTX.with_(moe_gather_dispatch=gather))
    got, _ = moe.moe_layer(xb, _port_params(w, torch.bfloat16), tcfg,
                           CPU_CTX.with_(moe_gather_dispatch=gather))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ulp, rtol=0)
