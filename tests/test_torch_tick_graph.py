"""CPU tests of what the captured decode tick rests on
(serving/tick_graph.py, serving/engine.PagedDecodeState): the table-width
buckets, which engine layouts may be captured, and Mamba-2's batched
decode state (insert, evict to zero, the swap round trip, and a tick's
new state) against per-row state.  The capture itself runs only on the
card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import Mesh, make_context as mesh_context
from repro_torch.models.params import init_params
from repro_torch.models.sharding import CPU_CTX, ExecContext
from repro_torch.models.transformer import forward
from repro_torch.serving.engine import PagedDecodeState
from repro_torch.serving.tick_graph import (MIN_WIDTH, graph_eligible,
                                            table_width)

CUDA = torch.device("cuda", 0)     # a device name; no card is touched


@pytest.mark.parametrize("pages, width", [
    (1, 16), (16, 16), (17, 24), (24, 24), (25, 32), (32, 32), (33, 48),
    (48, 48), (49, 64), (65, 96), (100, 128), (129, 192), (193, 256),
    (258, 384)])
def test_table_width_buckets(pages, width):
    assert table_width(pages) == width


def test_table_width_pads_under_a_third():
    widths = {table_width(n) for n in range(1, 4097)}
    for n in range(1, 4097):
        w = table_width(n)
        assert w >= max(n, MIN_WIDTH) and table_width(w) == w
        assert n <= MIN_WIDTH or 3 * (w - n) < w
    # two widths a doubling above the floor
    assert len([w for w in widths if 256 < w <= 512]) == 2


def _layout(name: str):
    """(cfg, ctx, kv_shards) of an engine layout."""
    dense = get_config("llama3-8b").reduced()
    if name == "single_device":
        return dense, ExecContext(device=CUDA), 1
    if name == "mamba2":
        return get_config("mamba2-1.3b").reduced(), ExecContext(device=CUDA), 1
    if name == "moe":
        return (get_config("qwen2-moe-a2.7b").reduced(),
                ExecContext(device=CUDA), 1)
    if name == "cpu":
        return dense, CPU_CTX, 1
    if name == "plain_impl":
        return dense, ExecContext(device=CUDA, impl="ref"), 1
    mesh = Mesh(("data",), (4,), [CUDA] * 4)
    if name == "mesh":
        return dense, mesh_context(mesh, "serve_paged"), 4
    if name == "sharded_pool":
        return dense, ExecContext(device=CUDA), 4
    if name == "split_axis":
        return dense, ExecContext(device=CUDA, mesh=mesh,
                                  kv_split_axis="data"), 1
    if name == "cross_attention":
        return get_config("whisper-medium").reduced(), \
            ExecContext(device=CUDA), 1
    raise KeyError(name)


@pytest.mark.parametrize("name, eligible", [
    ("single_device", True), ("mamba2", True), ("moe", True),
    ("cpu", False), ("plain_impl", False), ("mesh", False),
    ("sharded_pool", False), ("split_axis", False),
    ("cross_attention", False)])
def test_graph_eligible_by_layout(name, eligible):
    assert graph_eligible(*_layout(name)) is eligible


# ------------------------------------------------- batched Mamba-2 state
@pytest.fixture(scope="module")
def mamba():
    torch.manual_seed(0)
    cfg = get_config("mamba2-1.3b").reduced()
    return cfg, init_params(cfg, seed=0, device="cpu", dtype="float32")


def _row(cfg, gen) -> dict:
    """One request's state as a prefill hands it on: {layer: {"self":
    {"conv": (nb, 1, K-1, ch), "ssm": (nb, 1, H, P, N)}}}."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H, ch = d_in // s.head_dim, d_in + 2 * s.ngroups * s.d_state
    nb = cfg.n_blocks
    return {str(i): {"self": {
        "conv": torch.randn((nb, 1, s.d_conv - 1, ch), generator=gen),
        "ssm": torch.randn((nb, 1, H, s.head_dim, s.d_state),
                           generator=gen)}}
        for i, spec in enumerate(cfg.pattern) if spec.mixer != "attn"}


def _insert(d, row, rid, state, length=8):
    d.insert(row, rid, state, length, 1, [], 0, np.arange(length))


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k]["self"][p], b[k]["self"][p])
               for k in b for p in b[k]["self"])


def test_state_buffer_insert_evict_and_swap_round_trip(mamba):
    """Rows land in the current buffer at their row, the rest stay zero;
    a swap-out's copy re-inserted at another row reads back the same; an
    evicted row reads zero."""
    cfg, _ = mamba
    gen = torch.Generator().manual_seed(1)
    d = PagedDecodeState(cfg, max_batch=4, max_seq=64, block_size=8,
                         ctx=CPU_CTX)
    rows = {10: _row(cfg, gen), 11: _row(cfg, gen)}
    _insert(d, 1, 10, rows[10])
    _insert(d, 3, 11, rows[11])
    for rid, want in rows.items():
        assert _same(d.row_state(rid), want)
    for ent in d.state[d.cur].values():
        for t in ent.values():
            assert not t[:, [0, 2]].any()
    for ent in d.state[1 - d.cur].values():
        for t in ent.values():
            assert not t.any()
    held = d.row_state(10)              # the swap record's copy
    d.evict(10)
    for ent in d.state[d.cur].values():
        for t in ent.values():
            assert not t[:, 1].any()
    _insert(d, 0, 10, held)
    assert _same(d.row_state(10), rows[10])
    assert _same(d.row_state(11), rows[11])


def test_state_buffer_tick_matches_per_row_state(mamba):
    """One decode tick over the batched buffer: each live row's new state
    and logits are those of the same row's tick alone (B = 1, its own
    state), ``absorb`` makes the written buffer current, and the idle
    rows of the new state read zero."""
    cfg, params = mamba
    gen = torch.Generator().manual_seed(2)
    d = PagedDecodeState(cfg, max_batch=4, max_seq=64, block_size=8,
                         ctx=CPU_CTX)
    live = {0: (20, 7, 11), 2: (21, 30, 5)}      # row: (rid, token, len)
    state = {rid: _row(cfg, gen) for rid, _, _ in live.values()}
    for row, (rid, _, n) in live.items():
        _insert(d, row, rid, state[rid], n)
    toks = torch.zeros((4, 1), dtype=torch.int32)
    clen = torch.zeros((4,), dtype=torch.int32)
    for row, (_, tok, n) in live.items():
        toks[row, 0], clen[row] = tok, n
    before, spare = d.cur, d.state[1 - d.cur]
    logits, _, new = forward(params, cfg, CPU_CTX, toks, clen[:, None],
                             "decode", caches=d.build_caches(None),
                             cache_len=clen)
    d.absorb(new, [rid for rid, _, _ in live.values()])
    assert d.cur == 1 - before and d.state[d.cur] is spare
    for row, (rid, tok, n) in live.items():
        one = {k: {"self": dict(v["self"])} for k, v in state[rid].items()}
        lg, _, want = forward(params, cfg, CPU_CTX,
                              torch.tensor([[tok]], dtype=torch.int32),
                              torch.tensor([[n]], dtype=torch.int32),
                              "decode", caches=one,
                              cache_len=torch.tensor([n], dtype=torch.int32))
        got = d.row_state(rid)
        for k in want:
            for p in want[k]["self"]:
                torch.testing.assert_close(got[k]["self"][p],
                                           want[k]["self"][p])
        torch.testing.assert_close(logits[row], lg[0])
    for ent in d.state[d.cur].values():
        for t in ent.values():
            assert not t[:, [1, 3]].any()
