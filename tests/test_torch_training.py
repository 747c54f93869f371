"""The port's training path against the reference, on the CPU.

Both packages get the same weights (the reference's seeded init, bridged
through ``params_from_numpy``) and the same numpy inputs.  The reference
runs its plain path (``impl`` is ``"ref"`` on the CPU); its gradients are
``jax.value_and_grad``'s, the port's ``torch.autograd``'s.  Tolerances:

* the loss within 1e-5 relative, and each gradient leaf within 1e-4 of
  the reference leaf's largest magnitude: both sides run the same fp32
  operations in another order (XLA fuses and reassociates sums), and the
  worst leaf seen reads about 1e-6 of its magnitude.  A leaf whose
  gradient is zero in exact arithmetic (the key bias: softmax does not
  see a shift shared by all of a query's logits) is fp32 noise of ~1e-9
  on both sides, so an error up to 1e-8 passes whatever the leaf's
  magnitude;
* AdamW's parameters, moments and gnorm within 1e-6 relative (fp32, the
  same operations), a bf16 parameter within one bf16 ulp (the fp32
  values it is rounded from may sit either side of a rounding edge);
* the 5-step Trainer history within 1e-4 relative (five updates move
  the rounding differences of the gradients through the weights).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.kernels import ref as j_ref
from repro.launch.mesh import make_context as j_mesh_context
from repro.models.config import INPUT_SHAPES as J_INPUT_SHAPES
from repro.models.sharding import CPU_CTX as J_CTX
from repro.training import checkpoint as j_checkpoint
from repro.training.data import make_pipeline as j_make_pipeline
from repro.training.optimizer import AdamW as JAdamW
from repro.training.optimizer import AdamWState as JAdamWState
from repro.training.train_loop import Trainer as JTrainer
from repro.training.train_loop import loss_fn as j_loss_fn
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_plain)
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan_plain
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_context as mesh_context
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.models.sharding import CPU_CTX
from repro_torch.training import checkpoint
from repro_torch.training.data import make_pipeline
from repro_torch.training.optimizer import AdamW, AdamWState, tree_map
from repro_torch.training.train_loop import (Trainer, loss_fn,
                                             make_train_step, trainable)
from port_fixtures import one_torch_thread  # noqa: F401

GRAD_ARCHS = ["llama3-8b", "mamba2-1.3b", "qwen2-moe-a2.7b",
              "whisper-medium"]
B, S = 2, 24


def _bridged(reduced_params_cache, name):
    cfg, jp = reduced_params_cache(name)
    pcfg = registry.get_config(name).reduced()
    return cfg, pcfg, jp, params_from_numpy(jp, pcfg, device="cpu")


def _batch(cfg, seed: int = 0):
    """A numpy batch of the pipeline (M-RoPE: its positions as three equal
    rows; Whisper: also seeded encoder frames)."""
    b = dict(make_pipeline(cfg, S, B, seed=seed).batch(0))
    if cfg.rope_type == "mrope":
        b["positions"] = np.broadcast_to(b["positions"], (3, B, S))
    if cfg.encoder_decoder:
        b["encoder_frames"] = np.random.default_rng(5).standard_normal(
            (B, cfg.cross_kv_len, cfg.d_model)).astype(np.float32)
    return b


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}{k}/"))
        return out
    return {path[:-1]: np.asarray(tree)}


def _port_grads(params, cfg, ctx, batch):
    tp = trainable(params)
    loss, (ce, aux) = loss_fn(tp, cfg, ctx, _torch(batch))
    loss.backward()
    return float(loss.detach()), _flat(tree_map(lambda p: p.grad.numpy(),
                                                tp))


@pytest.fixture(scope="module")
def reference_grads(reduced_params_cache):
    """(loss, flat grads) of the reference per architecture, computed once
    for the cases that share it."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg, jp = reduced_params_cache(name)
            jb = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
            (loss, _), g = jax.value_and_grad(j_loss_fn, has_aux=True)(
                jp, cfg, J_CTX, jb)
            cache[name] = (float(loss), _flat(g))
        return cache[name]
    return get


def _assert_grads_close(got: dict, want: dict, rel: float = 1e-4):
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= rel * scale or err <= 1e-8, (k, err, scale)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_bit_equal(seed, reduced_params_cache):
    cfg, pcfg, _, _ = _bridged(reduced_params_cache, "yi-9b")
    mine, ref = make_pipeline(pcfg, 32, 4, seed), \
        j_make_pipeline(cfg, 32, 4, seed)
    for step in (0, 1, 5, 12):
        a, b = mine.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["labels"][:, :-1],
                                      a["tokens"][:, 1:])
    assert not np.array_equal(mine.batch(3)["tokens"],
                              mine.batch(4)["tokens"])


# --------------------------------------------------------------- AdamW
def _opt_trees(seed: int):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32),
              "blk": {"m": rng.standard_normal((2, 2, 2)).astype(np.float32),
                      "half": rng.standard_normal((3, 5)).astype(np.float32)}}
    grads = [tree_map(lambda p: (3 * rng.standard_normal(p.shape)).astype(
        np.float32), params) for _ in range(5)]
    return params, grads


def _to_jax(tree):
    return tree_map(lambda a: jnp.asarray(
        a, dtype=jnp.bfloat16 if a.shape == (3, 5) else jnp.float32), tree)


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(a.copy()).to(
        torch.bfloat16 if a.shape == (3, 5) else torch.float32), tree)


@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clip_on", "clip_off"])
@pytest.mark.parametrize("warmup", [3, 100], ids=["warm_end", "warm_below"])
def test_adamw_matches_reference(clip, warmup):
    """Five updates of the same gradient trees: the global-norm clip
    active or not (the gradients' norm is about 15), the warmup ending
    inside the five steps or not."""
    params, grads = _opt_trees(0)
    kw = dict(lr=0.05, grad_clip=clip, warmup_steps=warmup)
    jo, to = JAdamW(**kw), AdamW(**kw)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js, jn = jo.update(_to_jax(g), js, jp)
        tp, ts, tn = to.update(_to_torch(g), ts, tp)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        assert (float(jn) > clip) == (clip < 1.0)
    assert int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
    assert tp["blk"]["half"].dtype == torch.bfloat16
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        g, w = _flat(tree_map(lambda t: t.float().numpy(), got)), \
            _flat(tree_map(lambda a: np.asarray(a, np.float32), want))
        for k in w:
            rtol = 2 ** -8 if got is tp and k == "blk/half" else 1e-6
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-7,
                                       err_msg=k)


def test_adamw_decays_only_matrices():
    """Zero gradients: only the decoupled decay moves a parameter, and
    only one of two or more dims."""
    p = {"w": torch.ones(3, 2), "norm": torch.ones(4),
         "bf": torch.ones(2, 2, dtype=torch.bfloat16)}
    opt = AdamW(lr=0.5, weight_decay=0.1, warmup_steps=1)
    new, st, gnorm = opt.update(tree_map(torch.zeros_like, p), opt.init(p),
                                p)
    assert float(gnorm) == 0.0
    assert torch.equal(new["norm"], p["norm"])
    torch.testing.assert_close(new["w"], torch.full((3, 2), 0.95))
    assert new["bf"].dtype == torch.bfloat16
    assert st.mu["bf"].dtype == torch.float32


# ------------------------------------------------- loss and gradients
@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_loss_and_grads_match_reference(name, reduced_params_cache,
                                        reference_grads):
    cfg, pcfg, jp, tp = _bridged(reduced_params_cache, name)
    want_loss, want = reference_grads(name)
    loss, got = _port_grads(tp, pcfg, CPU_CTX, _batch(cfg))
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("name", ["llama3-8b", "mamba2-1.3b"])
def test_remat_recomputes_and_keeps_grads(name, reduced_params_cache,
                                          monkeypatch):
    """Under ``ctx.remat`` each block runs again in the backward (twice
    the layer calls) and the gradients are the same numbers."""
    _, pcfg, _, tp = _bridged(reduced_params_cache, name)
    batch = _batch(pcfg)
    calls = []
    layer = transformer._layer
    monkeypatch.setattr(transformer, "_layer",
                        lambda *a, **kw: calls.append(1) or layer(*a, **kw))
    loss, plain = _port_grads(tp, pcfg, CPU_CTX, batch)
    n = len(calls)
    assert n == pcfg.n_layers
    loss_r, remat = _port_grads(tp, pcfg, CPU_CTX.with_(remat=True), batch)
    assert len(calls) - n == 2 * pcfg.n_layers
    assert loss_r == loss
    for k in plain:
        np.testing.assert_array_equal(remat[k], plain[k], err_msg=k)


def test_every_config_trains_every_leaf(reduced_params_cache):
    """The train step's guard never fires on a right path: one step of
    each reduced config reaches every parameter."""
    for name in registry.NAMES:
        cfg = registry.get_config(name).reduced()
        params = init_params(cfg, seed=1, device="cpu")
        step = make_train_step(cfg, CPU_CTX, AdamW())
        p, st, m = step(trainable(params), AdamW().init(params),
                        _torch(_batch(cfg)))
        assert np.isfinite(float(m["loss"])) and int(st.step) == 1, name


def test_train_step_raises_on_a_leaf_without_grad():
    cfg = registry.get_config("llama3-8b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    params["blocks"]["0"]["unused"] = torch.zeros(3)
    step = make_train_step(cfg, CPU_CTX, AdamW())
    with pytest.raises(RuntimeError, match="blocks/0/unused"):
        step(trainable(params), AdamW().init(params), _torch(_batch(cfg)))


# --------------------------------------- the autograd Functions, CPU
@pytest.mark.parametrize("H,KVH,causal,window", [
    (4, 4, True, None), (8, 2, True, None), (8, 2, True, 5),
    (4, 1, False, None)], ids=["causal", "gqa4", "window", "noncausal"])
def test_flash_attention_fn_grads(H, KVH, causal, window):
    """``FlashAttentionFn`` on CPU tensors: the plain forward, and the
    gradients (through out and lse) of autograd through
    ``flash_attention_plain`` and of ``jax.grad`` through the reference's
    ``attention_ref``."""
    rng = np.random.default_rng(3)
    Sq, Sk, D = 9, 13, 32
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((2, Sk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((2, Sk, KVH, D)).astype(np.float32)
    g = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    g_lse = rng.standard_normal((2, H, Sq)).astype(np.float32)
    qp = np.arange(Sk - Sq, Sk, dtype=np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    kw = dict(causal=causal, window=window)

    def run(fn):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out, lse = fn(*ts)
        torch.autograd.backward((out, lse), (torch.from_numpy(g),
                                             torch.from_numpy(g_lse)))
        return out.detach().numpy(), [t.grad.numpy() for t in ts]

    got_o, got = run(lambda q, k, v: FlashAttentionFn.apply(
        q, k, v, torch.from_numpy(qp), torch.from_numpy(kp), causal, window,
        None))
    want_o, want = run(lambda q, k, v: flash_attention_plain(
        q, k, v, torch.from_numpy(qp), torch.from_numpy(kp), **kw))
    np.testing.assert_array_equal(got_o, want_o)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

    def jloss(q, k, v):
        out, lse = j_ref.attention_ref(q, k, v, jnp.asarray(qp),
                                       jnp.asarray(kp), with_lse=True, **kw)
        return jnp.sum(out * g) + jnp.sum(lse * g_lse)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(got, jgrads):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)


def _ssd_inputs(S: int, seed: int = 4):
    rng = np.random.default_rng(seed)
    Bb, H, P, G, N = 2, 4, 8, 2, 8
    return (rng.standard_normal((Bb, S, H, P)).astype(np.float32),
            np.exp(rng.uniform(-4.0, -1.0, (Bb, S, H))).astype(np.float32),
            -rng.uniform(1.0, 4.0, H).astype(np.float32),
            rng.standard_normal((Bb, S, G, N)).astype(np.float32),
            rng.standard_normal((Bb, S, G, N)).astype(np.float32),
            0.3 * rng.standard_normal((Bb, H, P, N)).astype(np.float32),
            rng.standard_normal((Bb, S, H, P)).astype(np.float32),
            rng.standard_normal((Bb, H, P, N)).astype(np.float32))


@pytest.mark.parametrize("S,with_h0", [(32, True), (32, False), (27, True)],
                         ids=["h0", "no_h0", "ragged"])
def test_ssd_scan_fn_grads(S, with_h0):
    """``SSDScanFn`` on CPU tensors: the gradients for x, dt, A, B, C and
    h0 of autograd through ``ssd_scan_plain`` and (whole chunks) of
    ``jax.grad`` through the reference's ``ssd_chunked_ref``."""
    x, dt, A, Bm, Cm, h0, gy, gh = _ssd_inputs(S)
    chunk = 8
    arrays = [x, dt, A, Bm, Cm] + ([h0] if with_h0 else [])

    def run(fn):
        ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
        y, h = fn(*ts[:5], ts[5] if with_h0 else None)
        torch.autograd.backward((y, h), (torch.from_numpy(gy),
                                         torch.from_numpy(gh)))
        return [t.grad.numpy() for t in ts]

    got = run(lambda *a: SSDScanFn.apply(*a, chunk))
    want = run(lambda x, dt, A, Bm, Cm, h0: ssd_scan_plain(
        x, dt, A, Bm, Cm, h0=h0, chunk=chunk))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if S % chunk:
        return

    def jloss(*a):
        y, h = j_ref.ssd_chunked_ref(*a[:5], chunk=chunk,
                                     h0=a[5] if with_h0 else None,
                                     return_state=True)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    for a, b in zip(got, jgrads):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5 * scale,
                                   rtol=1e-4)


# ------------------------------------------------------------- Trainer
def test_trainer_history_matches_reference(reduced_params_cache):
    cfg, pcfg, jp, tp = _bridged(reduced_params_cache, "yi-9b")
    kw = dict(lr=1e-3, warmup_steps=20)
    want = JTrainer(cfg, jp, opt=JAdamW(**kw)).fit(
        j_make_pipeline(cfg, 64, 8), steps=5, log_every=1)
    got = Trainer(pcfg, tp, opt=AdamW(**kw)).fit(
        make_pipeline(pcfg, 64, 8), steps=5, log_every=1)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for a, b in zip(got, want):
        for k in ("loss", "gnorm"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (a, b)


def test_trainer_loss_decreases(reduced_params_cache):
    """40 steps of the port alone, as the reference's own test asks."""
    _, pcfg, _, tp = _bridged(reduced_params_cache, "yi-9b")
    tr = Trainer(pcfg, tp, opt=AdamW(lr=1e-3, warmup_steps=20))
    hist = tr.fit(make_pipeline(pcfg, 64, 8), steps=40, log_every=10)
    assert [r["step"] for r in hist] == [0, 10, 20, 30, 39]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.1
    assert all(np.isfinite(r["loss"]) for r in hist)


# --------------------------------------------------------- checkpoints
def test_checkpoints_interchange(reduced_params_cache, tmp_path):
    """Parameters plus an AdamW state, saved with a step by either package
    and restored by both.  The reference writes a NamedTuple by index (it
    is a tuple) and its restore cannot rebuild one, so the reference
    restores the state as the plain tuple it wrote."""
    cfg, pcfg, jp, tp = _bridged(reduced_params_cache, "mixtral-8x22b")
    js = JAdamWState(jnp.asarray(7, jnp.int32),
                     jax.tree.map(lambda a: 2 * a, jp),
                     jax.tree.map(lambda a: a * a, jp))
    ts = AdamWState(torch.tensor(7, dtype=torch.int32),
                    tree_map(lambda t: 2 * t, tp),
                    tree_map(lambda t: t * t, tp))
    j_tree, t_tree = {"params": jp, "opt": js}, {"params": tp, "opt": ts}
    j_like = {"params": jp, "opt": tuple(js)}
    want = _flat({"params": jp, "opt": {"0": js.step, "1": js.mu,
                                        "2": js.nu}})
    for writer in ("port", "reference"):
        path = os.path.join(tmp_path, f"{writer}.npz")
        if writer == "port":
            checkpoint.save(path, t_tree, step=123)
        else:
            j_checkpoint.save(path, j_tree, step=123)
        assert checkpoint.latest_step(path) == 123
        assert j_checkpoint.latest_step(path) == 123
        mine = checkpoint.restore(path, t_tree, device="cpu")
        assert isinstance(mine["opt"], AdamWState)
        assert mine["opt"].step.dtype == torch.int32
        ref = j_checkpoint.restore(path, j_like)
        got_m = _flat({"params": tree_map(lambda t: t.numpy(),
                                          mine["params"]),
                       "opt": {str(i): tree_map(lambda t: t.numpy(), v)
                               for i, v in enumerate(mine["opt"])}})
        got_r = _flat({"params": ref["params"],
                       "opt": {str(i): v for i, v in enumerate(ref["opt"])}})
        assert got_m.keys() == got_r.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(got_m[k], w, err_msg=k)
            np.testing.assert_array_equal(got_r[k], w, err_msg=k)


def test_checkpoint_keeps_bf16(tmp_path):
    """A bf16 leaf goes to disk as fp32 and comes back bf16, exactly."""
    t = {"w": torch.randn(5, 3).to(torch.bfloat16)}
    path = os.path.join(tmp_path, "bf16.npz")
    checkpoint.save(path, t)
    assert checkpoint.latest_step(path) is None
    back = checkpoint.restore(path, t)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], t["w"])


# ------------------------------------------------------------ registry
def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def test_registry_specs_match_reference():
    j_all, mine = j_registry.all_configs(), registry.all_configs()
    assert set(mine) == set(j_all)
    n = 0
    for name, cfg in mine.items():
        jcfg = j_all[name]
        for sname, shape in INPUT_SHAPES.items():
            jshape = J_INPUT_SHAPES[sname]
            ok = registry.supports_shape(cfg, shape)
            assert ok == j_registry.supports_shape(jcfg, jshape)
            if not ok:
                continue
            n += 1
            assert _spec_tree(registry.input_specs(cfg, shape)) == \
                _spec_tree(j_registry.input_specs(jcfg, jshape)), \
                (name, sname)
        assert _spec_tree(registry.cache_specs(cfg, 3, 40, "float32")) == \
            _spec_tree(j_registry.cache_specs(jcfg, 3, 40, "float32"))
    assert n >= 40


# ----------------------------------------------------- mesh "train"
def test_mesh_train_context_roles():
    mine = mesh_context(make_mesh((2, 2), ("data", "model"), device="cpu"),
                        "train")
    ref = j_mesh_context(jax.sharding.AbstractMesh((2, 2),
                                                   ("data", "model")),
                         "train")
    for role in ("dp_axis", "tp_axis", "sp_axis", "kv_split_axis",
                 "remat"):
        assert getattr(mine, role) == getattr(ref, role), role
    assert mine.remat and mine.device == torch.device("cpu")
    with pytest.raises(ValueError, match="'train'"):
        mesh_context(make_mesh((2,), ("data",), device="cpu"), "pretrain")


def test_mesh_train_loss_and_grads_equal_single_device(reduced_params_cache,
                                                       reference_grads):
    cfg, pcfg, _, tp = _bridged(reduced_params_cache, "llama3-8b")
    ctx = mesh_context(make_mesh((2, 2), ("data", "model"), device="cpu"),
                       "train")
    batch = _batch(cfg)
    loss, got = _port_grads(tp, pcfg, ctx, batch)
    loss_1, want = _port_grads(tp, pcfg, CPU_CTX, batch)
    assert loss == loss_1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ref_loss, ref = reference_grads("llama3-8b")
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    _assert_grads_close(got, ref)


# ------------------------------------------------------------------ CLI
def test_train_cli_runs_on_cpu(capsys):
    """21 steps log at steps 0, 10 and 20 (every 10th and the last, as
    the reference's launcher logs)."""
    train_cli.main(["--arch", "llama3-8b", "--device", "cpu", "--steps",
                    "21", "--seq-len", "32", "--batch", "2"])
    out = capsys.readouterr().out
    assert out.startswith("llama3-8b-reduced: ")
    steps = re.findall(r"^step +(\d+) loss ([0-9.]+) gnorm", out, re.M)
    assert [int(s) for s, _ in steps] == [0, 10, 20]
    assert all(np.isfinite(float(v)) for _, v in steps)
