#!/usr/bin/env python3
"""What the mesh's dry-run accounting costs a served tick, on one card.

    python3 tools/mesh_overhead.py [--ticks N]

The dry run (``launch/dryrun.py``) needs each island to name the
position whose body runs (``launch.mesh.at``), each collective to note
itself (``launch.mesh._record``), and the split-KV owner write to have a
form whose shapes do not depend on the positions' values
(``core.ring_attention._owner_writes``: on a device the owning shards
are read back once and only they write; on meta tensors a select over
every row).  This times Llama-3-8B's split-KV dense decode tick as
``chip_smoke.py``'s ``sp_dense`` path runs it (one row, a 6160-slot
cache split 4 ways into shards of 1540 keys, 8 KV heads of 128, 32
heads; 32 layers of ``split_kv_decode`` with the new token's write, K4 a
shard) in two forms, in the order kept, earlier, earlier, kept, kept,
earlier:

* kept — ``core.ring_attention.split_kv_decode`` as it stands;
* earlier — the form before the dry run (copied below): no ``at``, the
  owner write by ``nonzero`` (which waits on the card) in every shard,
  and ``_record`` a no-op.

Each form: the host seconds of a tick (32 layers, the card synchronised
at the tick's end), median over ``--ticks`` ticks after one untimed
tick, and the device ms of a tick by CUDA events.  Also ``at`` entered
and left alone, in microseconds.  Both forms' outputs (over caches
written alike) must agree bit for bit.  Prints one JSON line; exits nonzero without a card
or if the forms disagree.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

LAYERS, SP, S_LOC, H, KVH, D = 32, 4, 1540, 32, 8, 128


def _owner_write_nonzero(k_loc, v_loc, k_new, v_new, positions, idx):
    s_loc = k_loc.shape[1]
    local = positions.long() - idx * s_loc
    rows = torch.nonzero((local >= 0) & (local < s_loc)).flatten()
    if rows.numel():
        k_loc[rows, local[rows]] = k_new[rows].to(k_loc.dtype)
        v_loc[rows, local[rows]] = v_new[rows].to(v_loc.dtype)


def _split_kv_decode_earlier(q, k_cache, v_cache, lengths, *, mesh,
                             split_axis, k_new, v_new):
    from repro_torch.core import ring_attention as ra
    from repro_torch.launch.mesh import to
    devices = mesh.positions(split_axis)
    ks, vs = ra._shards(k_cache, devices), ra._shards(v_cache, devices)
    for i, d in enumerate(devices):
        _owner_write_nonzero(ks[i], vs[i], to(k_new, d), to(v_new, d),
                             to(lengths, d), i)
    lengths = lengths + 1
    parts = [ra.split_kv_decode_local(to(q, d), ks[i], vs[i],
                                      to(lengths, d), idx=i)
             for i, d in enumerate(devices)]
    o = ra._lse_merge_over_axis([p[0] for p in parts],
                                [p[1] for p in parts], q.device)
    return o.to(q.dtype), k_cache, v_cache


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_overhead: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import ring_attention as ra
    from repro_torch.launch import mesh as tmesh
    dev = torch.device("cuda")
    mesh = tmesh.make_mesh((1, SP), ("data", "model"), device="cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)

    caches = [([randn(1, S_LOC, KVH, D) for _ in range(SP)],
               [randn(1, S_LOC, KVH, D) for _ in range(SP)])
              for _ in range(LAYERS)]
    qs = [randn(1, H, D) for _ in range(LAYERS)]
    news = [(randn(1, KVH, D), randn(1, KVH, D)) for _ in range(LAYERS)]
    # position 4100 of the 6160 slots: shard 2 owns the write
    lengths = torch.tensor([4100], dtype=torch.int32, device=dev)
    record = tmesh._record
    forms = {"kept": (ra.split_kv_decode, record),
             "earlier": (_split_kv_decode_earlier, lambda *a, **k: None)}

    def tick(decode):
        outs = []
        for (kc, vc), q, (kn, vn) in zip(caches, qs, news):
            o, _, _ = decode(q, kc, vc, lengths, mesh=mesh,
                             split_axis="model", k_new=kn, v_new=vn)
            outs.append(o)
        return outs

    res = {}
    outs = {}
    try:
        for name in ("kept", "earlier", "earlier", "kept", "kept",
                     "earlier"):
            decode, tmesh._record = forms[name]
            with torch.no_grad():
                outs[name] = tick(decode)
                torch.cuda.synchronize()
                host, dev_ms = [], []
                for _ in range(args.ticks):
                    a, b = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                    t0 = time.perf_counter()
                    a.record()
                    tick(decode)
                    b.record()
                    torch.cuda.synchronize()
                    host.append(time.perf_counter() - t0)
                    dev_ms.append(a.elapsed_time(b))
            r = res.setdefault(name, {"host_s": [], "device_ms": []})
            r["host_s"].append(statistics.median(host))
            r["device_ms"].append(statistics.median(dev_ms))
    finally:
        tmesh._record = record
    same = all(torch.equal(a, b) for a, b in zip(outs["kept"],
                                                 outs["earlier"]))
    line = mesh.positions("model")
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tmesh.at(line, 2):
            pass
    at_us = (time.perf_counter() - t0) / n * 1e6
    print(json.dumps({
        "tool": "mesh_overhead", "shape": {
            "layers": LAYERS, "shards": SP, "s_loc": S_LOC, "heads": H,
            "kv_heads": KVH, "head_dim": D, "rows": 1},
        "ticks": args.ticks,
        "order": "kept, earlier, earlier, kept, kept, earlier",
        "tick_host_s_median": res, "at_enter_exit_us": at_us,
        "outputs_identical": same,
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
