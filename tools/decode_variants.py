#!/usr/bin/env python3
"""A/B builds of the decode kernels K1/K4 (``csrc/paged_decode.cu``) on one
card.

    python3 tools/decode_variants.py [RUN ...]

A RUN is ``variant@target``: a build of the kept source with some of its
tuning constants replaced (VARIANTS below), run with the split planner's
block target ``flash_decode._TARGET_BLOCKS`` set to ``target``.  Every
variant builds with nvcc into ``src/repro_torch/kernels/build/variants/``
(all at once) and is loaded in place of the kept library.  Each run checks
K1 and K4 at the smoke's main shapes (Llama-3-8B heads, rows of
512/2048/4096/6144 keys; K1 also at ChatGLM3-6B's heads, a GQA group of
16, and Nemotron-4-15B's, a group of 6; K4 at ChatGLM3's) and K1 at one
row of 131,072 keys against their plain versions under chip_smoke.py's
elementwise check, then prints their device times (torch.profiler, as
chip_smoke.py times them; the split and merge kernels also apart) as one
JSON line.  Each variant's register and spill report (``-Xptxas -v``) of
its split kernels at groups 6 and 16 is printed once.  Runs go in the
order given, so that turns such as kept, variant, variant, kept share one
call and one card.  Exits nonzero if a run disagrees with the plain
version.
"""

from __future__ import annotations

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import nvcc_variants as nv  # noqa: E402  (tools/, beside this script)

# constexpr values replaced in each variant (the kept source otherwise)
VARIANTS = {
    "kept": {},
    # three ring stages (96 KB): two blocks per SM instead of three
    "stages3": {"RING_BYTES": "96 * 1024", "MIN_BLOCKS": "2"},
    # 256 threads a block, two blocks per SM
    "threads256": {"NT": "256", "MIN_BLOCKS": "2"},
    # 32-key tiles, four stages in the same 64 KB
    "tile32": {"TK": "32"},
    # the merge kernel with one group of head_dim threads per block
    "merge1": {"MERGE_GROUPS": "1"},
    # a group of 16 heads whole in every thread (acc of 16 heads, two
    # blocks per SM) instead of two halves of 8
    "g16_whole": {"BIG_GROUP_SPLIT": "1"},
    # above 8 heads, the scores with the thread's K chunks held in
    # registers and the heads outermost (q of one head live at a time,
    # instead of q of every head for one chunk)
    "g16_kregs": {"score_loop": [(
        r"(?s)(    for \(int g = 0; g < G; \+\+g\) s\[g\] = 0\.f;\n)"
        r"(#pragma unroll\n    for \(int ci = 0; ci < CH / TPK; \+\+ci\) \{"
        r".*?\n    \}\n)(    const bool ok)",
        r"""\1    if constexpr (G > 8) {
      float kr[CH / TPK][EV];
#pragma unroll
      for (int ci = 0; ci < CH / TPK; ++ci)
        unpack16(kt + C::chunk(kk, ci * TPK + part) * 16, kr[ci]);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int ci = 0; ci < CH / TPK; ++ci) {
          float qf[EV];
          lds<EV>(qs + g * D + (ci * TPK + part) * EV, qf);
#pragma unroll
          for (int e = 0; e < EV; ++e) s[g] = fmaf(qf[e], kr[ci][e], s[g]);
        }
    } else {
\2    }
\3""")]},
}
DEFAULT_RUNS = ["kept@792", "merge1@792", "kept@264", "kept@396",
                "kept@528", "kept@660", "kept@924", "stages3@528",
                "stages3@264", "threads256@792", "tile32@792", "merge1@264",
                "kept@792"]


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as fd
    runs = (argv if argv is not None else sys.argv[1:]) or DEFAULT_RUNS
    runs = [r.split("@") for r in runs]
    print(json.dumps({"nvidia_smi": nv.nvidia_smi(),
                      "torch": torch.__version__}), flush=True)
    src = (_build.CSRC / "paged_decode.cu").read_text()
    libs = nv.build({v: nv.edit(src, VARIANTS[v], v)
                     for v in sorted({v for v, _ in runs})}, "paged_decode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, bf)

    def paged(lengths, H=32, KVH=8):
        B, S = len(lengths), max(lengths) + 1
        q, kd = randn(B, H, 128), randn(B, S, KVH, 128)
        vd = randn(B, S, KVH, 128)
        g2 = torch.Generator().manual_seed(2)
        kp, table = chip_smoke._pool_from_dense(kd, 64, g2)
        vp, _ = chip_smoke._pool_from_dense(vd, 64, g2.manual_seed(2))
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        rows = torch.arange(B, device=dev)
        kw = dict(k_new=randn(B, KVH, 128), v_new=randn(B, KVH, 128),
                  append_page=table[rows, (ln // 64).long()],
                  append_slot=ln % 64)
        want = fd.paged_flash_decode_plain(q, kp.clone(), vp.clone(), table,
                                           ln, **kw)
        return (lambda: fd.paged_flash_decode(q, kp, vp, table, ln, **kw),
                want)

    def dense(lengths, S, H=32, KVH=8):
        B = len(lengths)
        q, k, v = randn(B, H, 128), randn(B, S, KVH, 128), \
            randn(B, S, KVH, 128)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return (lambda: fd.flash_decode(q, k, v, ln),
                fd.flash_decode_plain(q, k, v, ln))

    smoke = [512, 2048, 4096, 6144]
    # (case, the split planner's (npg, B, KVH, page))
    cases = {"k1_main": (paged(smoke), (97, 4, 8, 64)),
             "k4_main": (dense(smoke, 6144), (96, 4, 8, 64)),
             "k1_chatglm_g16": (paged(smoke, 32, 2), (97, 4, 2, 64)),
             "k4_chatglm_g16": (dense(smoke, 6144, 32, 2), (96, 4, 2, 64)),
             "k1_nemotron_g6": (paged(smoke, 48, 8), (97, 4, 8, 64)),
             "k1_long_131072": (paged([131072]), (2049, 1, 8, 64))}
    for v in sorted({v for v, _ in runs}):
        rep = chip_smoke._ptxas_report(nv.log_of("paged_decode", v))
        print(json.dumps({"variant": v, "ptxas": {
            k: r for k, r in rep.items()
            if re.search(r"decode_split_kernel<[^,]+, (\(int\))?\d+, "
                         r"(\(int\))?(6|16),", k)}}), flush=True)
    bad = []
    for variant, target in runs:
        _build._libs["paged_decode"] = libs[variant]
        fd._TARGET_BLOCKS = int(target)
        res = {"variant": variant, "target": int(target),
               "splits": {name: fd.plan_splits(*plan)[0]
                          for name, (_, plan) in cases.items()}}
        for name, ((fn, (po, pl)), _) in cases.items():
            o, lse = fn()
            torch.cuda.synchronize()
            ratio = chip_smoke.close_ratio(o, po, 1e-3, 1e-2)
            lse_err = chip_smoke.max_err(lse, pl)
            if not (ratio <= 1.0 and lse_err <= 1e-4):
                bad.append(f"{variant}@{target}/{name}")
            res[name] = {"ms": chip_smoke.time_ms(fn)[0],
                         "by_kernel_ms": nv.ms_by_kernel(
                             fn, r"decode_(split|merge)_kernel"),
                         "o_ratio": ratio, "lse_err": lse_err}
        print(json.dumps(res), flush=True)
    print(json.dumps({"disagree": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
