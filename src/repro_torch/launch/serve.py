"""Serving launcher: CDSP/Tetris engine over a synthetic request trace.

``python -m repro_torch.launch.serve --arch yi-9b --requests 8``

Runs the real execution engine on the CUDA card (``--device cpu`` for the
plain PyTorch path): CDSP chunked prefill straight into KV pages, KV
hand-off, continuous-batch paged decode — and prints per-request plans and
latency metrics from the event clock, for the reduced model.  ``serve``
is the entry point for any config (``chip_smoke.py`` drives Llama-3-8B at
its published widths through it).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.latency_model import table1_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request
from repro_torch.serving.simulator import ClusterSpec, Policy, make_policy

SPEC = ClusterSpec(n_prefill=16, n_decode=2, sp_candidates=(1, 2, 4, 8))


def serve(cfg, params, prompts: Sequence[np.ndarray], *, ctx,
          policy="tetris", output_len: int = 8, rate: float = 2.0,
          spec: ClusterSpec = SPEC, max_batch: int = 8, max_seq: int = 512,
          **engine_kw) -> ServingEngine:
    """Serve ``prompts`` arriving ``1 / rate`` seconds apart (event clock)
    and return the drained engine: outputs, chunk_log, request records."""
    pol = (policy if isinstance(policy, Policy)
           else make_policy(policy, table1_model(), spec))
    eng = ServingEngine(cfg, params, spec, pol, ctx=ctx, max_batch=max_batch,
                        max_seq=max_seq, **engine_kw)
    for i, prompt in enumerate(prompts):
        req = Request(rid=i, arrival=i / rate, prompt_len=len(prompt),
                      output_len=output_len)
        eng.submit(req, np.asarray(prompt, np.int32))
    eng.serve()
    return eng


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--policy", default="tetris",
                    choices=["tetris", "single_chunk", "loongserve_disagg",
                             "fixed_sp_8", "fixed_sp_16"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--output-len", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    from repro_torch.serving.simulator import summarize

    ctx = make_context(args.device)
    cfg = get_config(args.arch).reduced()
    params = init_params(cfg, seed=0, device=ctx.device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(32, 200)))
               for _ in range(args.requests)]
    eng = serve(cfg, params, prompts, ctx=ctx, policy=args.policy,
                output_len=args.output_len, rate=args.rate)
    for rid, toks in sorted(eng.outputs.items()):
        r = eng.reqs[rid]
        print(f"req {rid}: len={r.prompt_len} plan={r.chunk_plan} "
              f"chunks@{[f'{t:.3f}' for t in r.chunk_exec]} "
              f"ttft={r.ttft:.3f}s tokens={toks[:8]}...")
    s = summarize(eng.reqs)
    print(f"\nTTFT p50 {s['ttft_p50']:.3f}s p99 {s['ttft_p99']:.3f}s | "
          f"TBT p50 {s['tbt_p50']*1e3:.1f}ms | "
          f"throughput {s['throughput_tok_s']:.1f} tok/s (event clock)")


if __name__ == "__main__":
    main()
