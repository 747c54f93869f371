"""Training launcher: ``python -m repro_torch.launch.train --arch llama3-8b``.

Trains the reduced variant of the chosen architecture on the CUDA card
(``--device cpu`` for the plain PyTorch path; the default ``cuda`` raises
without a card), K3 and K5 running under autograd there.  ``--full``
trains the published config under ``launch.mesh.make_context(mesh,
"train")`` on a one-position "data" mesh of the device (each block
rematerialised), with parameters at the config's dtype (bf16 matrices).
The reference's 16 x 16 production mesh is not ported.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs.registry import NAMES


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=NAMES)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="the published config on a one-position mesh")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_context, make_mesh
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.sharding import make_context as device_context
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import Trainer

    cfg = get_config(args.arch)
    if args.full:
        ctx = make_context(make_mesh((1,), ("data",), args.device), "train")
    else:
        cfg = cfg.reduced()
        ctx = device_context(args.device)
    params = init_params(cfg, seed=0, device=ctx.device)
    print(f"{cfg.name}: {count_params(params)/1e6:.1f}M params")
    data = make_pipeline(cfg, args.seq_len, args.batch)
    tr = Trainer(cfg, params, ctx=ctx, opt=AdamW(lr=args.lr),
                 ckpt_path=args.ckpt, ckpt_every=50 if args.ckpt else 0)
    for rec in tr.fit(data, args.steps, log_every=10):
        print(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
              f"gnorm {rec['gnorm']:.3f} wall {rec['wall']:.1f}s")


if __name__ == "__main__":
    main()
