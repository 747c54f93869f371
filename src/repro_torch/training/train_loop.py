"""Training loop: the loss, the train step and the Trainer that runs it
(reference ``training/train_loop.py``).

The reference differentiates its loss with ``jax.value_and_grad``, which
gives every leaf of the parameter tree a gradient.  Here the parameters
are leaf tensors that require a gradient and the step calls
``backward()``; a parameter left without one (a kernel that cut the
graph, a leaf the loss does not reach) makes the step raise.  The step is
not compiled.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import CPU_CTX, ExecContext
from repro_torch.models.transformer import forward
from repro_torch.training import checkpoint
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import (AdamW, AdamWState, tree_leaves,
                                            tree_map)

AUX_LOSS_WEIGHT = 0.01     # MoE load-balance coefficient


def loss_fn(params: dict, cfg: ModelConfig, ctx: ExecContext,
            batch: Dict[str, torch.Tensor]):
    """Mean next-token cross entropy from fp32 logits plus the weighted
    MoE load-balance loss: ``(loss, (ce, aux))``."""
    logits, aux, _ = forward(params, cfg, ctx, batch["tokens"],
                             batch["positions"], "train",
                             encoder_frames=batch.get("encoder_frames"))
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, batch["labels"][..., None].long())[..., 0]
    ce = torch.mean(lse - ll)
    return ce + AUX_LOSS_WEIGHT * aux, (ce, aux)


def trainable(params: dict) -> dict:
    """The tree as leaf tensors that require a gradient (sharing their
    storage)."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def make_train_step(cfg: ModelConfig, ctx: ExecContext, opt: AdamW
                    ) -> Callable:
    def train_step(params, opt_state: AdamWState, batch):
        for _, p in tree_leaves(params):
            p.grad = None
        loss, (ce, aux) = loss_fn(params, cfg, ctx, batch)
        loss.backward()
        missing = [k for k, p in tree_leaves(params) if p.grad is None]
        if missing:
            raise RuntimeError(f"{cfg.name}: no gradient reached "
                               f"{missing}")
        grads = tree_map(lambda p: p.grad, params)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return trainable(params), opt_state, {
            "loss": ce.detach(), "aux": aux.detach(), "gnorm": gnorm}
    return train_step


@dataclass
class Trainer:
    """Trains ``params`` with ``opt`` on batches of a ``SyntheticLM``.

    The reference's Trainer takes fp32 parameters, and ``jnp`` promotes a
    bf16 config's activations to fp32 at every product; torch refuses a
    product of two dtypes, so the parameters come at ``cfg.dtype``
    (``init_params``' default: bf16 matrices on the card, fp32 norms and
    SSM scalars) and AdamW writes each back in its own dtype."""
    cfg: ModelConfig
    params: dict
    ctx: ExecContext = CPU_CTX
    opt: AdamW = field(default_factory=AdamW)
    ckpt_path: Optional[str] = None
    ckpt_every: int = 0

    def __post_init__(self):
        self.params = trainable(self.params)
        self.opt_state = self.opt.init(self.params)
        self.step_fn = make_train_step(self.cfg, self.ctx, self.opt)
        self.history = []

    def fit(self, data: SyntheticLM, steps: int, log_every: int = 10
            ) -> list:
        t0 = time.time()
        for step in range(steps):
            batch = {k: torch.from_numpy(np.array(v)).to(self.ctx.device)
                     for k, v in data.batch(step).items()}
            self.params, self.opt_state, m = self.step_fn(
                self.params, self.opt_state, batch)
            if step % log_every == 0 or step == steps - 1:
                rec = {"step": step, "loss": float(m["loss"]),
                       "gnorm": float(m["gnorm"]),
                       "wall": time.time() - t0}
                self.history.append(rec)
            if self.ckpt_every and self.ckpt_path and \
                    (step + 1) % self.ckpt_every == 0:
                checkpoint.save(self.ckpt_path,
                                {"params": self.params}, step=step)
        return self.history
