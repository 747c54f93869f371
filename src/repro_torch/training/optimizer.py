"""AdamW (decoupled weight decay) over parameter trees (reference
``training/optimizer.py``).

A tree is a nested dict of tensors, as ``models/params.py`` builds it; the
optimizer state mirrors it.  ``update`` is functional, as the reference's:
it runs under ``torch.no_grad()`` and returns new parameter and state
trees, the moments in fp32 and each parameter in its own dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, NamedTuple, Tuple

import torch


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """(``/``-joined key path, leaf) of a nested dict, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}{k}/")
    else:
        yield path[:-1], tree


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    mu: dict
    nu: dict


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100

    def init(self, params: dict) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32,
                                    requires_grad=False)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warmup: fp32 ``lr * min(1, (step + 1) / warmup)``."""
        warm = torch.clamp((step + 1) / self.warmup_steps, max=1.0)
        return self.lr * warm

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict):
        """One step: the global-norm clip, bias-corrected moments, decay
        only on leaves of 2 or more dims.  Returns (params, state,
        gnorm)."""
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for _, g in tree_leaves(grads)))
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step

        def upd(g, m, v, p):
            g = g.float() * scale
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if p.dim() >= 2:                      # no decay on norms/biases
                delta = delta + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        out = tree_map(upd, grads, state.mu, state.nu, params)
        new_p, mu, nu = (tree_map(lambda t, i=i: t[i], out)
                         for i in range(3))
        return new_p, AdamWState(step, mu, nu), gnorm
