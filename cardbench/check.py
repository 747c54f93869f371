"""How ``correct`` is decided: once the window has closed, a sample drawn
from the seed of the requests the engine finished, with the one of the
longest prompt in it, until the sample holds ``check.tokens`` served
tokens; the plain reference (``refs/<family>.py``) runs once over each
prompt with its served tokens, and the number compared is the widest gap
by which a served token's logit lies below the reference's best at its
position.  Greedy tokens are exact on the reference's own logits, so a
right stream reads 0 but for rounding, where two tokens lie closer than
the program's rounding error.

The control reads the same gap for the token that the reference in the
control's precision (``mode="fp8"``) puts first (``gaps(...,
control=True)``).
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_ref(family: str):
    """The plain reference of a family, by its file ``refs/<family>.py``."""
    path = os.path.join(HERE, "refs", f"{family}.py")
    spec = importlib.util.spec_from_file_location(f"cardbench_ref_{family}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pick(finished: Dict[int, tuple], seed: int, tokens: int) -> List[int]:
    """Request ids of the sample: the finished request with the longest
    prompt, then others in an order drawn from the seed, until the sample
    holds ``tokens`` served tokens.  ``finished``: rid -> (prompt,
    served)."""
    if not finished:
        return []
    rids = sorted(finished)
    longest = max(rids, key=lambda r: (len(finished[r][0]), -r))
    order = [r for r in np.random.default_rng([seed, 17]).permutation(rids)
             if r != longest]
    out, n = [longest], len(finished[longest][1])
    for r in order:
        if n >= tokens:
            break
        out.append(int(r))
        n += len(finished[r][1])
    return out


def _inputs(prompt: np.ndarray, served: Sequence[int]):
    """The reference's sequence (the prompt, then every served token but
    the last) and the positions whose logits chose the served tokens."""
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(served[:-1], np.int64)])
    P = len(prompt)
    return seq, np.arange(P - 1, P - 1 + len(served))


def gaps(ref, weights, c: dict, items: List[tuple], control: bool = False
         ) -> tuple:
    """For each (prompt, served) pair, at every served position: the
    reference's best logit minus its logit of the served token; and with
    ``control``, minus its logit of the token the reference in the
    control's precision (fp8) puts first (else None)."""
    if not items:
        return [], []
    seqs, reads = zip(*[_inputs(p, s) for p, s in items])
    hi = ref.logits(weights, c, seqs, reads, mode="fp32")

    def gap(lg, tok):
        best = lg.max(dim=-1).values
        return (best - lg.gather(1, tok[:, None])[:, 0]).double().cpu().numpy()

    out = [gap(h, torch.as_tensor(np.asarray(s, np.int64), device=h.device))
           for h, (_, s) in zip(hi, items)]
    if not control:
        return out, None
    lo = ref.logits(weights, c, seqs, reads, mode="fp8")
    return out, [gap(h, l.argmax(dim=-1)) for h, l in zip(hi, lo)]


def fingerprint(tree: dict) -> List[float]:
    """Sums of every weight leaf, a layer at a time: the reference reads
    the tensors the benchmark made, so the program must leave them as
    they were (a sum on one device is the same for the same bits)."""
    out = []

    def walk(t):
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                walk(v)
            else:
                out.extend(float(x.float().sum()) for x in
                           (v if v.dim() >= 3 else [v]))
    walk(tree)
    return out
