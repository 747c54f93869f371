"""Dependency-free checkpointing: parameter and optimizer-state trees as
``.npz`` (reference ``training/checkpoint.py``).

Leaves are saved host-side under the reference's flattened key paths:
dict keys and list or tuple indices joined by ``/``, plus ``__step__``.
A ``NamedTuple`` is a tuple there, so an ``AdamWState`` is written by
index (``opt/0``, ``opt/1/...``) as the reference writes it, and a
checkpoint of either package restores in the other.  numpy has no
bfloat16: a bf16 leaf is written as fp32 (exact) and cast back to the
dtype of the tree it is restored into.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):           # a NamedTuple too
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        t = torch.as_tensor(tree).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[prefix[:-1]] = t.cpu().numpy()
    return out


def _path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Any, step: Optional[int] = None) -> None:
    flat = _flatten(tree)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def restore(path: str, like: Any, device=None) -> Any:
    """The tree saved at ``path``, in the structure and dtypes of
    ``like``: each leaf on ``device``, or on its ``like`` leaf's device
    when that is None.  (The reference's ``shardings`` has no
    counterpart: the port's weights stay whole on one device.)"""
    data = np.load(_path(path))

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            vals = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            return type(tree)(*vals) if hasattr(tree, "_fields") \
                else type(tree)(vals)
        return torch.from_numpy(np.array(data[prefix[:-1]])).to(
            device if device is not None else tree.device, tree.dtype)

    return rebuild(like)


def latest_step(path: str) -> Optional[int]:
    data = np.load(_path(path))
    return int(data["__step__"]) if "__step__" in data else None
