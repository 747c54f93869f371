"""Card-only tests of the port: the hand-written CUDA kernels against their
plain versions.  They skip without a CUDA device (the kernels have no CPU
mode).  This file imports neither jax nor the reference package, so it
also runs where only the port is installed:

    python3 -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import os
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """Every kernel against its plain version at the edge cases of
    ``chip_smoke.py``: page sizes 8-64, head_dim 32/128, GQA groups 1-8,
    windows, POS_PAD columns, masked and padded rows, ragged tails, and the
    fused append's pool bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    chip_smoke.phase_kernels(full_shapes=False)
