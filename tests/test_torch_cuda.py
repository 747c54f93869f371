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
    windows, POS_PAD columns, masked and padded rows, ragged tails, the
    fused append's pool bytes, dense caches of any length with an offset,
    and SSD scans with ragged, sub-chunk and grouped inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    chip_smoke.phase_kernels(full_shapes=False)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    return torch.device("cuda")


@pytest.mark.cuda
def test_dense_decode_kernel_on_card():
    """K4 against its plain version: a row with no valid key, a window, a
    cache offset, a length that is not a multiple of the split page."""
    dev = _card()
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    g = torch.Generator().manual_seed(0)
    for dtype, atol, rtol in ((torch.float32, 1e-5, 1e-4),
                              (torch.bfloat16, 1e-3, 1e-2)):
        q = torch.randn(3, 8, 128, generator=g).to(dev, dtype)
        k = torch.randn(3, 203, 2, 128, generator=g).to(dev, dtype)
        v = torch.randn(3, 203, 2, 128, generator=g).to(dev, dtype)
        ln = torch.tensor([203, 0, 150], dtype=torch.int32, device=dev)
        for kw in ({}, {"window": 40}, {"kv_offset": 7}):
            before = flash_decode.launches
            o, lse = flash_decode(q, k, v, ln, **kw)
            po, plse = flash_decode_plain(q, k, v, ln, **kw)
            assert flash_decode.launches == before + 1
            torch.testing.assert_close(o.float(), po.float(), atol=atol,
                                       rtol=rtol)
            torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)
            assert not o[1].any()


@pytest.mark.cuda
def test_ssd_scan_kernel_on_card():
    """K5 against its plain version: a ragged tail, a handed-in state,
    grouped B/C, and x/B/C read in place from one fused projection."""
    dev = _card()
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    g = torch.Generator().manual_seed(1)
    B, S, H, P, G, N = 2, 333, 8, 64, 2, 128
    for dtype, atol, rtol in ((torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, 1e-3, 1e-2)):
        xbc = torch.randn(B, S, H * P + 2 * G * N, generator=g).to(dev,
                                                                   dtype)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
        Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
        dt = torch.empty(B, S, H).uniform_(1e-3, 1e-1, generator=g).to(dev)
        A = -torch.empty(H).uniform_(1.0, 16.0, generator=g).to(dev)
        h0 = torch.randn(B, H, P, N, generator=g).to(dev)
        before = ssd_scan.launches
        y, h = ssd_scan(x, dt, A, Bm, Cm, h0=h0, chunk=128)
        py, ph = ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0, chunk=128)
        assert ssd_scan.launches == before + 1
        torch.testing.assert_close(y.float(), py.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(h, ph, atol=1e-4, rtol=1e-4)
