"""The port's CUDA kernels against their plain PyTorch versions on the card.

Runs only where there is a card; elsewhere each test skips. The card's
machine has no JAX, so run this file without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q -p no:randomly

Tolerance: |kernel - plain| / (sum of |inputs| into the element) <= 1e-4 in
float32 (sums in another order, with atomics in the backward) and 1e-2 in
bfloat16 (one more rounding of the output).
"""
import numpy as np
import pytest
import torch

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.ops import onehot_matmul as oh
from hugectr_tpu_torch.ops import segscan as ss

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (B, V, h): ragged shapes with padding, and table 3 of the flagship
ONEHOT_CASES = [(300, 57, 1), (300, 100, 3), (300, 600, 6), (4096, 7424, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _scaled(got, want, scale):
    return float(((got.double() - want.double()).abs() / (scale.double() + 1e-30)).max())


def _keys(rng, b, h, v, pad=0.2):
    k = rng.integers(0, v, size=(b, h)).astype(np.int32)
    k[rng.random((b, h)) < pad] = -1
    return k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_kernels_match_plain_versions(cuda, dtype):
    rng = np.random.default_rng(5)
    for b, v, h in ONEHOT_CASES:
        keys = torch.from_numpy(_keys(rng, b, h, v)).to(cuda)
        table = torch.from_numpy(rng.normal(size=(v, 128)).astype(np.float32)).to(cuda, dtype)
        d = torch.from_numpy(rng.normal(size=(b, 128)).astype(np.float32)).to(cuda, dtype)
        ops.reset_counts()
        out = oh.onehot_matmul_fwd(keys, table)
        g, c = oh.onehot_matmul_bwd(keys, d, v, dtype)
        assert ops.launch_counts()["onehot_fwd"] == 1 and ops.launch_counts()["onehot_bwd"] == 1
        assert out.dtype == dtype and g.dtype == dtype and c.dtype == torch.float32
        scale = oh.onehot_matmul_fwd_plain(keys, table.float().abs())
        assert _scaled(out, oh.onehot_matmul_fwd_plain(keys, table), scale) <= TOL[dtype]
        wg, wc = oh.onehot_matmul_bwd_plain(keys, d, v, dtype)
        sg, _ = oh.onehot_matmul_bwd_plain(keys, d.float().abs(), v, torch.float32)
        assert _scaled(g, wg, sg) <= TOL[dtype]
        assert torch.equal(c, wc)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segscan_kernel_matches_plain_version(cuda, dtype):
    rng = np.random.default_rng(6)
    for k, nseg in ((1, 1), (1000, 1), (1000, 1000), (100_003, 20_000)):
        seg = np.sort(rng.integers(0, nseg, k))
        heads = torch.from_numpy(np.concatenate([[True], seg[1:] != seg[:-1]])).to(cuda)
        vals = torch.from_numpy(rng.normal(size=(k, 128)).astype(np.float32)).to(cuda, dtype)
        got = ss.segmented_sum_sorted(vals, heads)
        scale = ss.segmented_sum_sorted_plain(vals.float().abs(), heads)
        assert _scaled(got, ss.segmented_sum_sorted_plain(vals, heads), scale) <= TOL[dtype]
