"""bagel_tpu_torch int8_matmul (B5) vs bagel_tpu's Pallas int8_matmul.

On CPU tensors the port's wrapper takes its plain version (an int32
matmul, then the f32 epilogue); it must equal the Pallas kernel in
interpret mode bit for bit, in both its variants (the whole of K in one
step, bk=0, and a k loop, bk < K). The CUDA kernel is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bagel_tpu.ops.int8_matmul import int8_matmul as jint8_matmul
from bagel_tpu_torch.ops import int8_matmul as t8
from bagel_tpu_torch.utils.quant import to_kmajor


def _inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = (rng.uniform(0.5, 2.0, (m, 1)) / 127).astype(np.float32)
    ws = (rng.uniform(0.5, 2.0, n) / 127).astype(np.float32)
    return xq, xs, wq, ws


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (64, 256, 128, 32, 128, 0),     # one k step
    (64, 512, 256, 64, 128, 128),   # a k loop of 4
    (16, 384, 128, 16, 128, 0),
    (32, 384, 256, 32, 256, 128),   # k loop of 3
])
def test_plain_equals_pallas(m, k, n, bm, bn, bk, out_dtype):
    xq, xs, wq, ws = _inputs(0, m, k, n)
    want = jint8_matmul(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq), jnp.asarray(ws),
                        bm=bm, bn=bn, bk=bk, out_dtype=getattr(jnp, out_dtype),
                        interpret=True)
    got = t8.int8_matmul(torch.tensor(xq), torch.tensor(xs), torch.tensor(wq),
                         torch.tensor(ws), out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    assert t8.int8_matmul.launches == 0  # CPU tensors never reach the kernel


def test_products_are_exact_at_the_largest_k():
    """|sum| reaches 127^2 K at K = 18944 (the down projection): the int32
    sums on the CPU, and the float64 product the card's plain version uses,
    are both exact there."""
    k = 18944
    xq = torch.full((2, k), 127, dtype=torch.int8)
    xq[1] = -127
    wq = torch.full((k, 3), 127, dtype=torch.int8)
    exact = 127 * 127 * k
    acc = t8.int8_products(xq, wq)
    assert acc.dtype == torch.float32
    assert acc[0, 0].item() == float(np.float32(exact))
    assert acc[1, 0].item() == float(np.float32(-exact))
    assert (xq.double() @ wq.double())[0, 0].item() == exact


def test_bias_epilogue_order():
    """((acc * xs) * ws) + b, each step rounded in f32, then one rounding."""
    xq, xs, wq, ws = _inputs(1, 5, 64, 16)
    b = np.random.default_rng(2).standard_normal(16).astype(np.float32)
    got = t8.int8_matmul(torch.tensor(xq), torch.tensor(xs), torch.tensor(wq),
                         torch.tensor(ws), torch.tensor(b), out_dtype=torch.float32)
    acc = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
    want = (acc * xs).astype(np.float32) * ws
    want = want.astype(np.float32) + b
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_rejects_bad_inputs_before_launch():
    """The checks run before any kernel is built (no nvcc here)."""
    xq, xs, wq, ws = (torch.tensor(a) for a in _inputs(3, 4, 64, 16))
    with pytest.raises(TypeError):
        t8._check(xq.float(), xs, wq, ws, None, torch.bfloat16)
    with pytest.raises(ValueError):
        t8._check(xq, xs[:3], wq, ws, None, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        t8._check(xq[:, :40], xs, wq[:40], ws, None, torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 or f32"):  # f32: the partial-sum instance
        t8._check(xq, xs, wq, ws, None, torch.float16)
    with pytest.raises(ValueError, match="k-major"):  # the CUDA kernel reads [N, K]
        t8._check(xq, xs, wq, ws, torch.zeros(16), torch.bfloat16)
    t8._check(xq, xs, to_kmajor(wq), ws, torch.zeros(16), torch.bfloat16)
