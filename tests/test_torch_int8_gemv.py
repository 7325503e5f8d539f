"""Port parity of K3, the weight-only int8 GEMV: the port's plain version
(what a CPU tensor takes) against mxnet_tpu.ops.int8_gemv.
int8_weight_matmul (its CPU fallback). The CUDA kernel is held against
the plain version in tests/test_torch_cuda_kernels.py."""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops.int8_gemv import int8_weight_matmul as jax_int8_matmul

from mxnet_tpu_torch import _build
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import int8_gemv



def _operands(M, N, K, seed=0):
    rng = onp.random.RandomState(seed)
    x = rng.randn(M, K).astype("float32")
    w = rng.randint(-127, 128, (N, K)).astype("int8")
    s = (rng.rand(N) * 0.02 + 1e-3).astype("float32")
    return x, w, s


@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("N,K", [(768, 256), (256, 1024), (256, 256)])
def test_plain_matches_jax(M, N, K):
    """Same math, different f32 summation order (MKL vs XLA:CPU): the
    bound is 1e-5 of the output scale."""
    x, w, s = _operands(M, N, K)
    want = onp.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(s)))
    got = int8_gemv.int8_weight_matmul(torch.from_numpy(x),
                                       torch.from_numpy(w),
                                       torch.from_numpy(s)).numpy()
    assert got.shape == (M, N) and got.dtype == onp.float32
    assert onp.abs(got - want).max() <= 1e-5 * onp.abs(want).max()


def test_cpu_tensor_counts_and_never_builds(monkeypatch):
    """A CPU tensor runs the plain version, counts one 'gemv' launch, and
    never reaches the kernel build (no nvcc needed)."""
    def no_build(*_a, **_k):
        raise AssertionError("the CPU path must not build kernels")
    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    x, w, s = _operands(3, 256, 256)
    with int8_gemv.count_launches() as tally:
        int8_gemv.int8_weight_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(s))
    assert tally == {"gemv": 1}


def test_bad_operands_raise():
    x, w, s = _operands(2, 16, 32)
    with pytest.raises(MXNetError, match="shapes"):
        int8_gemv.int8_weight_matmul(torch.from_numpy(x),
                                     torch.from_numpy(w[:, :16]),
                                     torch.from_numpy(s))
    with pytest.raises(MXNetError, match="int8"):
        int8_gemv.int8_weight_matmul(torch.from_numpy(x),
                                     torch.from_numpy(w).float(),
                                     torch.from_numpy(s))

