"""RMSNorm in the PyTorch port (paddle_tpu_torch/ops/fused_norm.py) against
the JAX package's Pallas kernel (interpret mode) and its jnp reference, on
the CPU, with the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused_norm as jfn
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.ops import fused_norm as tfn

# fp32 on both sides; only the order of the D-term sum differs
TOL = dict(rtol=1e-5, atol=1e-6)


def _case(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (16, 256)])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_plain_matches_pallas_interpret_and_jnp_ref(shape, eps):
    x, w = _case(shape)
    ref = np.asarray(jfn._rms_ref(jnp.asarray(x), jnp.asarray(w), eps))
    pallas = np.asarray(jfn._rms_pallas(jnp.asarray(x), jnp.asarray(w), eps,
                                        interpret=True))
    out = tfn.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), pallas, **TOL)


def test_bf16_output_within_one_rounding_of_jax():
    """bf16 in, fp32 math, bf16 out on both sides: the outputs may differ
    by at most one bf16 rounding step (the fp32 sums differ in order)."""
    x, w = _case((8, 256), seed=1)
    ref = np.asarray(jfn._rms_ref(jnp.asarray(x).astype(jnp.bfloat16),
                                  jnp.asarray(w).astype(jnp.bfloat16),
                                  1e-5).astype(jnp.float32))
    out = tfn.fused_rms_norm(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(w).bfloat16(), 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=0)


def test_cpu_tensors_never_launch_and_cuda_wrapper_refuses_them():
    x, w = _case((4, 64))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    tops.reset_launch_counts()
    tfn.fused_rms_norm(xt, wt, 1e-5)
    assert tops.launch_counts()["rms_norm"] == 0
    # the kernel wrapper itself has no CPU fallback
    with pytest.raises(ValueError, match="CUDA"):
        tfn.rms_norm_cuda(xt, wt, 1e-5)
    assert tops.launch_counts()["rms_norm"] == 0


def test_kernel_mode_contract():
    assert tops.kernel_mode() == "auto"
    with pytest.raises(ValueError):
        tops.set_kernel_mode("pallas")
    tops.set_kernel_mode("reference")
    try:
        x, w = _case((2, 64))
        out = tfn.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                                 1e-5)
        np.testing.assert_allclose(
            out.numpy(), tfn._rms_ref(torch.from_numpy(x),
                                      torch.from_numpy(w), 1e-5).numpy())
    finally:
        tops.set_kernel_mode("auto")
