"""`ops.fused_mlp` (the fused gated MLP) of the PyTorch port against the
JAX package on the CPU: the forward against the JAX kernel in interpret
mode (`fused_swiglu(impl="fused", interpret=True)`) and against
`swiglu_reference`, for the three activations and 2-D and 3-D inputs;
the gradients of x and the three weights against `jax.vjp` of the JAX
kernel's custom vjp; the argument checks. The port's weights are the
JAX kernels transposed ([out, in]).

Tolerances, with their reasons:
- f32 forward and gradients: 1e-5 relative and absolute (the same f32
  products, summed in another order; |values| up to ~5).
- bf16 forward: 2^-6 relative plus 2e-2 of the tensor's rms. Both round
  g, u and the output to bf16, but XLA's CPU compiler may keep excess
  precision through the fused activation and product where the port
  rounds act(g) and act(g) * u, and the products accumulate in another
  order: a value near a rounding boundary can move one or two bf16 steps
  (2^-8 to 2^-7 each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.ops import fused_mlp as jfm
from cloud_tpu_torch.ops import fused_mlp as tfm

ACTIVATIONS = ("silu", "gelu_tanh", "gelu")


def _data(lead, features=48, d_ff=80, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (features,)).astype(np.float32)
    wg = (rng.normal(size=(features, d_ff)) / np.sqrt(features)).astype(
        np.float32)
    wu = (rng.normal(size=(features, d_ff)) / np.sqrt(features)).astype(
        np.float32)
    wd = (rng.normal(size=(d_ff, features)) / np.sqrt(d_ff)).astype(
        np.float32)
    return x, wg, wu, wd


def _port(x, wg, wu, wd):
    """The same values as port tensors, weights [out, in]."""
    return (torch.from_numpy(x), torch.from_numpy(wg.T.copy()),
            torch.from_numpy(wu.T.copy()), torch.from_numpy(wd.T.copy()))


@pytest.mark.parametrize("lead", [(7,), (2, 5)], ids=["rows7", "lead2x5"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_forward_matches_jax_kernel_f32(activation, lead):
    x, wg, wu, wd = _data(lead)
    want = jfm.fused_swiglu(*map(jnp.asarray, (x, wg, wu, wd)),
                            activation=activation, impl="fused",
                            interpret=True)
    ref = jfm.swiglu_reference(*map(jnp.asarray, (x, wg, wu, wd)),
                               activation=activation)
    got = tfm.fused_swiglu(*_port(x, wg, wu, wd), activation=activation)
    assert got.dtype == torch.float32 and got.shape == lead + (48,)
    for w in (want, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    plain = tfm.swiglu_reference(*_port(x, wg, wu, wd),
                                 activation=activation)
    assert torch.equal(plain, got)
    # The card checks' oracle: in f32 its roundings are no-ops.
    a, y = tfm.swiglu_rounded_reference(*_port(x, wg, wu, wd),
                                        activation=activation)
    assert a.shape == lead + (80,)
    np.testing.assert_allclose(y.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_forward_matches_jax_kernel_bf16(activation):
    """compute_dtype bf16 from f32 parameters (the model's case)."""
    x, wg, wu, wd = _data((3, 6), seed=1)
    want = np.asarray(jfm.fused_swiglu(
        *map(jnp.asarray, (x, wg, wu, wd)), activation=activation,
        compute_dtype=jnp.bfloat16, impl="fused",
        interpret=True).astype(jnp.float32))
    got = tfm.fused_swiglu(*_port(x, wg, wu, wd), activation=activation,
                           compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    rms = float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -6,
                               atol=2e-2 * rms)


@pytest.mark.parametrize("lead", [(9,), (2, 3)], ids=["rows9", "lead2x3"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_gradients_match_jax_vjp(activation, lead):
    x, wg, wu, wd = _data(lead, seed=2)
    dy = np.random.default_rng(3).normal(size=lead + (48,)).astype(
        np.float32)

    def jfun(x, wg, wu, wd):
        return jfm.fused_swiglu(x, wg, wu, wd, activation=activation,
                                impl="fused", interpret=True)

    _, vjp = jax.vjp(jfun, *map(jnp.asarray, (x, wg, wu, wd)))
    want = vjp(jnp.asarray(dy))
    leaves = [t.requires_grad_(True) for t in _port(x, wg, wu, wd)]
    y = tfm.fused_swiglu(*leaves, activation=activation)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):     # [out, in] against [in, out]
        np.testing.assert_allclose(g.numpy().T, np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_bf16_gradients_reach_f32_weights_in_their_dtype():
    """With bf16 compute from f32 parameters, the weight gradients are
    rounded to bf16 (the Function's inputs) and reach the f32 leaves as
    f32, as JAX's cast-then-custom-vjp does."""
    x, wg, wu, wd = _data((4,), seed=4)
    leaves = [t.requires_grad_(True) for t in _port(x, wg, wu, wd)]
    y = tfm.fused_swiglu(*leaves, compute_dtype=torch.bfloat16)
    y.float().sum().backward()
    for leaf in leaves:
        assert leaf.grad.dtype == torch.float32
        assert torch.equal(leaf.grad, leaf.grad.bfloat16().float())


def test_argument_checks():
    x = torch.zeros((3, 16))
    wg = torch.zeros((24, 16))
    with pytest.raises(ValueError, match="w_gate must be"):
        tfm.fused_swiglu(x, wg.T, wg.T, torch.zeros((16, 24)))
    with pytest.raises(ValueError, match="w_up must match"):
        tfm.fused_swiglu(x, wg, torch.zeros((8, 16)), torch.zeros((16, 24)))
    with pytest.raises(ValueError, match="w_down must be"):
        tfm.fused_swiglu(x, wg, wg, torch.zeros((16, 8)))
    with pytest.raises(ValueError, match="Unknown mlp activation"):
        tfm.fused_swiglu(x, wg, wg, torch.zeros((16, 24)),
                         activation="relu")
    with pytest.raises(ValueError, match="impl"):
        tfm.fused_swiglu(x, wg, wg, torch.zeros((16, 24)), impl="pallas")
    tfm.reset_launches()
    y = tfm.fused_swiglu(x, wg, wg, torch.zeros((16, 24)), impl="reference")
    assert y.shape == (3, 16)
    # CPU tensors take the plain version: no kernel launches.
    assert tfm.launches == {"fused_mlp_gate_up": 0, "fused_mlp_down": 0}


def test_cost_at_the_llama_shape():
    cost = tfm.fused_mlp_cost((4, 2048, 2048), 5632, torch.bfloat16)
    assert cost["total"]["flops"] == 6.0 * 8192 * 2048 * 5632
    assert cost["gate_up"]["flops"] + cost["down"]["flops"] == \
        cost["total"]["flops"]
    # 0.573 ms at 989 TFLOP/s; the intermediate written and read back.
    assert abs(cost["total"]["flops"] / 989e12 * 1e3 - 0.573) < 1e-3
    assert cost["intermediate_bytes"] == 2 * 8192 * 5632 * 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_tma_rule_refuses_a_misaligned_base(dtype):
    n = 64
    misaligned = torch.empty(n + 1, dtype=dtype)[1:].view(8, 8)
    assert misaligned.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tfm._check_tma_addressable(misaligned, "x")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_tma_rule_refuses_rows_not_16_bytes_apart(dtype):
    # 12 values a row: 24 bytes in bf16, 48 in f32 (a multiple of 16), so
    # take 10 (20 and 40 bytes).
    t = torch.empty((4, 10), dtype=dtype)[:, :8]
    with pytest.raises(ValueError, match="16 bytes apart"):
        tfm._check_tma_addressable(t, "w_gate")
    with pytest.raises(ValueError, match="TMA"):
        tfm._check_tma_addressable(torch.empty((8, 4), dtype=dtype).T, "w")


@pytest.mark.parametrize("shape", [(8, 64), (1, 8), (3, 2048)],
                         ids=["8x64", "1x8", "3x2048"])
def test_tma_rule_takes_aligned_rows(shape):
    for dtype in (torch.bfloat16, torch.float32):
        t = torch.empty(shape, dtype=dtype)
        assert t.data_ptr() % 16 == 0
        tfm._check_tma_addressable(t, "x")
        # A view that starts a whole number of rows in stays aligned.
        tfm._check_tma_addressable(torch.empty((shape[0] + 2, shape[1]),
                                              dtype=dtype)[2:], "x")
