"""`ops.fused_norm` (the fused residual-add + RMSNorm) of the PyTorch
port against the JAX package on the CPU: the forward against the JAX
kernel in interpret mode (`fused_rmsnorm(impl="fused", interpret=True)`)
and against `rmsnorm_residual_reference`, the gradients against
`jax.vjp` of the JAX kernel's custom vjp, and the argument checks.

Tolerances, with their reasons:
- h: bit-equal (the same add in the same dtype, rounded once).
- normed from a bf16 x + residual: the TPU kernel rounds h to bf16 before
  its f32 statistics (`fused_norm.py:74-79`), and so does the port; XLA's
  CPU compiler keeps excess precision when it fuses a bf16 add with the
  f32 convert after it, so the JAX functions on the CPU would take the
  statistics of the unrounded sum (0.4 % apart). There the JAX side is
  given the materialized h, which it returned, without the residual.
- normed, f32: 1e-6 relative and absolute (the same f32 arithmetic; the
  row mean sums in another order).
- normed, bf16 output: one bf16 step, 2^-7 relative (the f32 statistics
  differ in their last bits, which can move a value across a rounding
  boundary of the single cast).
- gradients (f32): 1e-5 (the same formula in f32; sums over rows and
  features in another order, values up to ~10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.ops import fused_norm as jfn
from cloud_tpu_torch.ops import fused_norm as tfn

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _data(lead, features, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (features,)).astype(np.float32)
    r = rng.normal(size=lead + (features,)).astype(np.float32)
    scale = (rng.normal(size=(features,)) * 0.1 + 1.0).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(x, jdt), jnp.asarray(r, jdt), jnp.asarray(scale)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(r).to(tdt),
             torch.from_numpy(scale)))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_normed(got, want, out_dtype):
    got = got.float().numpy()
    if out_dtype == "bf16":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lead", [(7,), (2, 5)], ids=["rows7", "lead2x5"])
@pytest.mark.parametrize("out_dtype", [None, "other"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_residual", [False, True],
                         ids=["noresidual", "residual"])
def test_forward_matches_jax_kernel(with_residual, dtype, out_dtype, lead):
    (jx, jr, js), (tx, tr, ts) = _data(lead, 136, dtype)
    out = {None: dtype, "other": "f32" if dtype == "bf16" else "bf16"}[
        out_dtype]
    jout, tout = DTYPES[out]
    kw = dict(eps=1e-5, out_dtype=None if out_dtype is None else jout)
    want, want_h = jfn.fused_rmsnorm(jx, js, residual=jr if with_residual
                                     else None, impl="fused",
                                     interpret=True, **kw)
    ref, ref_h = jfn.rmsnorm_residual_reference(
        jx, js, residual=jr if with_residual else None, **kw)
    if with_residual and dtype == "bf16":
        want, _ = jfn.fused_rmsnorm(want_h, js, impl="fused",
                                    interpret=True, **kw)
        ref, _ = jfn.rmsnorm_residual_reference(ref_h, js, **kw)
    got, h = tfn.fused_rmsnorm(tx, ts, residual=tr if with_residual
                               else None, eps=1e-5,
                               out_dtype=None if out_dtype is None else tout)
    assert got.dtype == tout and got.shape == tx.shape
    assert h.dtype == tx.dtype and h.shape == tx.shape
    np.testing.assert_array_equal(h.float().numpy(), _np(want_h))
    np.testing.assert_array_equal(h.float().numpy(), _np(ref_h))
    _assert_normed(got, _np(want), out)
    _assert_normed(got, _np(ref), out)
    # The plain version itself, as the wrapper runs it on CPU tensors.
    plain, plain_h = tfn.rmsnorm_residual_reference(
        tx, ts, residual=tr if with_residual else None, eps=1e-5,
        out_dtype=None if out_dtype is None else tout)
    assert torch.equal(plain, got) and torch.equal(plain_h, h)


@pytest.mark.parametrize("lead", [(9,), (3, 4)], ids=["rows9", "lead3x4"])
@pytest.mark.parametrize("with_residual", [False, True],
                         ids=["noresidual", "residual"])
def test_gradients_match_jax_vjp(with_residual, lead):
    """Cotangents on both outputs (normed and h) reach x, residual and
    scale as the JAX custom vjp sends them."""
    (jx, jr, js), (tx, tr, ts) = _data(lead, 64, "f32", seed=1)
    rng = np.random.default_rng(2)
    gn = rng.normal(size=lead + (64,)).astype(np.float32)
    gh = rng.normal(size=lead + (64,)).astype(np.float32)

    if with_residual:
        def jfun(x, r, s):
            return jfn.fused_rmsnorm(x, s, residual=r, impl="fused",
                                     interpret=True)
        _, vjp = jax.vjp(jfun, jx, jr, js)
        want = vjp((jnp.asarray(gn), jnp.asarray(gh)))
    else:
        def jfun(x, s):
            return jfn.fused_rmsnorm(x, s, impl="fused", interpret=True)
        _, vjp = jax.vjp(jfun, jx, js)
        want = vjp((jnp.asarray(gn), jnp.asarray(gh)))
    leaves = [t.clone().requires_grad_(True)
              for t in ((tx, tr, ts) if with_residual else (tx, ts))]
    if with_residual:
        normed, h = tfn.fused_rmsnorm(leaves[0], leaves[2],
                                      residual=leaves[1])
    else:
        normed, h = tfn.fused_rmsnorm(leaves[0], leaves[1])
    got = torch.autograd.grad((normed, h), leaves,
                              (torch.from_numpy(gn), torch.from_numpy(gh)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_gradient_of_normed_alone():
    """Only normed feeds the loss (h unused): the residual variant's h
    cotangent is absent, and the x gradient is the norm's alone."""
    (jx, jr, js), (tx, tr, ts) = _data((5,), 32, "f32", seed=3)
    gn = np.random.default_rng(4).normal(size=(5, 32)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, r, s: jfn.fused_rmsnorm(
        x, s, residual=r, impl="fused", interpret=True)[0], jx, jr, js)
    want = vjp(jnp.asarray(gn))
    leaves = [t.clone().requires_grad_(True) for t in (tx, tr, ts)]
    normed, _ = tfn.fused_rmsnorm(leaves[0], leaves[2], residual=leaves[1])
    got = torch.autograd.grad(normed, leaves, torch.from_numpy(gn))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_shape_errors_and_impl():
    x = torch.zeros((3, 16))
    with pytest.raises(ValueError, match="scale must be"):
        tfn.fused_rmsnorm(x, torch.ones(8))
    with pytest.raises(ValueError, match="residual must match"):
        tfn.fused_rmsnorm(x, torch.ones(16), residual=torch.zeros((2, 16)))
    with pytest.raises(ValueError, match="impl"):
        tfn.fused_rmsnorm(x, torch.ones(16), impl="pallas")
    tfn.reset_launches()
    normed, h = tfn.fused_rmsnorm(x + 1, torch.ones(16), impl="reference")
    assert h.shape == normed.shape == (3, 16)
    # CPU tensors take the plain version: no kernel launches.
    assert tfn.launches == {"fused_norm": 0, "fused_norm_noresidual": 0}


def test_out_dtype_default_promotes():
    x = torch.zeros((2, 8), dtype=torch.bfloat16)
    r = torch.zeros((2, 8))
    normed, h = tfn.fused_rmsnorm(x, torch.ones(8), residual=r)
    assert normed.dtype == h.dtype == torch.float32


def test_cost_at_the_llama_shape():
    cost = tfn.fused_norm_cost((4, 2048, 2048), torch.bfloat16)
    n = 4 * 2048 * 2048
    assert cost["bytes_moved"] == 4 * n * 2 + 2048 * 4
    bare = tfn.fused_norm_cost((4, 2048, 2048), torch.bfloat16,
                               with_residual=False)
    assert bare["bytes_moved"] == 2 * n * 2 + 2048 * 4
    # 0.040 ms and 0.020 ms at 3.35 TB/s.
    assert abs(cost["bytes_moved"] / 3.35e12 * 1e3 - 0.040) < 1e-3
    assert abs(bare["bytes_moved"] / 3.35e12 * 1e3 - 0.020) < 1e-3
