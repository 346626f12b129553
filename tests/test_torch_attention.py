"""The port's attention against the JAX package on the CPU: `mha_reference`
(the flash kernels' plain version, which CPU tensors take), its
autograd gradients and `mha_backward_reference` (the backward kernels'
plain version) against the JAX `flash_attention` run in Pallas
interpret mode and `jax.vjp`, for every variant of the contract.

Tolerance: 1e-5 (f32 on both sides; the Pallas kernels sum blockwise
with an online softmax, the plain version in one pass), at head_dim 16
and, for the Gemma 2 shape of the contract (GQA, softcap, key mask),
head_dim 256; at head_dims 96 and 36, which are no kernel template
width; and at 264 and 512, which the CUDA wrapper gives the wide
kernels. bf16 inputs: see `test_bf16_reference_matches_jax_kernel`.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloud_tpu.ops.attention  # noqa: F401
from cloud_tpu_torch.ops import attention as tatt

# The JAX package re-exports its `attention` function under the module's
# name, so the module is taken from sys.modules.
jatt = sys.modules["cloud_tpu.ops.attention"]

TOL = 1e-5
B, S, H, D = 2, 40, 4, 16

VARIANTS = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "mask": dict(causal=True, mask=True),
    "mask_noncausal": dict(causal=False, mask=True),
    "gqa": dict(causal=True, kv_heads=2),
    "window": dict(causal=True, window=12),
    "window_mask": dict(causal=True, window=6, mask=True),
    "softcap": dict(causal=True, logit_softcap=2.0),
    "softcap_gqa_mask": dict(causal=True, logit_softcap=2.0, kv_heads=2,
                             mask=True),
    "scale": dict(causal=True, sm_scale=0.3),
    # Gemma 2's head_dim, with its softcap and GQA, at a small S.
    "d256_softcap_gqa_mask": dict(causal=True, logit_softcap=2.0,
                                  kv_heads=2, mask=True, head_dim=256,
                                  sm_scale=1 / 16),
    # head_dims that are not a kernel template width: Phi-3-mini's 96, and
    # 36, which the CUDA wrapper sends through a zero-padded copy; the
    # default sm_scale is 1/sqrt(D) of the true D on both sides.
    "d96_window_gqa": dict(causal=True, window=12, kv_heads=2, head_dim=96),
    "d36_mask": dict(causal=True, mask=True, head_dim=36),
    # head_dims past the widest template, which the CUDA wrapper sends to
    # the wide kernels: DeepSeek-V4-Flash's 512 over one KV head, with
    # window, softcap and key mask, and 264.
    "d512_window_softcap_mask_kv1": dict(causal=True, window=12,
                                         logit_softcap=2.0, kv_heads=1,
                                         mask=True, head_dim=512),
    "d264": dict(causal=True, head_dim=264),
}


def _case(variant, seed=0):
    kw = dict(VARIANTS[variant])
    kv_heads = kw.pop("kv_heads", H)
    d = kw.pop("head_dim", D)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, kv_heads, d)).astype(np.float32)
    v = rng.normal(size=(B, S, kv_heads, d)).astype(np.float32)
    g = rng.normal(size=(B, S, H, d)).astype(np.float32)
    if kw.pop("mask", False):
        mask = rng.random((B, S)) < 0.6
        mask[0, :9] = False       # rows 0-8 of example 0: no allowed key
        mask[1] = False           # every row of example 1
        kw["mask"] = mask
    return q, k, v, g, kw


def _jax(q, k, v, g, kw):
    jkw = dict(kw)
    if "mask" in jkw:
        jkw["mask"] = jnp.asarray(jkw["mask"])

    def f(q, k, v):
        # S = 40 with 16-wide blocks: the JAX side pads to 48 and masks.
        return jatt.flash_attention(q, k, v, block_q=16, block_k=16,
                                    interpret=True, **jkw)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(a) for a in (out,) + vjp(jnp.asarray(g))]


def _port(q, k, v, g, kw, fn):
    tkw = dict(kw)
    if "mask" in tkw:
        tkw["mask"] = torch.from_numpy(tkw["mask"])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts, **tkw)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    return [out.detach().numpy()] + [t.numpy() for t in grads]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reference_and_gradients_match_jax_flash(variant):
    q, k, v, g, kw = _case(variant)
    want = _jax(q, k, v, g, kw)
    got = _port(q, k, v, g, kw, tatt.mha_reference)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)
    if "mask" in kw:
        dead = ~kw["mask"][1]
        assert dead.all() and (got[0][1] == 0).all()
        assert (got[1][1] == 0).all()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_backward_reference_matches_jax_grads(variant):
    """The backward kernels' plain version, given delta = rowsum(dO * O)
    from the JAX forward's output, against `jax.vjp` of the JAX flash
    attention."""
    q, k, v, g, kw = _case(variant)
    out, *want = _jax(q, k, v, g, kw)
    tkw = dict(kw)
    if "mask" in tkw:
        tkw["mask"] = torch.from_numpy(tkw["mask"])
    delta = torch.from_numpy((g * out).sum(-1)).transpose(1, 2)
    got = tatt.mha_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v, g)), delta, **tkw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL,
                                   err_msg=name)


# bf16 inputs: the port's plain version forms the logits in f32 from the
# bf16 q and k, as the TPU kernel does (its dot takes
# preferred_element_type=f32), where the JAX package's `mha_reference`
# rounds them to bf16 first. So it is held against the JAX kernel in
# interpret mode, per element: |port - jax| <= 2^-8 |jax| + BF16_ATOL
# rms(row), a row being the D values of one (example, position, head),
# its rms floored at 1e-2 of the tensor's. 2^-8 is the outputs' rounding
# to bf16; the atol covers P rounded to bf16 at other points (the kernel
# rounds exp(s - m) before dividing by l, the plain version the
# normalised weights), which adds up over a row's terms. The least atol
# each comparison needs, over these cases at seeds 4 and 5 and q scaled
# by 1, 4, 8 and 16: the port at most 0.0141 (causal, q x 1); JAX's
# `mha_reference` (bf16-rounded logits) 0.085 to 0.259 at q x 8 and 16
# without a softcap (logits of std 8 and more, whose bf16 rounding moves
# the weights by percents), but only 0.020 at q x 1. BF16_ATOL lies
# between: the "_q8" cases fail the bf16-logit reference
# (`test_bf16_limit_tells_bf16_logits_apart`).
BF16_ATOL = 3e-2
BF16_CASES = {
    # name: (variant, factor on q)
    "causal": ("causal", 1),
    "noncausal": ("noncausal", 1),
    "softcap_gqa_mask": ("softcap_gqa_mask", 1),
    "window_mask": ("window_mask", 1),
    "causal_q8": ("causal", 8),
    "noncausal_q8": ("noncausal", 8),
}


def _bf16_case(name):
    """bf16 q, k, v of the case as numpy f32 arrays, the keyword
    arguments, and the JAX kernel's output in interpret mode (f32)."""
    variant, q_scale = BF16_CASES[name]
    q, k, v, _, kw = _case(variant, seed=4)
    q = q * q_scale
    jkw = dict(kw)
    if "mask" in jkw:
        jkw["mask"] = jnp.asarray(jkw["mask"])
    want = jatt.flash_attention(
        *(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)),
        block_q=16, block_k=16, interpret=True, **jkw)
    assert want.dtype == jnp.bfloat16
    return q, k, v, kw, jkw, np.asarray(want.astype(jnp.float32))


def _bf16_atol_needed(got, want):
    """The least atol (in units of rms(row)) under which `got` passes."""
    rms = np.maximum(np.sqrt((want ** 2).mean(-1, keepdims=True)),
                     1e-2 * np.sqrt((want ** 2).mean()))
    return float(((np.abs(got - want) - 2.0 ** -8 * np.abs(want))
                  / rms).max())


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_reference_matches_jax_kernel(name):
    q, k, v, kw, _, want = _bf16_case(name)
    tkw = dict(kw)
    if "mask" in tkw:
        tkw["mask"] = torch.from_numpy(tkw["mask"])
    got = tatt.mha_reference(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), **tkw)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert _bf16_atol_needed(got, want) <= BF16_ATOL
    if "mask" in kw:
        assert (got[1] == 0).all() and (want[1] == 0).all()


@pytest.mark.parametrize("name", ["causal_q8", "noncausal_q8"])
def test_bf16_limit_tells_bf16_logits_apart(name):
    """The limit above catches the difference it is there for: JAX's
    `mha_reference`, which rounds the logits to bf16, fails it at logits
    of std 8."""
    q, k, v, _, jkw, want = _bf16_case(name)
    rounded = jatt.mha_reference(
        *(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)), **jkw)
    got = np.asarray(rounded.astype(jnp.float32))
    assert _bf16_atol_needed(got, want) > 2 * BF16_ATOL


@pytest.mark.parametrize("fn", ["flash_attention", "attention"])
def test_cpu_tensors_take_the_plain_version(fn):
    q, k, v, g, kw = _case("softcap_gqa_mask", seed=1)
    want = _port(q, k, v, g, kw, tatt.mha_reference)
    before = dict(tatt.launches)
    got = _port(q, k, v, g, kw, getattr(tatt, fn))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tatt.launches == before


def test_argument_errors_match_jax():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tatt.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="identical shapes"):
        tatt.flash_attention(q, q, k)
    with pytest.raises(ValueError, match="requires causal=True"):
        tatt.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="mask must be"):
        tatt.flash_attention(q, q, q, mask=torch.ones((1, 7), dtype=bool))
    with pytest.raises(ValueError, match="Unknown attention impl"):
        tatt.attention(q, q, q, impl="ring")


def test_repeat_kv_matches_jax():
    k = np.random.default_rng(2).normal(size=(2, 5, 2, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tatt.repeat_kv(torch.from_numpy(k), 6).numpy(),
        np.asarray(jatt.repeat_kv(jnp.asarray(k), 6)))


def test_wide_head_dims_take_the_wide_route():
    """The route a CUDA call takes, chosen in Python: up to 256 the
    template kernels by type, above it the wide kernels in both types
    (257 after its zero-padding to 264); none of those head_dims is
    refused, only one past the C interface's field."""
    for dtype, lib in ((torch.bfloat16, "flash_attention"),
                       (torch.float32, "flash_attention_f32")):
        for head_dim in (8, 64, 200, 256):
            assert tatt.kernel_library(dtype, head_dim) == lib
        for head_dim in (264, 320, 512, 576, 1024):
            assert tatt.kernel_library(dtype, head_dim) == \
                "flash_attention_wide"
    for head_dim in (257, 320, 512, 576, tatt.MAX_HEAD_DIM):
        q = torch.zeros((1, 2, 2, head_dim), dtype=torch.bfloat16)
        tatt._check_kernel_operands(q, q, q, None)
    q = torch.zeros((1, 2, 1, tatt.MAX_HEAD_DIM + 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tatt._check_kernel_operands(q, q, q, None)


def test_cost_counts_allowed_pairs():
    """GPT-2 training shape (B 8, S 1024, H 12, D 64, bf16, causal): the
    sizes PERF.md's bounds use."""
    cost = tatt.flash_attention_cost(8, 1024, 12, 12, 64, causal=True)
    pairs = 8 * 12 * 1024 * 1025 / 2
    assert cost["forward"]["flops"] == 4 * pairs * 64
    assert cost["dq"]["flops"] == 6 * pairs * 64
    assert cost["dkdv"]["flops"] == 8 * pairs * 64
    io = 8 * 1024 * 12 * 64 * 2
    assert cost["forward"]["bytes_moved"] == 4 * io + 8 * 12 * 1024 * 4
    assert cost["dkdv"]["bytes_moved"] == 6 * io + 2 * 8 * 12 * 1024 * 4
    assert tatt.allowed_pairs(16, causal=True, window=4) == 4 * 16 - 6
    assert tatt.allowed_pairs(16, causal=False) == 256
    window = tatt.flash_attention_cost(2, 16, 4, 2, 64, window=4)
    assert window["forward"]["flops"] == 4 * 2 * 4 * (4 * 16 - 6) * 64
