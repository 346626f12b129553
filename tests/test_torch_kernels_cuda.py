"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a card. The
file imports no JAX, so it runs on a machine with PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Paged attention tolerance: 2e-2 on bf16 outputs (the kernel and the
plain version sum in another order and round P and the output to bf16 at
other points); rows with no allowed key must be exact zeros. The flash,
fused-norm and fused-MLP kernels' tolerances are stated above their
tests.
"""

import sys

import numpy as np
import pytest
import torch

import cloud_tpu_torch.ops.paged_attention  # noqa: F401

tpa = sys.modules["cloud_tpu_torch.ops.paged_attention"]

TOL = 2e-2


def _inputs(quantized, slots=4, seq=4, pages_per_slot=5, page_size=16,
            heads=3, head_dim=64, seed=0):
    rng = np.random.default_rng(seed)
    num_pages = slots * pages_per_slot + 1
    cache_len = pages_per_slot * page_size
    shape = (num_pages, page_size, heads, head_dim)
    table = (1 + rng.permutation(num_pages - 1)).reshape(
        slots, pages_per_slot).astype(np.int32)
    table[2, :2] = table[0, :2]          # shared pages
    lengths = rng.integers(seq + 1, cache_len + 1, size=slots)
    allowed = (np.arange(cache_len)[None, None, :]
               <= (lengths[:, None] - seq + np.arange(seq))[:, :, None])
    table[1] = 0                         # evicted slot: scratch only
    allowed[1] = False
    dev = torch.device("cuda")
    q = torch.tensor(rng.normal(size=(slots, seq, heads, head_dim)),
                     dtype=torch.bfloat16, device=dev)
    out = dict(q=q, page_table=torch.tensor(table, device=dev),
               allowed=torch.tensor(allowed, device=dev))
    if quantized:
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = rng.uniform(0.01, 0.03, (num_pages, heads)).astype(np.float32)
        vs = rng.uniform(0.01, 0.03, (num_pages, heads)).astype(np.float32)
        ks[table[0, 0]] = vs[table[0, 0]] = 0.0
        out.update(key_pages=torch.tensor(k, device=dev),
                   value_pages=torch.tensor(v, device=dev),
                   key_scales=torch.tensor(ks, device=dev),
                   value_scales=torch.tensor(vs, device=dev))
    else:
        k = rng.normal(size=shape)
        v = rng.normal(size=shape)
        k[0], v[0] = 1e3, -1e3           # scratch garbage, never attended
        out.update(key_pages=torch.tensor(k, dtype=torch.bfloat16,
                                          device=dev),
                   value_pages=torch.tensor(v, dtype=torch.bfloat16,
                                            device=dev))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("seq", [1, 4])
def test_kernel_matches_plain_version(quantized, seq):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inp = _inputs(quantized, seq=seq)
    args = (inp["q"], inp["key_pages"], inp["value_pages"],
            inp["page_table"], inp["allowed"])
    kw = ({"key_scales": inp["key_scales"],
           "value_scales": inp["value_scales"]} if quantized else {})
    name = "paged_attention_int8" if quantized else "paged_attention"
    before = tpa.launches[name]
    out = tpa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launches[name] == before + 1
    ref = tpa.paged_attention_reference(*args, **kw)
    assert out.dtype == ref.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().cpu(), ref.float().cpu(),
                               atol=TOL, rtol=TOL)
    assert (out[1] == 0).all()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inp = _inputs(False, seq=4)
    with pytest.raises(ValueError, match="f32|bf16"):
        tpa.paged_attention(inp["q"].float(), inp["key_pages"],
                            inp["value_pages"], inp["page_table"],
                            inp["allowed"])
    # A K/V row of 36 bf16 values is 72 bytes: no layout makes it a
    # multiple of 16.
    inp = _inputs(False, seq=1, head_dim=36)
    with pytest.raises(ValueError, match="multiple of 16"):
        tpa.paged_attention(inp["q"], inp["key_pages"], inp["value_pages"],
                            inp["page_table"], inp["allowed"])


def _long_cache(quantized, seq, seed=1):
    """The served shape at full depth (slots 8, H 12, D 64, page 16, 64
    pages per slot), where the kernel splits each slot's live pages over
    several blocks: slot 0 fully live; slot 1 a single page; slot 2 a
    full table whose only allowed keys lie in its last page, so its only
    live page falls in its last chunk and the other chunks are empty;
    slot 3 evicted (nothing allowed); the rest random lengths."""
    inp = _inputs(quantized, slots=8, seq=seq, pages_per_slot=64,
                  heads=12, seed=seed)
    allowed = inp["allowed"].cpu().numpy()
    table = inp["page_table"].cpu().numpy()
    cache_len = allowed.shape[-1]
    pos = np.arange(cache_len)
    rows = np.arange(seq)
    allowed[0] = pos[None, :] <= cache_len - seq + rows[:, None]
    allowed[1] = pos[None, :] <= 16 - seq + rows[:, None]
    allowed[2] = (pos[None, :] >= cache_len - 3) & (
        pos[None, :] <= cache_len - seq + rows[:, None])
    allowed[3] = False
    # _inputs evicted slot 1 (scratch-only table); give it slot 3's first
    # page and evict slot 3.
    table[1, 0] = table[3, 0]
    table[1, 1:] = 0                     # unallocated tail: scratch
    table[3] = 0
    dev = torch.device("cuda")
    inp["allowed"] = torch.tensor(allowed, device=dev)
    inp["page_table"] = torch.tensor(table, device=dev)
    return inp


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("seq", [1, 4])
def test_kernel_matches_plain_version_at_long_caches(quantized, seq):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inp = _long_cache(quantized, seq)
    args = (inp["q"], inp["key_pages"], inp["value_pages"],
            inp["page_table"], inp["allowed"])
    kw = ({"key_scales": inp["key_scales"],
           "value_scales": inp["value_scales"]} if quantized else {})
    group, chunks = tpa.plan(8, 12, 64, 16, 64, 1 if quantized else 2,
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    assert chunks > 1
    out = tpa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = tpa.paged_attention_reference(*args, **kw)
    np.testing.assert_allclose(out.float().cpu(), ref.float().cpu(),
                               atol=TOL, rtol=TOL)
    assert (out[3] == 0).all()
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_kernel_takes_any_layout():
    """A non-contiguous q and misaligned pages go to the kernel as
    contiguous copies: the result equals the contiguous call's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inp = _inputs(False, seq=4)
    args = (inp["q"], inp["key_pages"], inp["value_pages"],
            inp["page_table"], inp["allowed"])
    want = tpa.paged_attention(*args)
    q_t = inp["q"].transpose(0, 1).contiguous().transpose(0, 1)
    assert not q_t.is_contiguous()

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        return view

    before = tpa.launches["paged_attention"]
    got = tpa.paged_attention(q_t, shifted(inp["key_pages"]),
                              shifted(inp["value_pages"]),
                              inp["page_table"], inp["allowed"])
    torch.cuda.synchronize()
    assert tpa.launches["paged_attention"] == before + 1
    assert torch.equal(got, want)


# -- flash attention: forward, dq, dk/dv ---------------------------------
#
# Tolerance, element by element, against the plain versions run in f32 on
# the kernels' inputs (the forward: `mha_reference`; dq and dk/dv:
# `mha_backward_reference` given the delta = rowsum(dO O) that the
# backward computes from the forward's output): |kernel - plain| <=
# rtol |plain| + atol rms(row), a row being the D values of one
# (example, position, head), its rms floored at 1e-2 of the tensor's.
# f32: rtol 0, atol 1e-4 (summation order). bf16: rtol 2^-8 (the
# outputs' rounding to bf16), atol 3e-2 (P and dS rounded to bf16 before
# the second product).

FLASH_VARIANTS = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "mask": dict(causal=True, mask=True),
    "window": dict(causal=True, window=16),
    # q x 5: logits of std 5 against the cap of 5, so the cap bends them.
    "softcap": dict(causal=True, logit_softcap=5.0, q_scale=5.0),
}


# (B, S, H, H_kv): S 80 spans a partial second tile; S 300 spans several
# q and key tiles and ends inside one, with examples on both sides of each
# ragged edge; S 40 is below one tile; H 8 over H_kv 1 is a GQA group of 8.
FLASH_SHAPES = {
    "s80": (2, 80, 4, 2),
    "s300": (3, 300, 4, 2),
    "s40": (2, 40, 4, 2),
    "gqa8": (2, 80, 8, 1),
}


def _flash_case(dtype, head_dim, variant, batch=2, seq=80, heads=4,
                kv_heads=2, seed=0):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    kw = dict(FLASH_VARIANTS[variant])

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=dtype,
                            device=dev, requires_grad=True)

    q = t(batch, seq, heads, head_dim, scale=kw.pop("q_scale", 1.0))
    k = t(batch, seq, kv_heads, head_dim)
    v = t(batch, seq, kv_heads, head_dim)
    dout = torch.tensor(rng.normal(size=(batch, seq, heads, head_dim)),
                        dtype=dtype, device=dev)
    if kw.pop("mask", False):
        mask = rng.random((batch, seq)) < 0.7
        mask[0] = False                     # every row of example 0 dead
        kw["mask"] = torch.tensor(mask, device=dev)
    return q, k, v, dout, kw


def _close(got, want, dtype):
    rtol, atol = (0.0, 1e-4) if dtype == torch.float32 else (2.0 ** -8, 3e-2)
    assert got.dtype == dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    rms = torch.clamp(want.square().mean(-1, keepdim=True).sqrt(),
                      min=1e-2 * want.square().mean().sqrt().item())
    err = (got - want).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err),
                        err / (rtol * want.abs() + atol * rms))
    worst = ratio.max().item()
    assert worst <= 1.0, "error {} of the bound (rtol {} + atol {} x row " \
        "rms)".format(worst, rtol, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
@pytest.mark.parametrize("variant", sorted(FLASH_VARIANTS))
@pytest.mark.parametrize("head_dim", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_match_plain_version(dtype, head_dim, variant, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import attention as tatt

    batch, seq, heads, kv_heads = FLASH_SHAPES[shape]
    q, k, v, dout, kw = _flash_case(dtype, head_dim, variant, batch=batch,
                                    seq=seq, heads=heads, kv_heads=kv_heads)
    before = dict(tatt.launches)
    out = tatt.flash_attention(q, k, v, **kw)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkdv"):
        assert tatt.launches[name] == before[name] + 1
    f32 = [x.detach().float() for x in (q, k, v, dout)]
    delta = (f32[3] * out.detach().float()).sum(-1).transpose(1, 2)
    _close(out, tatt.mha_reference(*f32[:3], **kw), dtype)
    grads = tatt.mha_backward_reference(*f32, delta, **kw)
    for got, want in zip((dq, dk, dv), grads):
        _close(got, want, dtype)
    if "mask" in kw:
        assert (out[0] == 0).all() and (dq[0] == 0).all()
        assert (dk[0] == 0).all() and (dv[0] == 0).all()
    assert torch.isfinite(out).all() and torch.isfinite(dq).all()


# head_dims above the widest template run the wide kernels
# (csrc/flash_attention_wide.cu): 264 (a chunk of 128 output columns and a
# slice of 64 score columns each hold 8 real ones), 320, 512 (the public
# deepseek-ai/DeepSeek-V4-Flash head_dim) and 576 (sarvam-105b's), under
# the limits above; "all" puts window, softcap and key mask together.
WIDE_HEAD_DIMS = (264, 320, 512, 576)
WIDE_VARIANTS = dict(FLASH_VARIANTS, all=dict(
    causal=True, mask=True, window=16, logit_softcap=5.0, q_scale=5.0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["s80", "s300", "gqa8"])
@pytest.mark.parametrize("variant", sorted(WIDE_VARIANTS))
@pytest.mark.parametrize("head_dim", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wide_flash_kernels_match_plain_version(dtype, head_dim, variant,
                                                shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import attention as tatt

    batch, seq, heads, kv_heads = FLASH_SHAPES[shape]
    rng = np.random.default_rng(head_dim)
    dev = torch.device("cuda")
    kw = dict(WIDE_VARIANTS[variant])

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=dtype,
                            device=dev, requires_grad=True)

    q = t(batch, seq, heads, head_dim, scale=kw.pop("q_scale", 1.0))
    k = t(batch, seq, kv_heads, head_dim)
    v = t(batch, seq, kv_heads, head_dim)
    dout = torch.tensor(rng.normal(size=(batch, seq, heads, head_dim)),
                        dtype=dtype, device=dev)
    if kw.pop("mask", False):
        mask = rng.random((batch, seq)) < 0.7
        mask[0] = False                     # every row of example 0 dead
        kw["mask"] = torch.tensor(mask, device=dev)
    assert tatt.kernel_library(dtype, head_dim) == "flash_attention_wide"
    before = dict(tatt.launches)
    out = tatt.flash_attention(q, k, v, **kw)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkdv"):
        assert tatt.launches[name] == before[name] + 1
    f32 = [x.detach().float() for x in (q, k, v, dout)]
    delta = (f32[3] * out.detach().float()).sum(-1).transpose(1, 2)
    _close(out, tatt.mha_reference(*f32[:3], **kw), dtype)
    grads = tatt.mha_backward_reference(*f32, delta, **kw)
    for got, want in zip((dq, dk, dv), grads):
        _close(got, want, dtype)
    if "mask" in kw:
        assert (out[0] == 0).all() and (dq[0] == 0).all()
        assert (dk[0] == 0).all() and (dv[0] == 0).all()
    assert torch.isfinite(out).all() and torch.isfinite(dq).all()


# head_dims other than the template widths: multiples of 8 below each
# width (8 and 32 at 64; 72, 80 (phi-2) and 96 (Phi-3-mini) at 128; 136,
# whose fourth box of 64 columns lies wholly past D, and 200 at 256), and
# 36 and 100, which go through the copy zero-padded to a multiple of 8.
ANY_HEAD_DIMS = (8, 32, 36, 72, 80, 96, 100, 136, 200)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["causal", "mask", "softcap"])
@pytest.mark.parametrize("head_dim", ANY_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_at_any_head_dim(dtype, head_dim, variant):
    """The three kernels at a head_dim that is not a template width, on
    the true-D tensors, against the plain versions at that D (default
    sm_scale 1/sqrt(D)), under the limits above; the outputs have D
    columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import attention as tatt

    q, k, v, dout, kw = _flash_case(dtype, head_dim, variant, batch=2,
                                    seq=80, heads=4, kv_heads=2)
    before = dict(tatt.launches)
    out = tatt.flash_attention(q, k, v, **kw)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkdv"):
        assert tatt.launches[name] == before[name] + 1
    assert out.shape == q.shape and dq.shape == q.shape
    assert dk.shape == k.shape and dv.shape == v.shape
    f32 = [x.detach().float() for x in (q, k, v, dout)]
    delta = (f32[3] * out.detach().float()).sum(-1).transpose(1, 2)
    _close(out, tatt.mha_reference(*f32[:3], **kw), dtype)
    grads = tatt.mha_backward_reference(*f32, delta, **kw)
    for got, want in zip((dq, dk, dv), grads):
        _close(got, want, dtype)


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import attention as tatt

    dev = torch.device("cuda")
    # Any head_dim runs: up to 256 on the template kernels
    # (test_flash_kernels_at_any_head_dim), past it on the wide kernels
    # (test_wide_flash_kernels_match_plain_version), 257 through the
    # zero-padded copy; past the C interface's 16-bit field it raises.
    for head_dim in (257, 320):
        q = torch.zeros((1, 8, 2, head_dim), dtype=torch.bfloat16,
                        device=dev)
        before = tatt.launches["flash_attention_fwd"]
        out = tatt.flash_attention(q, q, q)
        torch.cuda.synchronize()
        assert tatt.launches["flash_attention_fwd"] == before + 1
        assert out.shape == q.shape and (out == 0).all()
    q = torch.zeros((1, 2, 1, tatt.MAX_HEAD_DIM + 1), dtype=torch.bfloat16,
                    device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        tatt.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="device"):
        tatt.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="CPU or CUDA|device"):
        tatt.flash_attention(q.cpu(), q, q)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        tatt.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="reference"):
        tatt.attention(q, q, q, impl="reference")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_take_any_layout(dtype):
    """q as a transposed view, k and v at misaligned bases and a
    non-contiguous dO go to the kernels as contiguous copies: out and the
    gradients equal those of the contiguous call, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import attention as tatt

    q, k, v, dout, kw = _flash_case(dtype, 64, "causal", batch=2, seq=80,
                                    heads=4, kv_heads=2)
    out = tatt.flash_attention(q, k, v, **kw)
    want = (out,) + torch.autograd.grad(out, (q, k, v), dout)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t.detach())
        assert view.data_ptr() % 16
        return view.requires_grad_(True)

    q_t = q.detach().transpose(1, 2).contiguous().transpose(1, 2)
    q_t.requires_grad_(True)
    k_s, v_s = shifted(k), shifted(v)
    dout_t = dout.transpose(1, 2).contiguous().transpose(1, 2)
    assert not q_t.is_contiguous() and not dout_t.is_contiguous()
    before = dict(tatt.launches)
    out = tatt.flash_attention(q_t, k_s, v_s, **kw)
    got = (out,) + torch.autograd.grad(out, (q_t, k_s, v_s), dout_t)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkdv"):
        assert tatt.launches[name] == before[name] + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- fused RMSNorm (+ residual) -------------------------------------------
#
# Tolerance against `rmsnorm_residual_reference` on the same inputs: h bit
# for bit (the same add, rounded once); normed per element within 2^-7
# of |plain| for a bf16 output (the f32 statistics sum in another order
# and rsqrtf differs from torch.rsqrt in the last bits, which can move a
# value to the next bf16 step, 2^-8 to 2^-7 of it) or 1e-5 for an f32
# output, plus 1e-6 absolute.


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["same", "other"])
@pytest.mark.parametrize("rows", [1, 37, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("residual", [False, True],
                         ids=["noresidual", "residual"])
def test_fused_norm_kernel_matches_plain_version(residual, dtype, rows, out):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import fused_norm as tfn

    rng = np.random.default_rng(rows)
    dev = torch.device("cuda")
    x = torch.tensor(rng.normal(size=(rows, 264)), dtype=dtype, device=dev)
    r = torch.tensor(rng.normal(size=(rows, 264)), dtype=dtype, device=dev)
    scale = torch.tensor(rng.normal(size=264) * 0.1 + 1, dtype=torch.float32,
                         device=dev)
    out_dtype = dtype if out == "same" else (
        torch.float32 if dtype == torch.bfloat16 else torch.bfloat16)
    name = "fused_norm" if residual else "fused_norm_noresidual"
    before = tfn.launches[name]
    normed, h = tfn.fused_rmsnorm(x, scale, residual=r if residual else None,
                                  eps=1e-5, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tfn.launches[name] == before + 1
    want, want_h = tfn.rmsnorm_residual_reference(
        x, scale, residual=r if residual else None, eps=1e-5,
        out_dtype=out_dtype)
    assert normed.dtype == out_dtype and torch.equal(h, want_h)
    rtol = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(normed.float().cpu(), want.float().cpu(),
                               rtol=rtol, atol=1e-6)


@pytest.mark.cuda
def test_fused_norm_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import fused_norm as tfn

    dev = torch.device("cuda")
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=dev)
    scale = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="reference"):
        tfn.fused_rmsnorm(x, scale, impl="reference")
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        tfn.fused_rmsnorm(x.half(), scale)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        tfn.fused_rmsnorm(x, scale, residual=x.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        tfn.fused_rmsnorm(torch.zeros((4, 60), device=dev),
                          torch.ones(60, device=dev))
    with pytest.raises(ValueError, match="device"):
        tfn.fused_rmsnorm(x, scale.cpu())


# -- fused SwiGLU (gate|up, then down) ------------------------------------
#
# Tolerance, per element, against the plain computation in f32 on the same
# compute-dtype inputs with the kernels' rounding points (g, u, act(g) and
# act(g) * u rounded to the compute dtype): |kernel - plain| <= rtol
# |plain| + atol rms(row). bf16: rtol 2^-8 (the output's rounding), atol
# 1e-2 (an element of the intermediate next to a rounding boundary may
# round the other way after f32 sums in another order; one such step moves
# an output by ~2^-8 / sqrt(d_ff) of its row's rms). f32: rtol 1e-5, atol
# 1e-5 (summation order).


def _close_rows(got, want, rtol, atol):
    got, want = got.float(), want.float()
    rms = torch.clamp(want.square().mean(-1, keepdim=True).sqrt(),
                      min=1e-2 * want.square().mean().sqrt().item())
    err = (got - want).abs()
    worst = (err / (rtol * want.abs() + atol * rms)).max().item()
    assert worst <= 1.0, "error {} of the bound".format(worst)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ["silu", "gelu_tanh", "gelu"])
# D and d_ff are not multiples of the tiles: ragged N and K. Rows 300, D
# 520, d_ff 1352 span more than one bf16 tile (128 rows x 256 weight rows
# x 64 deep) in every dimension, with tails in each (K: 520 = 8 x 64 + 8).
@pytest.mark.parametrize("rows,d,f", [
    pytest.param(1, 136, 328, id="1"),
    pytest.param(8, 136, 328, id="8"),
    pytest.param(200, 136, 328, id="200"),
    pytest.param(300, 520, 1352, id="300"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_mlp_kernels_match_plain_version(dtype, rows, d, f,
                                               activation):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import fused_mlp as tfm

    rng = np.random.default_rng(rows)
    dev = torch.device("cuda")
    x = torch.tensor(rng.normal(size=(rows, d)), dtype=dtype, device=dev)
    wg = torch.tensor(rng.normal(size=(f, d)) / np.sqrt(d), dtype=dtype,
                      device=dev)
    wu = torch.tensor(rng.normal(size=(f, d)) / np.sqrt(d), dtype=dtype,
                      device=dev)
    wd = torch.tensor(rng.normal(size=(d, f)) / np.sqrt(f), dtype=dtype,
                      device=dev)
    before = dict(tfm.launches)
    y = tfm.fused_swiglu(x, wg, wu, wd, activation=activation)
    a = tfm.launch_gate_up(x, wg, wu, activation)
    torch.cuda.synchronize()
    assert tfm.launches["fused_mlp_gate_up"] == \
        before["fused_mlp_gate_up"] + 2
    assert tfm.launches["fused_mlp_down"] == before["fused_mlp_down"] + 1
    want_a, want_y = tfm.swiglu_rounded_reference(x, wg, wu, wd, activation)
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2.0 ** -8,
                                                              1e-2)
    assert y.dtype == dtype and y.shape == (rows, d)
    _close_rows(y, want_y, rtol, atol)
    # The intermediate: g or u rounded the other way moves it by one bf16
    # step of g or u (up to 2^-7), which the activation's slope can double
    # and more on its negative side.
    _close_rows(a, want_a, 1e-5 if dtype == torch.float32 else 2.0 ** -5,
                atol)


@pytest.mark.cuda
def test_fused_mlp_wrapper_rejects_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import fused_mlp as tfm

    dev = torch.device("cuda")
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((96, 64), dtype=torch.bfloat16, device=dev)
    wd = torch.zeros((64, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="reference"):
        tfm.fused_swiglu(x, w, w, wd, impl="reference")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfm.fused_swiglu(x.half(), w.half(), w.half(), wd.half())
    with pytest.raises(ValueError, match="multiples of 8"):
        tfm.fused_swiglu(x, w[:90], w[:90], wd[:, :90])
    with pytest.raises(ValueError, match="device"):
        tfm.fused_swiglu(x, w.cpu(), w, wd)
    # The launchers themselves take only what TMA can address: refused
    # before any launch.
    before = dict(tfm.launches)
    shifted = torch.zeros(4 * 64 + 1, dtype=torch.bfloat16,
                          device=dev)[1:].view(4, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tfm.launch_gate_up(shifted, w, w, "silu")
    assert tfm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_mlp_takes_any_layout(dtype):
    """x at a misaligned base and transposed views of the weights go to
    the kernels as contiguous copies: y equals the contiguous call's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import fused_mlp as tfm

    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    rows, d, f = 200, 136, 328
    x = torch.tensor(rng.normal(size=(rows, d)), dtype=dtype, device=dev)
    wg = torch.tensor(rng.normal(size=(f, d)) / np.sqrt(d), dtype=dtype,
                      device=dev)
    wu = torch.tensor(rng.normal(size=(f, d)) / np.sqrt(d), dtype=dtype,
                      device=dev)
    wd = torch.tensor(rng.normal(size=(d, f)) / np.sqrt(f), dtype=dtype,
                      device=dev)
    want = tfm.fused_swiglu(x, wg, wu, wd)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    x_s = flat[1:].view(rows, d)
    x_s.copy_(x)
    assert x_s.data_ptr() % 16
    wg_t, wu_t, wd_t = (w.T.contiguous().T for w in (wg, wu, wd))
    assert not wg_t.is_contiguous()
    before = dict(tfm.launches)
    got = tfm.fused_swiglu(x_s, wg_t, wu_t, wd_t)
    torch.cuda.synchronize()
    assert tfm.launches["fused_mlp_gate_up"] == \
        before["fused_mlp_gate_up"] + 1
    assert torch.equal(got, want)


# -- decode shapes --------------------------------------------------------
#
# The fused norm and the fused SwiGLU at the row counts of a decode step
# (rows = batch) at TinyLlama-1.1B's widths (D 2048, d_ff 5632), under the
# limits of their tests above.


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_norm_and_mlp_kernels_at_decode_rows(dtype, rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import fused_mlp as tfm
    from cloud_tpu_torch.ops import fused_norm as tfn

    rng = np.random.default_rng(rows)
    dev = torch.device("cuda")
    d, f = 2048, 5632

    def t(*shape, scale=1.0, dt=dtype):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=dt,
                            device=dev)

    x, r = t(rows, d), t(rows, d)
    scale = t(d, scale=0.1, dt=torch.float32) + 1
    before = dict(tfn.launches)
    normed, h = tfn.fused_rmsnorm(x, scale, residual=r, eps=1e-5)
    alone, _ = tfn.fused_rmsnorm(x, scale, eps=1e-5)
    wg, wu = t(f, d, scale=d ** -0.5), t(f, d, scale=d ** -0.5)
    wd = t(d, f, scale=f ** -0.5)
    before_mlp = dict(tfm.launches)
    y = tfm.fused_swiglu(normed, wg, wu, wd)
    torch.cuda.synchronize()
    assert tfn.launches["fused_norm"] == before["fused_norm"] + 1
    assert tfn.launches["fused_norm_noresidual"] == \
        before["fused_norm_noresidual"] + 1
    assert tfm.launches["fused_mlp_gate_up"] == \
        before_mlp["fused_mlp_gate_up"] + 1
    assert tfm.launches["fused_mlp_down"] == before_mlp["fused_mlp_down"] + 1
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for got, residual in ((normed, r), (alone, None)):
        want, want_h = tfn.rmsnorm_residual_reference(
            x, scale, residual=residual, eps=1e-5)
        np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                                   rtol=rtol, atol=1e-6)
    assert torch.equal(h, x + r)
    _, want_y = tfm.swiglu_rounded_reference(normed, wg, wu, wd, "silu")
    _close_rows(y, want_y, *((1e-5, 1e-5) if dtype == torch.float32
                             else (2.0 ** -8, 1e-2)))


@pytest.mark.cuda
def test_llama_decode_on_the_card():
    """A 2-layer `LlamaLM` at head_dim 96 (f32): its decode logits on the
    card (the fused norm and MLP kernels; the plain grouped attention)
    match its training forward there (the flash kernels at D 96) within
    1e-4 (f32 sums in another order), and its greedy `generate()` equals
    the same model's on the CPU (the plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.models import LlamaLM, generate
    from cloud_tpu_torch.ops import attention as tatt
    from cloud_tpu_torch.ops import fused_mlp as tfm
    from cloud_tpu_torch.ops import fused_norm as tfn

    cfg = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
               d_model=128, d_ff=344, head_dim=96, max_seq_len=128,
               rope_style="rotate_half", compute_dtype=torch.float32)
    card = LlamaLM(device="cuda", seed=1, **cfg)
    cpu = LlamaLM(device="cpu", seed=1, **cfg)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, size=(3, 40)))
    before = dict(tatt.launches)
    with torch.no_grad():
        full = card(tokens.cuda())
    assert tatt.launches["flash_attention_fwd"] == \
        before["flash_attention_fwd"] + 2
    cache = card.init_cache(3)
    norm0, mlp0 = dict(tfn.launches), dict(tfm.launches)
    parts = [card(tokens[:, :30].cuda(), None, cache)]
    parts += [card(tokens[:, i:i + 1].cuda(), None, cache)
              for i in range(30, 40)]
    torch.cuda.synchronize()
    assert tfm.launches["fused_mlp_down"] == mlp0["fused_mlp_down"] + 2 * 11
    assert tfn.launches["fused_norm"] == norm0["fused_norm"] + 2 * 11
    np.testing.assert_allclose(torch.cat(parts, 1).cpu(), full.cpu(),
                               rtol=1e-4, atol=1e-4)
    before = dict(tatt.launches)
    got = generate(card, tokens[:, :20], 12, temperature=0.0)
    assert tatt.launches == before  # generation reaches no flash kernel
    want = generate(cpu, tokens[:, :20], 12, temperature=0.0)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_moe_llama_step_and_decode_on_the_card():
    """A 2-layer MoE `LlamaLM` (8 experts of width 64, top 2, q/k norms,
    f32, capacity factor 1.0, which binds): one training step's logits,
    aux losses and gradients on the card (the flash and norm kernels;
    the experts by sorted dispatch) match the same step on the CPU (the
    plain versions) within 1e-4 (f32 sums in another order; the routes
    must agree for that), and its drop-free greedy `generate()` on the
    card equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.models import LlamaLM, generate
    from cloud_tpu_torch.ops import attention as tatt
    from cloud_tpu_torch.ops import fused_norm as tfn

    cfg = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
               d_model=128, d_ff=64, head_dim=32, max_seq_len=128,
               rope_style="rotate_half", qk_norm=True, moe_experts=8,
               moe_top_k=2, moe_capacity_factor=1.0,
               compute_dtype=torch.float32)
    card = LlamaLM(device="cuda", seed=1, **cfg)
    cpu = LlamaLM(device="cpu", seed=1, **cfg)
    with torch.no_grad():
        for model in (card, cpu):
            for block in model.blocks:
                block.moe.router.mul_(20.0)   # routes far from uniform
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, size=(3, 40)))
    labels = torch.roll(tokens, -1, 1)
    results = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        before = dict(tatt.launches)
        logits = model(tokens.to(dev))
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 256), labels.to(dev).reshape(-1)) \
            + 0.01 * sum(model.aux_losses)
        loss.backward()
        launched = tatt.launches["flash_attention_dkdv"] - \
            before["flash_attention_dkdv"]
        assert launched == (2 if dev == "cuda" else 0)
        results.append((logits.detach().cpu(),
                        [a.item() for a in model.aux_losses],
                        {n: p.grad.cpu() for n, p in
                         model.named_parameters()}))
    (lc, ac, gc), (lp, ap, gp) = results
    np.testing.assert_allclose(lc, lp, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ac, ap, rtol=1e-4)
    assert all(a > 2.0 for a in ac)   # capacity binds: load is uneven
    for name in gp:
        np.testing.assert_allclose(gc[name], gp[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    for model in (card, cpu):
        model.moe_capacity_factor = None
        for block in model.blocks:
            block.moe.capacity_factor = None
    norm0 = tfn.launches["fused_norm"]
    got = generate(card, tokens[:, :20], 12, temperature=0.0)
    assert tfn.launches["fused_norm"] == norm0 + 2 * 12
    want = generate(cpu, tokens[:, :20], 12, temperature=0.0)
    assert torch.equal(got, want)


# -- the training loop on the card ---------------------------------------
#
# lm_head_loss on CUDA tensors against its plain version (the materialised
# f32 logits) on the same values: f32 within 1e-5 (summation order; TF32
# stays off, PyTorch's default); on bf16 inputs the loss within 1e-5
# relative + 1e-4 of its rms (f32 in both) and dh, dW within 2^-8
# relative + 1e-3 rms(row) (their final rounding to bf16).


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_head_loss_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.ops import fused_ce

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d, v = 512, 256, 5003
    h = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    w = (0.05 * torch.randn(d, v, generator=gen, device="cuda")).to(dtype)
    y = torch.randint(0, v, (n,), generator=gen, device="cuda")
    y[::17] = -1
    y[3] = v

    def run(fn, cast):
        hh = cast(h).detach().requires_grad_()
        ww = cast(w).detach().requires_grad_()
        loss = fn(hh, ww)
        return (loss,) + torch.autograd.grad(loss.sum(), (hh, ww))

    got = run(lambda a, b: fused_ce.lm_head_loss(a, b, y, chunk=1024),
              lambda t: t)
    want = run(lambda a, b: fused_ce.lm_head_loss_reference(a, b, y),
               lambda t: t.float())
    assert got[0].dtype == torch.float32 and got[1].dtype == dtype
    ignored = (y < 0) | (y >= v)
    assert (got[0][ignored] == 0).all() and (got[1][ignored] == 0).all()
    if dtype == torch.float32:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().cpu(), b.detach().cpu(),
                                       rtol=1e-5,
                                       atol=1e-5)
    else:
        _close_rows(got[0][None], want[0][None], 1e-5, 1e-4)
        _close_rows(got[1], want[1], 2.0 ** -8, 1e-3)
        _close_rows(got[2], want[2], 2.0 ** -8, 1e-3)


@pytest.mark.cuda
def test_checkpoint_round_trip_of_card_tensors(tmp_path):
    """An async save of CUDA tensors returns with a host snapshot (an
    in-place update after it does not reach the file); restore puts the
    values back on the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.training import checkpoint as ckpt

    gen = torch.Generator(device="cuda").manual_seed(1)
    state = {"w": torch.randn(300, 70, generator=gen, device="cuda"),
             "b": torch.randn(70, generator=gen, device="cuda").bfloat16(),
             "step": 9}
    want = {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in state.items()}
    ckpt.save(str(tmp_path), state, step=9, use_async=True)
    state["w"].add_(1.0)
    ckpt.wait_until_finished()
    target = {"w": torch.zeros(300, 70, device="cuda"),
              "b": torch.zeros(70, device="cuda", dtype=torch.bfloat16),
              "step": 0}
    got = ckpt.restore(str(tmp_path), target)
    assert got["step"] == 9 and got["w"].is_cuda
    assert torch.equal(got["w"], want["w"]) and torch.equal(got["b"],
                                                            want["b"])


@pytest.mark.cuda
def test_llama_resume_is_bitwise_on_the_card(tmp_path):
    """A 2-layer bf16 `LlamaLM` (flash, fused norm and fused MLP
    kernels) preempted before step 6 of 12 and resumed under
    `fit(resume="auto")` ends bit for bit where the uninterrupted fit
    does, EMA shadow included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cloud_tpu_torch.analysis import chaos
    from cloud_tpu_torch.models import LlamaLM
    from cloud_tpu_torch.training import Trainer, resilience

    cfg = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
               d_model=256, d_ff=688, max_seq_len=128,
               compute_dtype=torch.bfloat16)
    tokens = np.random.default_rng(5).integers(0, 256, size=(16, 65))
    x, y = tokens[:, :-1], tokens[:, 1:]

    def fit(**kw):
        model = LlamaLM(device="cuda", seed=2, **cfg)
        trainer = Trainer(model, optimizer="adamw", seed=1, ema_decay=0.9)
        trainer.fit(x, y, epochs=3, batch_size=4, verbose=False, **kw)
        return trainer

    clean = fit()
    chaos.install("preempt@6")
    try:
        resumed = fit(resume="auto", retries=1,
                      resume_from=str(tmp_path / "ckpt"))
    finally:
        chaos.uninstall()
    assert resilience.guard_stats()["resumes"] >= 1
    assert resumed.state.step == clean.state.step == 12
    for (name, a), (_, b) in zip(clean.model.named_parameters(),
                                 resumed.model.named_parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(clean.ema_params[name],
                           resumed.ema_params[name]), name


# -- the image slice on the card ------------------------------------------
#
# Tolerances: a small ResNet step in bf16 against the same step in f32
# (TF32 off in cuBLAS and cuDNN): the loss within 2e-2 relative and each
# gradient norm within 5e-2 relative of the f32 one, or 1e-3 of the
# largest norm (bf16 rounds every activation to 2^-9 over a few layers);
# the spe CUDA graph against the eager loop and remat against the plain
# step, cuDNN in its deterministic algorithms: bit for bit; flash at S
# 197, non-causal, against mha_reference in f32: 2e-2 of each tensor's
# largest magnitude in bf16.


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _image_data(n, size, classes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    y = (np.arange(n) % classes).astype(np.int32)
    x += np.linspace(-1, 1, classes)[y][:, None, None, None].astype(
        np.float32)
    return x, y


def _small_resnet(dtype, device, seed=0):
    from cloud_tpu_torch.models import resnet as tresnet

    return tresnet.ResNet(stage_sizes=(1, 1), num_classes=5, num_filters=16,
                          compute_dtype=dtype, device=device, seed=seed)


def _grads_of_one_step(model, x, y):
    import torch.nn.functional as F

    model.zero_grad(set_to_none=True)
    logits = model(torch.tensor(x, device="cuda"), train=True)
    loss = F.cross_entropy(logits, torch.tensor(y, device="cuda").long())
    loss.backward()
    return loss.item(), {n: p.grad.float().norm().item()
                         for n, p in model.named_parameters()}


@pytest.mark.cuda
def test_small_resnet_step_bf16_against_f32():
    dev = _card()
    x, y = _image_data(16, 32, 5)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        lo_model = _small_resnet(torch.bfloat16, dev)
        hi_model = _small_resnet(torch.float32, dev)
        hi_model.load_state_dict(lo_model.state_dict())
        loss_lo, norms_lo = _grads_of_one_step(lo_model, x, y)
        loss_hi, norms_hi = _grads_of_one_step(hi_model, x, y)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    assert abs(loss_lo - loss_hi) <= 2e-2 * abs(loss_hi)
    top = max(norms_hi.values())
    for name, want in norms_hi.items():
        assert abs(norms_lo[name] - want) <= 5e-2 * want + 1e-3 * top, name
    # The running statistics moved by flax's rule, in f32.
    for mod in (lo_model.bn_init, hi_model.bn_init):
        assert mod.running_mean.dtype == torch.float32
        assert not torch.equal(mod.running_var,
                               torch.ones_like(mod.running_var))


def _fit_state(trainer, x, y, **kw):
    history = trainer.fit(x, y, verbose=False, **kw)
    torch.cuda.synchronize()
    return history, {k: v.detach().clone()
                     for k, v in trainer.model.state_dict().items()}


def _trainer_for(kind, spe, dev, remat=False):
    from cloud_tpu_torch.models import ViT
    from cloud_tpu_torch.models import mnist as tmnist
    from cloud_tpu_torch.training import trainer as ttrainer

    if kind == "mlp":
        model = tmnist.MLP(hidden=64, device=dev, seed=1)
        opt = lambda p: torch.optim.Adam(p, lr=1e-3, capturable=True)
        kw = {}
    elif kind == "resnet":
        model = _small_resnet(torch.bfloat16, dev, seed=1)
        opt = ttrainer.make_optimizer("sgd", 0.1)
        kw = dict(train_kwargs={"train": True}, eval_kwargs={"train": False})
    else:
        model = ViT(num_classes=5, patch_size=4, num_layers=2, num_heads=2,
                    d_model=64, d_ff=128, image_size=28, device=dev, seed=1)
        opt = ttrainer.make_optimizer(
            "lamb", ttrainer_schedule(1e-3))
        kw = dict(train_kwargs={"train": True})
    return ttrainer.Trainer(model, optimizer=opt, seed=0, remat=remat,
                            steps_per_execution=spe, **kw)


def ttrainer_schedule(peak):
    from cloud_tpu_torch.training import schedules

    return schedules.warmup_cosine(peak, 12, warmup_steps=3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlp", "resnet", "vit"])
@pytest.mark.parametrize("cache", [None, "device"])
def test_spe_graph_bit_equal_to_the_loop(kind, cache):
    from cloud_tpu_torch.training import trainer as ttrainer

    dev = _card()
    torch.backends.cudnn.deterministic = True
    try:
        if kind == "mlp":
            x, y = _image_data(96, 28, 5)
            x = x[..., 0]
        else:
            x, y = _image_data(48, 28 if kind == "vit" else 16, 5)
        loop = _trainer_for(kind, 1, dev)
        graph = _trainer_for(kind, 4, dev)
        captures = ttrainer.graph_captures()
        kw = dict(epochs=2, batch_size=8, cache=cache)
        h1, s1 = _fit_state(loop, x, y, **kw)
        h4, s4 = _fit_state(graph, x, y, **kw)
    finally:
        torch.backends.cudnn.deterministic = False
    assert graph._spe_route == "graph"
    assert ttrainer.graph_captures() == captures + 1
    assert h1["loss"] == h4["loss"]
    for key in s1:
        assert torch.equal(s1[key], s4[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("cast", ["bfloat16", "uint8"])
def test_spe_graph_takes_a_new_upload(cast):
    # Two resident fits over arrays refilled in place between them. The
    # bf16 copy keeps its geometry and key: the one graph takes the new
    # upload. The uint8 cast's lo and scale move with the data and are
    # constants in the graph: a second capture. Both train as the loop.
    from cloud_tpu_torch.training import trainer as ttrainer

    dev = _card()
    x, y = _image_data(48, 16, 5)
    loop = _trainer_for("resnet", 1, dev)
    graph = _trainer_for("resnet", 4, dev)
    kw = dict(epochs=1, batch_size=8, cache="device", input_cast=cast)
    captures = ttrainer.graph_captures()
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):
            runs.append((_fit_state(loop, x, y, **kw),
                         _fit_state(graph, x, y, **kw)))
            x *= -2.0
    finally:
        torch.backends.cudnn.deterministic = False
    assert ttrainer.graph_captures() == captures + (
        1 if cast == "bfloat16" else 2)
    for (h1, s1), (h4, s4) in runs:
        assert h1["loss"] == h4["loss"]
        for key in s1:
            assert torch.equal(s1[key], s4[key]), key


class _Noisy(torch.nn.Module):
    """Draws a keep mask from its generator, its rate under another name
    than `dropout_rate`."""

    def __init__(self, device):
        super().__init__()
        self.dense = torch.nn.Linear(16 * 16 * 3, 5, device=device)
        self.keep = 0.9

    def forward(self, x, generator=None):
        h = x.reshape(x.shape[0], -1)
        if generator is not None:
            mask = torch.rand(h.shape, generator=generator, device=h.device)
            h = h * (mask < self.keep) / self.keep
        return self.dense(h)


@pytest.mark.cuda
def test_spe_refuses_a_step_it_cannot_capture():
    from cloud_tpu_torch.models import ViT
    from cloud_tpu_torch.training import trainer as ttrainer

    dev = _card()
    sgd = ttrainer.make_optimizer("sgd", 0.1)
    for kw, match in ((dict(optimizer=sgd, gradient_accumulation_steps=2),
                       "accumulation"),
                      (dict(optimizer=ttrainer.make_optimizer(
                          "sgd", ttrainer_schedule(0.1))), "SGD")):
        trainer = ttrainer.Trainer(
            _small_resnet(torch.float32, dev), steps_per_execution=2,
            train_kwargs={"train": True}, **kw)
        with pytest.raises(ValueError, match=match):
            trainer.build()
    x, y = _image_data(32, 16, 5)
    vit = ViT(num_classes=5, patch_size=4, num_layers=1, num_heads=2,
              d_model=32, d_ff=64, image_size=16, dropout_rate=0.1,
              device=dev, seed=1)
    for model, train_kwargs in ((vit, {"train": True}), (_Noisy(dev), {})):
        trainer = ttrainer.Trainer(model, optimizer=sgd,
                                   steps_per_execution=2,
                                   train_kwargs=train_kwargs)
        with pytest.raises(ValueError, match="draws dropout"):
            trainer.fit(x, y, epochs=1, batch_size=8, verbose=False)
        assert trainer.state.step == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["resnet", "vit"])
def test_remat_bit_equal_to_plain_on_the_card(kind):
    dev = _card()
    x, y = _image_data(32, 28 if kind == "vit" else 16, 5)
    torch.backends.cudnn.deterministic = True
    try:
        states = [_fit_state(_trainer_for(kind, 1, dev, remat=remat), x, y,
                             epochs=1, batch_size=8)[1]
                  for remat in (False, True)]
    finally:
        torch.backends.cudnn.deterministic = False
    for key in states[0]:
        assert torch.equal(states[0][key], states[1][key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_flash_at_vit_length_non_causal(batch):
    from cloud_tpu_torch.ops import attention as tatt

    dev = _card()
    rng = np.random.default_rng(7)
    q, k, v, dout = (torch.tensor(rng.normal(size=(batch, 197, 12, 64)),
                                  dtype=torch.bfloat16, device=dev)
                     for _ in range(4))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    before = dict(tatt.launches)
    out = tatt.attention(*leaves, causal=False)
    grads = torch.autograd.grad(out, leaves, dout)
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkdv"):
        assert tatt.launches[name] == before[name] + 1
    f32 = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref = tatt.mha_reference(*f32, causal=False)
    ref_grads = torch.autograd.grad(ref, f32, dout.float())
    for got, want in zip((out,) + grads, (ref,) + ref_grads):
        err = (got.float() - want).abs().max().item()
        assert err <= 2e-2 * want.abs().max().item()


@pytest.mark.cuda
def test_resident_gather_order_on_the_card():
    from cloud_tpu_torch.training import data as tdata

    dev = _card()
    x, y = _image_data(40, 4, 3)
    ds = tdata.ArrayDataset(x, y, batch_size=8, shuffle=True, seed=9)
    res = tdata.DeviceResidentDataset(ds, input_cast="uint8", device=dev)
    for epoch in range(3):
        order = res.epoch_order(epoch)
        np.testing.assert_array_equal(
            order.cpu().numpy(), tdata.epoch_permutation(40, 9, epoch))
        for step, (xb, yb) in enumerate(ds):
            gx, gy = res.gather(order[step * 8:(step + 1) * 8])
            np.testing.assert_array_equal(
                res.policy.widen(gx).cpu().numpy(),
                res.policy.widen(res.policy.host_cast(xb)).numpy())
            np.testing.assert_array_equal(gy.cpu().numpy(), yb)


# -- serving's fixed-shape path: the tick and the prefills as CUDA graphs --

_SERVE_CFG = dict(vocab_size=256, num_layers=2, num_heads=4, d_model=64,
                  d_ff=128, max_seq_len=128)
_GREEDY = dict(temperature=0.0, top_k=None, top_p=None, eos_token=None)


def _serve_model(dev):
    from cloud_tpu_torch.models import TransformerLM

    return TransformerLM(compute_dtype=torch.bfloat16, device=dev, seed=3,
                         **_SERVE_CFG)


def _engine_pair(model, kv_dtype, slots=4, page=16):
    from cloud_tpu_torch.serving.engine import DecodeEngine

    pps = model.max_seq_len // page
    return [DecodeEngine(model, slots, page, slots * pps + 1,
                         page_dtype=kv_dtype, graphs=graphs)
            for graphs in (None, False)]


def _same_prefill(a, b):
    return a.first_token == b.first_token and all(
        torch.equal(a.pcache["store"][k], b.pcache["store"][k])
        for k in a.pcache["store"])


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["bf16", "int8"])
def test_replayed_tick_equals_eager_tick(kv_dtype):
    """30 ticks of an engine replaying its tick graph against an eager
    engine on the same model, requests entering and leaving between
    ticks: tokens and [S, V] logits bit for bit; the replays count
    layers x ticks launches of the paged kernel."""
    dev = _card()
    model = _serve_model(dev)
    engines = _engine_pair(model, kv_dtype)
    name = "paged_attention_int8" if kv_dtype else "paged_attention"
    rng = np.random.default_rng(4)
    pps = model.max_seq_len // 16
    entered = 0

    def enter(slot):
        nonlocal entered
        prompt = rng.integers(0, 256, size=int(rng.integers(3, 60)))
        sampling = (dict(_GREEDY, temperature=0.9, top_k=20) if entered % 2
                    else _GREEDY)
        outs = [e.prefill(prompt, 50, entered, sampling) for e in engines]
        assert _same_prefill(*outs)
        vec = 1 + slot * pps + np.arange(pps)
        for e, out in zip(engines, outs):
            e.insert(slot, out, vec, vec, sampling)
        entered += 1

    # Every graph captured before the ticks: a capture's warm run
    # launches the kernels once, outside the replays counted here.
    engines[0].warm(widths=[4, 8, 16, 32, 64])
    for slot in range(3):
        enter(slot)
    launched = 0
    for t in range(30):
        before = tpa.launches[name]
        got = engines[0].tick()
        launched += tpa.launches[name] - before
        want = engines[1].tick()
        np.testing.assert_array_equal(got, want)
        assert torch.equal(engines[0]._tk["logits"], engines[1]._tk["logits"])
        if t % 4 == 3:
            gone = np.zeros(4, bool)
            gone[t % 3] = True
            for e in engines:
                e.evict(gone)
            enter(t % 3)
        if t == 10:
            enter(3)
    assert launched == model.num_layers * 30
    assert engines[0].captures == 6 and engines[1].captures == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["bf16", "int8"])
def test_prefill_graphs_equal_eager_prefill(kv_dtype):
    """Each bucket's window graph (with the gather graph) against the
    eager prefill: misses at every bucket, and prefix hits whose suffix
    starts mid-cache; first token and dense cache bit for bit."""
    dev = _card()
    model = _serve_model(dev)
    engines = _engine_pair(model, kv_dtype)
    rng = np.random.default_rng(5)
    root = rng.integers(0, 256, size=100)
    vec = 1 + np.arange(model.max_seq_len // 16)
    outs = [e.prefill(root, 4, 0, _GREEDY) for e in engines]
    assert _same_prefill(*outs)
    for e, out in zip(engines, outs):
        e.insert(0, out, vec, vec, _GREEDY)
    for n in (1, 2, 3, 5, 9, 17, 33, 65, 127):
        prompt = rng.integers(0, 256, size=n)
        outs = [e.prefill(prompt, 1, n, _GREEDY) for e in engines]
        assert _same_prefill(*outs), n
    for prefix_len, extra in ((16, 3), (48, 40), (64, 1), (80, 20)):
        prompt = np.concatenate([root[:prefix_len],
                                 rng.integers(0, 256, size=extra)])
        kw = dict(prefix_len=prefix_len,
                  gather_vec=vec[:-(-prefix_len // 16)])
        outs = [e.prefill(prompt, 1, 7, dict(_GREEDY, temperature=0.8), **kw)
                for e in engines]
        assert _same_prefill(*outs), prefix_len
    assert engines[0].captures == 8   # prefills at widths 1..128


@pytest.mark.cuda
def test_capture_after_warmup_raises_retrace_error():
    from cloud_tpu_torch.serving import RetraceError, Scheduler, ServeRequest

    dev = _card()
    model = _serve_model(dev)
    with Scheduler(model, slots=2, page_size=16, prefix_cache=False,
                   strict_no_retrace=True) as sched:
        sched.warmup([16])
        ok = sched.submit(ServeRequest([5] * 12, 4, temperature=0.0))
        assert ok.result(timeout=120).tokens.shape == (16,)
        # Bucket 64 was not warmed: its window graph is captured now,
        # and the tick loop's sentinel fails the loop.
        late = sched.submit(ServeRequest([6] * 40, 4, temperature=0.0))
        with pytest.raises(RetraceError):
            late.result(timeout=120)
    engine = _engine_pair(model, "")[0]
    engine.warm(widths=[8])
    engine.mark_warm()
    engine.prefill([1] * 7, 2, 0, _GREEDY)
    engine.check_no_retrace()
    engine.prefill([1] * 20, 2, 0, _GREEDY)
    with pytest.raises(RetraceError, match="captures"):
        engine.check_no_retrace()


# -- the decode block's kernels against their plain versions --

@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 1024])
def test_add_layer_norm_kernel_equals_plain(rows):
    """h bit-equal to x + r; y (bf16) within one rounding of the plain
    f32 LayerNorm (rtol 2^-8 + atol 1e-5 rms(row))."""
    from cloud_tpu_torch.ops import decode_block as db

    dev = _card()
    gen = torch.Generator().manual_seed(rows)
    x = (3.0 * torch.randn(rows, 768, generator=gen)).to(dev)
    r = torch.randn(rows, 768, generator=gen).to(dev, torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(768, generator=gen)).to(dev)
    b = (0.1 * torch.randn(768, generator=gen)).to(dev)
    before = db.launches["add_layer_norm"]
    y, h = db.add_layer_norm(x, r, w, b, 1e-5, torch.bfloat16)
    assert db.launches["add_layer_norm"] == before + 1
    plain, plain_h = db.add_layer_norm_reference(x, r, w, b, 1e-5,
                                                 torch.float32)
    assert torch.equal(h, plain_h)
    rms = plain.square().mean(-1, keepdim=True).sqrt()
    err = (y.float() - plain).abs()
    assert bool((err <= 2.0 ** -8 * plain.abs() + 1e-5 * rms).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,start", [(4, 1008), (16, 0), (16, 512)])
def test_window_attention_kernel_equals_plain(rows, start):
    """bf16, GPT-2's heads over a 1024-position cache, q a strided view of
    a q/k/v product: within rtol 2^-8 + atol 3e-2 rms(row) of the plain
    version."""
    from cloud_tpu_torch.ops import decode_block as db

    dev = _card()
    gen = torch.Generator().manual_seed(rows + start)
    cache = torch.randn(2, 1024, 12, 64, generator=gen).to(dev,
                                                          torch.bfloat16)
    q = torch.randn(rows, 3, 12, 64, generator=gen).to(dev,
                                                       torch.bfloat16)[:, 0]
    keys = torch.arange(1024, device=dev)
    last = start + torch.arange(rows, device=dev)
    bias = torch.where(keys[None, :] <= last[:, None], 0.0, -1e30)
    before = db.launches["window_attention"]
    out = db.window_attention(q, cache[0], cache[1], bias)
    assert db.launches["window_attention"] == before + 1
    plain = db.window_attention_reference(q, cache[0], cache[1], bias,
                                          0.125).float()
    rms = plain.square().mean(-1, keepdim=True).sqrt()
    err = (out.float() - plain).abs()
    assert bool((err <= 2.0 ** -8 * plain.abs() + 3e-2 * rms).all())


@pytest.mark.cuda
def test_int8_page_write_kernel_equals_plain():
    """One position of 8 slots (one dead, one on a never-written page)
    into int8 pages: pages and scales bit for bit."""
    from cloud_tpu_torch.ops import decode_block as db

    dev = _card()
    gen = torch.Generator().manual_seed(9)
    pages = torch.randint(-127, 128, (2, 40, 16, 12, 64), generator=gen,
                          dtype=torch.int8).to(dev)
    scales = (0.02 * torch.rand(2, 40, 12, generator=gen)).to(dev)
    scales[:, 5] = 0.0
    kv = (2.0 * torch.randn(2, 8, 1, 12, 64, generator=gen)).to(
        dev, torch.bfloat16)
    phys = (1 + 4 * torch.arange(8))[:, None].to(dev)
    phys[2, 0] = 5
    off = torch.randint(0, 16, (8, 1), generator=gen).to(dev)
    valid = torch.ones(8, 1, dtype=torch.bool, device=dev)
    valid[3] = False
    got = (pages.clone(), scales.clone())
    want = (pages.clone(), scales.clone())
    db.int8_page_write(*got, kv, phys, off, valid)
    db.int8_page_write_reference(*want, kv, phys, off, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[1], scales)   # some scales grew


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_page_gather_kernel_equals_plain(quantized):
    """A hit's gather (plen 1000 of 1024, 16-token pages) from bf16 or
    int8 pages: the dense cache bit for bit, zeros past plen."""
    from cloud_tpu_torch.ops import decode_block as db

    dev = _card()
    gen = torch.Generator().manual_seed(11)
    shape = (3, 2, 70, 16, 4, 64)
    if quantized:
        pages = torch.randint(-127, 128, shape, generator=gen,
                              dtype=torch.int8).to(dev)
        scales = (0.05 * torch.rand(3, 2, 70, 4, generator=gen)).to(dev)
    else:
        pages = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        scales = None
    gvec = torch.randperm(70, generator=gen)[:64].to(dev)
    plen = torch.tensor(1000, device=dev)
    out = torch.full((3, 2, 1, 1024, 4, 64), 7.0, dtype=torch.bfloat16,
                     device=dev)
    want = torch.empty_like(out)
    db.page_gather(pages, scales, gvec, plen, out)
    db.page_gather_reference(pages, scales, gvec, plen, want)
    assert torch.equal(out, want)
    assert not out[:, :, :, 1000:].any()
