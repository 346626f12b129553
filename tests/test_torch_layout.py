"""`ops._layout.dense`, the copy the CUDA wrappers make of an operand
that is not contiguous or not 16-byte aligned (JAX arrays have no
strides, so the kernels take any layout the JAX package takes). On the
CPU the helper itself is checked; the card tests send such operands
through each wrapper."""

import pytest
import torch

from cloud_tpu_torch.ops._layout import dense


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "int8"])
def test_misaligned_view_comes_back_contiguous_and_aligned(dtype):
    n = 64
    flat = torch.arange(n + 1).to(dtype)
    view = flat[1:].view(8, 8)
    assert view.is_contiguous() and view.data_ptr() % 16
    got = dense(view)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert got.data_ptr() != view.data_ptr()
    assert torch.equal(got, view)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_transposed_view_comes_back_contiguous(dtype):
    t = torch.randn(2, 40, 4, 64).to(dtype)
    view = t.transpose(1, 2)
    assert not view.is_contiguous()
    got = dense(view)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert got.shape == view.shape and torch.equal(got, view)


@pytest.mark.parametrize("shape", [(8, 64), (2, 40, 4, 64), (1,), (0, 8)],
                         ids=["8x64", "bshd", "1", "empty"])
def test_aligned_contiguous_tensor_comes_back_untouched(shape):
    t = torch.zeros(shape, dtype=torch.bfloat16)
    assert dense(t) is t
    # A view a whole number of 16-byte pieces in is aligned too.
    rows = torch.zeros((10, 64), dtype=torch.bfloat16)[2:]
    assert dense(rows) is rows


def test_gradient_reaches_the_view():
    base = torch.randn(3, 5, requires_grad=True)
    view = base.T
    out = dense(view)
    assert out.requires_grad and out.is_contiguous()
    (out * torch.arange(15.0).view(5, 3)).sum().backward()
    assert torch.equal(base.grad, torch.arange(15.0).view(5, 3).T)


@pytest.mark.parametrize("head_dim", [1, 36, 100])
def test_pad_last_zero_pads_to_a_multiple_and_passes_gradients(head_dim):
    """`pad_last`: the copy the flash wrapper makes of q/k/v whose
    head_dim is not a multiple of 8 (TMA rows are 16 bytes apart): zeros
    past D, the values before it, and gradients back to the original
    (the pad's dropped)."""
    from cloud_tpu_torch.ops._layout import pad_last

    t = torch.randn(2, 5, 3, head_dim, requires_grad=True)
    got = pad_last(t, 8)
    width = -(-head_dim // 8) * 8
    assert got.shape == (2, 5, 3, width) and got.is_contiguous()
    assert torch.equal(got[..., :head_dim], t)
    assert not got[..., head_dim:].any()
    grad = torch.randn(got.shape)
    got.backward(grad)
    assert torch.equal(t.grad, grad[..., :head_dim])
    even = torch.zeros(2, 8)
    assert pad_last(even, 8) is even
