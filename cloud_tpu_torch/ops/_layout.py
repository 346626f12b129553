"""Operand layout for the port's CUDA kernels.

The kernels read their operands as dense row-major arrays, with TMA or
16-byte vector loads, so they take contiguous tensors with 16-byte
aligned bases. JAX arrays have no strides; a PyTorch tensor may be a
transposed or offset view. `dense` hands such a view to the same kernel
as a fresh contiguous copy, and a tensor that is already fine unchanged.
`pad_last` gives a kernel whose rows must be 16 bytes apart a zero-padded
copy of a tensor whose last dimension is not a multiple of 8 values.
"""

import torch
import torch.nn.functional as F


def dense(t):
    """`t` itself when it is contiguous with a 16-byte aligned base;
    otherwise a contiguous copy in fresh memory (the caching allocator
    aligns a new block to at least 512 bytes). The copy is
    differentiable, so gradients reach `t`."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out.copy_(t)


def pad_last(t, multiple):
    """`t` itself when its last dimension is a multiple of `multiple`;
    otherwise a copy zero-padded there to the next multiple. The copy is
    differentiable, so gradients reach `t` (the pad's are dropped)."""
    pad = -t.shape[-1] % multiple
    return F.pad(t, (0, pad)) if pad else t


__all__ = ["dense", "pad_last"]
