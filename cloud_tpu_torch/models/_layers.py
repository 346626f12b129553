"""Layers the image models share, with flax's semantics: SAME padding,
BatchNorm with flax's running averages, the seeded lecun-normal init,
and the recompute flag that `Trainer(remat=True)` raises while the
backward reruns a forward.

SAME padding is flax's (and XLA's): out = ceil(n / stride), total =
max((out - 1) * stride + k - n, 0), lo = total // 2 before and the rest
after, so a stride-2 window pads less before than after. PyTorch's
`Conv2d(padding=k // 2)` pads both sides alike, which shifts every
window; here a symmetric pad goes to the convolution and an asymmetric
one to `F.pad` first.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

_recomputing = [False]


def recomputing():
    """Whether the forward running now is the recompute of a
    rematerialised step (BatchNorm then leaves its running averages
    alone: the first forward moved them)."""
    return _recomputing[0]


def set_recomputing(active):
    """Sets the flag; returns the previous value (to restore)."""
    previous = _recomputing[0]
    _recomputing[0] = bool(active)
    return previous


def same_pads(size, kernel, stride):
    """(lo, hi) of flax's SAME padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x, weight, bias, stride, dtype):
    """flax `nn.Conv(padding="SAME", strides=stride, dtype=dtype)` on an
    NCHW (channels_last) x: weight [out, in, kh, kw] (f32, cast to
    `dtype` at use, as flax casts its kernel)."""
    kh, kw = weight.shape[2:]
    (hlo, hhi), (wlo, whi) = (same_pads(x.shape[2], kh, stride),
                              same_pads(x.shape[3], kw, stride))
    if hlo == hhi and wlo == whi:
        padding = (hlo, wlo)
    else:
        x = F.pad(x, (wlo, whi, hlo, hhi))
        padding = 0
    return F.conv2d(x, weight.to(dtype), None if bias is None
                    else bias.to(dtype), stride=stride, padding=padding)


def max_pool_same(x, window, stride):
    """flax `nn.max_pool(padding="SAME")`: pads with -inf."""
    (hlo, hhi), (wlo, whi) = (same_pads(x.shape[2], window, stride),
                              same_pads(x.shape[3], window, stride))
    if hlo or hhi or wlo or whi:
        x = F.pad(x, (wlo, whi, hlo, hhi), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over dim 1 (channels) of an NCHW tensor:
    `weight`/`bias` are flax's scale/bias, `running_mean`/`running_var`
    its batch_stats mean/var (f32).

    train=True normalises by the batch's mean and biased variance
    (statistics in f32 on bf16 activations) and moves the running
    averages by flax's momentum m (0.9 is torch's 0.1): r <- m r + (1 -
    m) batch, with the BIASED batch variance (torch's `BatchNorm2d`
    folds in the unbiased one). The batch statistics come back from the
    normalisation itself (mean and 1/sqrt(var + eps)), so no second
    pass reads the activations. train=False normalises by the running
    averages. The output has x's dtype.
    """

    def __init__(self, features, momentum=0.9, eps=1e-5, scale_init=1.0,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale_init = scale_init
        self.weight = nn.Parameter(torch.full((features,), float(scale_init),
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x, train):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mean, invstd, _, _ = torch._batch_norm_impl_index(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps,
            torch.backends.cudnn.enabled)
        if not recomputing():
            m = self.momentum
            with torch.no_grad():
                var = invstd.reciprocal().square() - self.eps
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        return y


@torch.no_grad()
def lecun_init(module, gen):
    """flax's default init, drawn from the CPU generator `gen`: Dense /
    Conv kernels normal with variance 1 / fan_in (fan_in = the input
    features times the window), biases 0. (flax truncates the normal at
    two standard deviations; parity tests carry parameters across, so
    the draw need not match.)"""
    w = module.weight
    fan_in = w[0].numel()
    w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))
    if module.bias is not None:
        module.bias.zero_()


__all__ = ["BatchNorm", "conv_same", "lecun_init", "max_pool_same",
           "recomputing", "same_pads", "set_recomputing"]
