"""MNIST models, the framework's hello-world family: the port of
`cloud_tpu/models/mnist.py`.

`MLP` (Flatten -> 512 relu -> 10) and `ConvNet` compute in
`compute_dtype` (bf16 by default) with f32 parameters, each kernel cast
to the compute dtype at use as flax's `Dense(dtype=...)` does, and
return f32 logits. Module names are flax's (`Dense_0`, `Conv_0`, ...),
so `convert.image_params_from_flax` carries JAX parameters across and
`trainable=` matches the JAX paths. Flax infers input widths at the
first call; here they are arguments (`in_features`, `image_size`,
`in_channels`).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from cloud_tpu_torch.models import _layers
from cloud_tpu_torch.parallel import runtime


def _dense(x, layer, dtype):
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


class MLP(nn.Module):
    """Keras-README-equivalent dense net: Flatten -> hidden relu ->
    num_classes, on [B, ...] inputs of `in_features` values each."""

    def __init__(self, hidden=512, num_classes=10,
                 compute_dtype=torch.bfloat16, in_features=784,
                 device=None, seed=0):
        super().__init__()
        device = runtime.resolve_device(device)
        self.compute_dtype = compute_dtype
        self.Dense_0 = nn.Linear(in_features, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, num_classes, device=device)
        if seed is not None:
            self.reset_parameters(seed)

    def reset_parameters(self, seed=0):
        gen = torch.Generator().manual_seed(int(seed))
        for layer in (self.Dense_0, self.Dense_1):
            _layers.lecun_init(layer, gen)

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt).reshape(x.shape[0], -1)
        x = F.relu(_dense(x, self.Dense_0, dt))
        return _dense(x, self.Dense_1, dt).float()


class ConvNet(nn.Module):
    """Small conv net for MNIST-scale images [B, H, W] or [B, H, W, C]:
    conv 3x3 32 relu, max-pool 2, conv 3x3 64 relu, max-pool 2, dense
    128 relu, dense num_classes (SAME convolutions, as flax's
    default)."""

    def __init__(self, num_classes=10, compute_dtype=torch.bfloat16,
                 image_size=28, in_channels=1, device=None, seed=0):
        super().__init__()
        device = runtime.resolve_device(device)
        self.compute_dtype = compute_dtype
        self.Conv_0 = nn.Conv2d(in_channels, 32, 3, device=device)
        self.Conv_1 = nn.Conv2d(32, 64, 3, device=device)
        pooled = (image_size // 2) // 2
        self.Dense_0 = nn.Linear(pooled * pooled * 64, 128, device=device)
        self.Dense_1 = nn.Linear(128, num_classes, device=device)
        if seed is not None:
            self.reset_parameters(seed)

    def reset_parameters(self, seed=0):
        gen = torch.Generator().manual_seed(int(seed))
        for layer in (self.Conv_0, self.Conv_1, self.Dense_0, self.Dense_1):
            _layers.lecun_init(layer, gen)

    def forward(self, x):
        dt = self.compute_dtype
        if x.ndim == 3:
            x = x[..., None]
        # [B, H, W, C] -> an NCHW view (channels_last memory, no copy).
        x = x.to(dt).permute(0, 3, 1, 2)
        for conv in (self.Conv_0, self.Conv_1):
            x = F.relu(_layers.conv_same(x, conv.weight, conv.bias, 1, dt))
            x = F.max_pool2d(x, 2, 2)
        # Flatten in flax's [B, H, W, C] order.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(_dense(x, self.Dense_0, dt))
        return _dense(x, self.Dense_1, dt).float()


__all__ = ["ConvNet", "MLP"]
