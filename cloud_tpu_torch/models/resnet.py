"""ResNet v1.5 family (ResNet-50 the flagship): the port of
`cloud_tpu/models/resnet.py`.

Inputs are the JAX layout [B, H, W, C]; the network runs on the NCHW
view of that memory, which is channels_last, so no copy is made and
cuDNN takes its NHWC kernels. Compute is bf16 by default with f32
parameters and f32 running statistics (BatchNorm's statistics in f32);
logits come back f32. The stride sits on the bottleneck's 3x3 (v1.5).
Every convolution and the stem's max-pool pad as flax's SAME does
(`_layers.same_pads`: asymmetric at stride 2), and BatchNorm follows
flax (`_layers.BatchNorm`: momentum 0.9, eps 1e-5, the biased batch
variance in the running average). `forward(x, train=True)` takes
`train` as `Trainer(train_kwargs={"train": True}, eval_kwargs={"train":
False})` passes it.

Module names are flax's (`conv_init`, `bn_init`, `BottleneckBlock_i`
with `Conv_j` / `BatchNorm_j` / `shortcut` / `shortcut_bn`,
`Dense_0`), so `convert.image_params_from_flax` carries a JAX model's
params and batch_stats across and `trainable=` matches its paths.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from cloud_tpu_torch.models import _layers
from cloud_tpu_torch.parallel import runtime


def _conv(cin, cout, k, device):
    return nn.Conv2d(cin, cout, k, bias=False, device=device)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4 x filters) with a projection
    shortcut when the shape changes; the last BatchNorm's scale starts
    at 0."""

    expansion = 4

    def __init__(self, in_channels, filters, strides=1, device=None):
        super().__init__()
        self.strides = strides
        out = filters * 4
        self.Conv_0 = _conv(in_channels, filters, 1, device)
        self.BatchNorm_0 = _layers.BatchNorm(filters, device=device)
        self.Conv_1 = _conv(filters, filters, 3, device)
        self.BatchNorm_1 = _layers.BatchNorm(filters, device=device)
        self.Conv_2 = _conv(filters, out, 1, device)
        self.BatchNorm_2 = _layers.BatchNorm(out, scale_init=0.0,
                                             device=device)
        self.has_shortcut = in_channels != out or strides != 1
        if self.has_shortcut:
            self.shortcut = _conv(in_channels, out, 1, device)
            self.shortcut_bn = _layers.BatchNorm(out, device=device)

    def forward(self, x, train, dtype):
        y = _layers.conv_same(x, self.Conv_0.weight, None, 1, dtype)
        y = F.relu(self.BatchNorm_0(y, train))
        y = _layers.conv_same(y, self.Conv_1.weight, None, self.strides,
                              dtype)
        y = F.relu(self.BatchNorm_1(y, train))
        y = _layers.conv_same(y, self.Conv_2.weight, None, 1, dtype)
        y = self.BatchNorm_2(y, train)
        residual = x
        if self.has_shortcut:
            residual = _layers.conv_same(x, self.shortcut.weight, None,
                                         self.strides, dtype)
            residual = self.shortcut_bn(residual, train)
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3 (stride) -> 3x3 basic block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_channels, filters, strides=1, device=None):
        super().__init__()
        self.strides = strides
        self.Conv_0 = _conv(in_channels, filters, 3, device)
        self.BatchNorm_0 = _layers.BatchNorm(filters, device=device)
        self.Conv_1 = _conv(filters, filters, 3, device)
        self.BatchNorm_1 = _layers.BatchNorm(filters, scale_init=0.0,
                                             device=device)
        self.has_shortcut = in_channels != filters or strides != 1
        if self.has_shortcut:
            self.shortcut = _conv(in_channels, filters, 1, device)
            self.shortcut_bn = _layers.BatchNorm(filters, device=device)

    def forward(self, x, train, dtype):
        y = _layers.conv_same(x, self.Conv_0.weight, None, self.strides,
                              dtype)
        y = F.relu(self.BatchNorm_0(y, train))
        y = _layers.conv_same(y, self.Conv_1.weight, None, 1, dtype)
        y = self.BatchNorm_1(y, train)
        residual = x
        if self.has_shortcut:
            residual = _layers.conv_same(x, self.shortcut.weight, None,
                                         self.strides, dtype)
            residual = self.shortcut_bn(residual, train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 with bottleneck (50+) or basic (18/34) blocks.

    conv0_space_to_depth: fold 2x2 input blocks into channels ([H, W, C]
    -> [H/2, W/2, 4C]) and run the stem as a 4x4/s1 convolution (the
    MLPerf TPU stem; not weight-compatible with the 7x7/s2 one).
    """

    def __init__(self, stage_sizes, num_classes=1000, num_filters=64,
                 compute_dtype=torch.bfloat16, conv0_space_to_depth=False,
                 block=BottleneckBlock, in_channels=3, device=None, seed=0):
        super().__init__()
        device = runtime.resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.compute_dtype = compute_dtype
        self.conv0_space_to_depth = conv0_space_to_depth
        if conv0_space_to_depth:
            self.conv_init = _conv(4 * in_channels, num_filters, 4, device)
        else:
            self.conv_init = _conv(in_channels, num_filters, 7, device)
        self.bn_init = _layers.BatchNorm(num_filters, device=device)
        self.block_names = []
        channels = num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                name = "{}_{}".format(block.__name__, len(self.block_names))
                filters = num_filters * 2 ** i
                setattr(self, name, block(channels, filters, strides,
                                          device=device))
                self.block_names.append(name)
                channels = filters * block.expansion
        self.Dense_0 = nn.Linear(channels, num_classes, device=device)
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        gen = torch.Generator().manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                _layers.lecun_init(module, gen)
            elif isinstance(module, _layers.BatchNorm):
                module.weight.fill_(module.scale_init)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)

    def forward(self, x, train=True):
        dt = self.compute_dtype
        x = x.to(dt)
        if self.conv0_space_to_depth:
            b, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(
                    "space-to-depth needs even spatial dims; got "
                    "{}x{}.".format(h, w))
            x = x.reshape(b, h // 2, 2, w // 2, 2, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
            stem_stride = 1
        else:
            stem_stride = 2
        # [B, H, W, C] -> the NCHW view of the same memory (channels_last).
        x = x.permute(0, 3, 1, 2)
        x = _layers.conv_same(x, self.conv_init.weight, None, stem_stride, dt)
        x = F.relu(self.bn_init(x, train))
        x = _layers.max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train, dt)
        x = x.mean(dim=(2, 3))
        x = F.linear(x, self.Dense_0.weight.to(dt), self.Dense_0.bias.to(dt))
        return x.float()


def resnet_train_flops(model, batch, image_size):
    """Multiply-add FLOPs (2 per multiply-add) of one training step
    (forward x 3) of `model` at `batch` images of `image_size` (an int,
    or (H, W)), counted from every convolution's and the dense head's
    shapes as the network walks the spatial sizes (SAME: out =
    ceil(in / stride))."""
    h, w = ((image_size, image_size) if isinstance(image_size, int)
            else tuple(image_size))
    total = [0.0]

    def conv(layer, h, w, stride):
        h, w = -(-h // stride), -(-w // stride)
        cout, cin, kh, kw = layer.weight.shape
        total[0] += 2.0 * h * w * cin * cout * kh * kw
        return h, w

    if model.conv0_space_to_depth:
        h, w = conv(model.conv_init, h // 2, w // 2, 1)
    else:
        h, w = conv(model.conv_init, h, w, 2)
    h, w = -(-h // 2), -(-w // 2)                 # the 3x3/s2 max-pool
    for name in model.block_names:
        block = getattr(model, name)
        bh, bw = h, w
        convs = [block.Conv_0, block.Conv_1] + (
            [block.Conv_2] if hasattr(block, "Conv_2") else [])
        strided = 1 if isinstance(block, BottleneckBlock) else 0
        for i, layer in enumerate(convs):
            bh, bw = conv(layer, bh, bw, block.strides if i == strided
                          else 1)
        if block.has_shortcut:
            conv(block.shortcut, h, w, block.strides)
        h, w = bh, bw
    total[0] += 2.0 * model.Dense_0.in_features * model.Dense_0.out_features
    return 3.0 * batch * total[0]


def ResNet18(**kwargs):
    return ResNet(stage_sizes=(2, 2, 2, 2), block=BasicBlock, **kwargs)


def ResNet34(**kwargs):
    return ResNet(stage_sizes=(3, 4, 6, 3), block=BasicBlock, **kwargs)


def ResNet50(**kwargs):
    return ResNet(stage_sizes=(3, 4, 6, 3), **kwargs)


def ResNet101(**kwargs):
    return ResNet(stage_sizes=(3, 4, 23, 3), **kwargs)


def ResNet152(**kwargs):
    return ResNet(stage_sizes=(3, 8, 36, 3), **kwargs)


__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "ResNet101",
           "ResNet152", "ResNet18", "ResNet34", "ResNet50",
           "resnet_train_flops"]
