"""Vision Transformer (ViT) family: the port of `cloud_tpu/models/vit.py`.

Patchify by one strided convolution, a cls token (or mean pooling),
learned position embeddings, pre-norm encoder blocks whose
bidirectional attention goes through `cloud_tpu_torch.ops.attention`
(`causal=False`): on CUDA tensors the hand-written flash kernels
(forward, dq, dk/dv), never SDPA; on CPU tensors the plain
`mha_reference`. At 224 x 224 with patch 16 the sequence is 197 tokens,
which no kernel tile divides: the kernels mask the keys past S by their
key flags.

As in JAX: bf16 compute with f32 parameters, the residual stream in the
compute dtype from the patch embedding on, LayerNorm eps 1e-6 (torch's
default is 1e-5) with statistics in f32, GELU by its tanh
approximation (flax's `nn.gelu`), q/k/v kernels [D, H, head_dim] and the
out kernel [H, head_dim, D] as `Linear`s over H x head_dim, f32 logits.
Module names are flax's, so `convert.image_params_from_flax` carries
parameters across. `forward(x, train=False, generator=None)`: dropout
(when `dropout_rate` > 0 and train) draws from `generator`.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from cloud_tpu_torch.models import _layers
from cloud_tpu_torch.models.transformer import _dropout
from cloud_tpu_torch.ops import attention as attention_ops
from cloud_tpu_torch.parallel import runtime

LN_EPS = 1e-6


def _dense(x, layer, dtype):
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(x, norm):
    """flax `nn.LayerNorm(dtype=x.dtype)`: f32 statistics, output in x's
    dtype (scale and bias applied in x's dtype)."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


class EncoderBlock(nn.Module):
    """Pre-norm transformer encoder block (bidirectional attention)."""

    def __init__(self, d_model, num_heads, d_ff, dropout_rate=0.0,
                 device=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model {} must divide by num_heads {}."
                             .format(d_model, num_heads))
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dropout_rate = float(dropout_rate)
        self.ln_attn = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        for name in ("query", "key", "value"):
            setattr(self, name, nn.Linear(d_model, d_model, device=device))
        self.out = nn.Linear(d_model, d_model, device=device)
        self.ln_mlp = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.mlp_in = nn.Linear(d_model, d_ff, device=device)
        self.mlp_out = nn.Linear(d_ff, d_model, device=device)

    def forward(self, x, dtype, deterministic=True, generator=None):
        b, s, d = x.shape
        drop = (self.dropout_rate > 0 and not deterministic
                and generator is not None)
        y = _layer_norm(x, self.ln_attn)
        q, k, v = (_dense(y, getattr(self, n), dtype).view(
            b, s, self.num_heads, self.head_dim)
            for n in ("query", "key", "value"))
        y = attention_ops.attention(q, k, v, causal=False)
        y = _dense(y.reshape(b, s, d).to(dtype), self.out, dtype)
        if drop:
            y = _dropout(y, self.dropout_rate, generator)
        x = x + y
        y = _layer_norm(x, self.ln_mlp)
        y = F.gelu(_dense(y, self.mlp_in, dtype), approximate="tanh")
        y = _dense(y, self.mlp_out, dtype)
        if drop:
            y = _dropout(y, self.dropout_rate, generator)
        return x + y


class ViT(nn.Module):
    """Vision Transformer classifier on [B, H, W, C] images of
    `image_size` (an int, or (H, W)); H and W must divide by
    `patch_size`. pool: "cls" (a learned token first) or "mean"."""

    def __init__(self, num_classes=1000, patch_size=16, num_layers=12,
                 num_heads=12, d_model=768, d_ff=3072, dropout_rate=0.0,
                 pool="cls", compute_dtype=torch.bfloat16, image_size=224,
                 in_channels=3, device=None, seed=0):
        super().__init__()
        device = runtime.resolve_device(device)
        if pool not in ("cls", "mean"):
            raise ValueError("pool must be 'cls' or 'mean', got {!r}"
                             .format(pool))
        h, w = ((image_size, image_size) if isinstance(image_size, int)
                else tuple(image_size))
        if h % patch_size or w % patch_size:
            raise ValueError(
                "Image size {}x{} must divide by patch_size {}.".format(
                    h, w, patch_size))
        self.patch_size = patch_size
        self.pool = pool
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.dropout_rate = float(dropout_rate)
        self.compute_dtype = compute_dtype
        self.image_size = (h, w)
        tokens = (h // patch_size) * (w // patch_size) + (pool == "cls")
        self.patch_embed = nn.Conv2d(in_channels, d_model, patch_size,
                                     stride=patch_size, device=device)
        if pool == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model,
                                                      device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, d_model,
                                                  device=device))
        for i in range(num_layers):
            setattr(self, "block_%d" % i, EncoderBlock(
                d_model, num_heads, d_ff, dropout_rate, device=device))
        self.ln_final = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.head = nn.Linear(d_model, num_classes, device=device)
        if seed is not None:
            self.reset_parameters(seed)

    @property
    def seq_len(self):
        return self.pos_embed.shape[1]

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """flax's inits from `seed`: lecun-normal kernels (fan-in D for
        q/k/v, H x head_dim for out), zero biases and cls token, unit
        norm scales, position embeddings normal(0.02)."""
        gen = torch.Generator().manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                _layers.lecun_init(module, gen)
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        self.pos_embed.copy_(torch.randn(self.pos_embed.shape,
                                         generator=gen) * 0.02)
        if self.pool == "cls":
            self.cls_token.zero_()

    def forward(self, x, train=False, generator=None):
        batch, height, width = x.shape[:3]
        p = self.patch_size
        if height % p or width % p:
            raise ValueError(
                "Image size {}x{} must divide by patch_size {}.".format(
                    height, width, p))
        if (height, width) != self.image_size:
            raise ValueError(
                "this ViT was built for {}x{} images (its position "
                "embeddings); got {}x{}.".format(*self.image_size, height,
                                                 width))
        dt = self.compute_dtype
        deterministic = not train
        # One strided convolution == a per-patch linear map; the NCHW
        # view of [B, H, W, C] is channels_last, and so is the output,
        # whose [B, h, w, D] view flattens to tokens without a copy.
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.conv2d(x, self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=p)
        x = x.permute(0, 2, 3, 1).reshape(batch, -1, self.d_model)
        if self.pool == "cls":
            cls = self.cls_token.to(dt).expand(batch, 1, self.d_model)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(dt)
        if self.dropout_rate and not deterministic and generator is not None:
            x = _dropout(x, self.dropout_rate, generator)
        for i in range(self.num_layers):
            x = getattr(self, "block_%d" % i)(x, dt, deterministic,
                                              generator)
        x = _layer_norm(x, self.ln_final)
        x = x[:, 0] if self.pool == "cls" else x.mean(dim=1)
        return _dense(x, self.head, dt).float()


def ViT_S16(**kwargs):
    return ViT(num_layers=12, num_heads=6, d_model=384, d_ff=1536, **kwargs)


def ViT_B16(**kwargs):
    return ViT(num_layers=12, num_heads=12, d_model=768, d_ff=3072, **kwargs)


def ViT_L16(**kwargs):
    return ViT(num_layers=24, num_heads=16, d_model=1024, d_ff=4096,
               **kwargs)


def vit_train_flops(model, batch):
    """Matmul and attention FLOPs of one training step (forward x 3) of
    `model` at `batch` images, from its shapes: the patch embedding, the
    q/k/v/out, MLP and head products, and the two attention products
    over S x S pairs per head."""
    d, s = model.d_model, model.seq_len
    patches = s - (model.pool == "cls")
    ff = model.block_0.mlp_in.out_features
    cin = model.patch_embed.in_channels
    p = model.patch_size
    per_image = 2 * patches * d * cin * p * p
    per_layer = 2 * s * (4 * d * d + 2 * d * ff) + 2 * 2 * s * s * d
    per_image += model.num_layers * per_layer
    per_image += 2 * d * model.head.out_features
    return 3.0 * batch * per_image


__all__ = ["EncoderBlock", "ViT", "ViT_B16", "ViT_L16", "ViT_S16",
           "vit_train_flops"]
