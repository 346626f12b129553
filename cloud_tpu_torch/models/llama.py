"""Llama-family decoder LM (RMSNorm, RoPE, SwiGLU, grouped-query
attention); the port of `cloud_tpu/models/llama.py`: the training
forward and decode over a dense KV cache (`generate()`).

Parameters are float32; the forward runs in `compute_dtype` as the JAX
model does: the embedding output and the residual stream are in the
compute dtype, and so is the output head, whose logits are then cast to
f32 (and soft-capped with `final_logit_softcap`). Each block:

- `norm_attn`: the fused RMSNorm (`ops.fused_norm`, the CUDA kernel on
  the card) without a residual;
- `GQAttention`: q/k/v projections (biased with `qkv_bias`), an optional
  per-head RMSNorm of q and k (`qk_norm`, plain as in JAX), RoPE at
  positions 0..S-1, and attention through `ops.attention` (the flash
  kernels on the card) with K/V at H_kv width;
- `norm_mlp`: the fused RMSNorm with the residual add (h = x + y);
  with `dropout_rate > 0` the add and a plain RMSNorm instead, since the
  dropout sits between them;
- the SwiGLU MLP through `ops.fused_mlp` (the CUDA kernels on the card),
  or, with `moe_experts > 0`, the Mixtral / Qwen3-MoE top-k MoE
  (`models.moe.TopKMoEMLP`) in its place;
- optional Gemma2/3 sandwich norms (`post_block_norms`, plain).

A training forward (no cache, the model in training mode) leaves each
MoE block's aux loss in `aux_losses`, which the Trainer adds to the
loss times its `aux_loss_weight`, as JAX's sown "losses" collection;
an eval or decode forward leaves it empty.

Dropout draws from the caller's `torch.Generator` (the Trainer's, seeded
from its seed and the step) when the forward is called with
`deterministic=False`.

With a cache dict (`init_cache(batch)`), a forward call decodes and
updates the cache in place (no gradients), as the JAX model does with
`decode=True`: per layer a slot-addressed K/V cache at H_kv width, RoPE
and the window band on each example's logical positions (real tokens
only, `decoding.decode_slot_update`), and the grouped attention product
in plain PyTorch with f32 logits and softmax (the JAX decode attention
is jnp, not a Pallas kernel). The norms and the MLP run the same fused
kernels as training, at rows = batch x tokens of the call.

Not ported (ROADMAP "Modules to port"): the sequence-parallel attention
impls ("ring", "ulysses"), which raise NotImplementedError.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cloud_tpu_torch.models import decoding
from cloud_tpu_torch.models.moe import TopKMoEMLP
from cloud_tpu_torch.models.transformer import _ComputeWeights, _dropout
from cloud_tpu_torch.ops import attention as attention_ops
from cloud_tpu_torch.ops import fused_mlp as mlp_ops
from cloud_tpu_torch.ops import fused_norm as norm_ops
from cloud_tpu_torch.parallel import runtime

#: TinyLlama-1.1B (`TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T`,
#: config.json): 22 layers, d 2048, 32 heads over 4 KV heads (head_dim
#: 64), d_ff 5632, vocab 32000, rms_norm_eps 1e-5, rope_theta 1e4, 2048
#: positions, untied head, silu; rotate-half RoPE, the pairing HF-layout
#: weights were trained with.
TINYLLAMA_1_1B = dict(vocab_size=32000, num_layers=22, num_heads=32,
                      num_kv_heads=4, d_model=2048, d_ff=5632,
                      max_seq_len=2048, rope_theta=10000.0,
                      rope_style="rotate_half", norm_eps=1e-5,
                      mlp_activation="silu")

#: Qwen3-30B-A3B (`Qwen/Qwen3-30B-A3B`, config.json): 48 layers, d 2048,
#: 32 heads over 4 KV heads at head_dim 128 with q/k norms, vocab 151936,
#: rms_norm_eps 1e-6, rope_theta 1e6, 40960 positions, untied head, silu;
#: every block's MLP an MoE of 128 experts of width 768
#: (moe_intermediate_size), 8 per token, norm_topk_prob true. Rotate-half
#: RoPE, the pairing of HF-layout weights. The capacity factor is the
#: training default (2.0); the importer makes a checkpoint drop-free.
QWEN3_30B_A3B = dict(vocab_size=151936, num_layers=48, num_heads=32,
                     num_kv_heads=4, head_dim=128, d_model=2048, d_ff=768,
                     max_seq_len=40960, rope_theta=1000000.0,
                     rope_style="rotate_half", norm_eps=1e-6,
                     mlp_activation="silu", qk_norm=True, moe_experts=128,
                     moe_top_k=8, moe_norm_topk=True)

_SEQUENCE_PARALLEL = ("ring", "ulysses")


class RopeScaling(NamedTuple):
    """Long-context RoPE frequency-scaling recipe (HF `rope_scaling`):
    "linear" divides every frequency by `factor`; "llama3" is
    Llama-3.1's banded scheme; "yarn" is NTK-by-parts with an attention
    factor on the rotated q/k. Fields as in the JAX package."""
    kind: str
    factor: float
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_len: int = 8192
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: Optional[float] = None
    mscale: Optional[float] = None
    mscale_all_dim: Optional[float] = None
    truncate: bool = True


def _yarn_mscale(scale, mscale=1.0):
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * float(np.log(scale)) + 1.0


def yarn_attention_factor(scaling):
    """The cos/sin magnitude factor a yarn recipe applies to the rotated
    q/k (HF _compute_yarn_parameters attention_factor)."""
    if scaling.attention_factor is not None:
        return float(scaling.attention_factor)
    if scaling.mscale and scaling.mscale_all_dim:
        return (_yarn_mscale(scaling.factor, scaling.mscale)
                / _yarn_mscale(scaling.factor, scaling.mscale_all_dim))
    return _yarn_mscale(scaling.factor)


def _scale_rope_freqs(freqs, scaling, theta, head_dim):
    """Applies a RopeScaling recipe to base inv-frequencies [D/2] (f32)."""
    if scaling.kind == "linear":
        return freqs / scaling.factor
    if scaling.kind == "llama3":
        wavelen = 2.0 * np.pi / freqs
        low_wl = scaling.original_max_len / scaling.low_freq_factor
        high_wl = scaling.original_max_len / scaling.high_freq_factor
        smooth = ((scaling.original_max_len / wavelen
                   - scaling.low_freq_factor)
                  / (scaling.high_freq_factor - scaling.low_freq_factor))
        blended = (1.0 - smooth) * freqs / scaling.factor + smooth * freqs
        return torch.where(
            wavelen < high_wl, freqs,
            torch.where(wavelen > low_wl, freqs / scaling.factor, blended))
    if scaling.kind == "yarn":
        def correction_dim(rot):
            return (head_dim * np.log(
                scaling.original_max_len / (rot * 2.0 * np.pi))
                / (2.0 * np.log(theta)))

        low = correction_dim(scaling.beta_fast)
        high = correction_dim(scaling.beta_slow)
        if scaling.truncate:
            low, high = np.floor(low), np.ceil(high)
        low = max(low, 0.0)
        high = min(high, head_dim - 1.0)
        if high == low:
            high += 0.001  # HF's singularity guard
        ramp = torch.clamp(
            (torch.arange(head_dim // 2, dtype=torch.float32,
                          device=freqs.device) - float(low))
            / float(high - low), 0.0, 1.0)
        extrapolation_factor = 1.0 - ramp
        return (freqs / scaling.factor * (1.0 - extrapolation_factor)
                + freqs * extrapolation_factor)
    raise ValueError(
        "Unknown RopeScaling kind {!r}; expected 'linear', 'llama3', "
        "or 'yarn'.".format(scaling.kind))


def apply_rope(x, positions, theta=10000.0, style="interleaved",
               scaling=None):
    """Rotary position embedding over the last (head_dim) axis.

    x: [B, S, H, D] (D even); positions: [S] or [B, S] ints. Feature
    pairs rotate by pos * theta^(-2i/D) in f32 whatever x's dtype, then
    the result is cast back. style "interleaved" pairs (even, odd)
    features; "rotate_half" pairs (i, i + D/2), the layout of HF Llama
    weights."""
    head_dim = x.shape[-1]
    if head_dim % 2:
        raise ValueError("RoPE needs an even head_dim; got %d." % head_dim)
    exponents = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                              device=x.device) / head_dim
    # theta as a 0-d CPU tensor: a CUDA op reads it on the host, where a
    # copy to the card would wait for all queued work (decode runs this
    # twice a layer per token).
    freqs = torch.pow(torch.tensor(float(theta), dtype=torch.float32),
                      exponents)
    if scaling is not None:
        freqs = _scale_rope_freqs(freqs, scaling, theta, head_dim)
    positions = torch.as_tensor(positions, device=x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs   # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if style == "interleaved":
        x1 = x[..., 0::2].float()
        x2 = x[..., 1::2].float()
        rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                              dim=-1).reshape(x.shape)
    elif style == "rotate_half":
        half = head_dim // 2
        x1 = x[..., :half].float()
        x2 = x[..., half:].float()
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                            dim=-1)
    else:
        raise ValueError(
            "Unknown RoPE style {!r}; expected 'interleaved' or "
            "'rotate_half'.".format(style))
    if scaling is not None and scaling.kind == "yarn":
        rotated = rotated * yarn_attention_factor(scaling)
    return rotated.to(x.dtype)


class FusedRMSNorm(nn.Module):
    """RMSNorm with its scale ([features] f32, ones at init): called, it
    runs `ops.fused_norm.fused_rmsnorm` (the kernel on the card) and
    returns normed, or (normed, h = x + residual) with a residual;
    `plain(x)` is flax `nn.RMSNorm` (f32 statistics, one cast), which
    the JAX model uses where the fused tail does not apply."""

    def __init__(self, features, eps=1e-6, dtype=None, impl="auto",
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.impl = impl
        self.weight = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x, residual=None):
        normed, h = norm_ops.fused_rmsnorm(x, self.weight, residual=residual,
                                           eps=self.eps, out_dtype=self.dtype,
                                           impl=self.impl)
        return normed if residual is None else (normed, h)

    def plain(self, x):
        return norm_ops.rmsnorm_residual_reference(
            x, self.weight, eps=self.eps, out_dtype=self.dtype)[0]


def _sub_impl(attention_impl):
    """The fused norm's and MLP's impl under the block's attention_impl,
    as the JAX block picks it."""
    return "reference" if attention_impl == "reference" else "auto"


class GQAttention(nn.Module):
    """Grouped-query attention with RoPE and an H_kv-wide decode
    cache."""

    def __init__(self, d_model, num_heads, num_kv_heads, cast,
                 attention_impl="auto", rope_theta=10000.0,
                 rope_style="interleaved", head_dim=None, rope_scaling=None,
                 sliding_window=None, qkv_bias=False, attn_scale=None,
                 logit_softcap=None, qk_norm=False, norm_eps=1e-6,
                 device=None):
        super().__init__()
        if attention_impl in _SEQUENCE_PARALLEL:
            raise NotImplementedError(
                "attention_impl={!r} (sequence-parallel attention) is not "
                "ported yet (ROADMAP: Modules to port, item 6, parallel/)."
                .format(attention_impl))
        if num_heads % num_kv_heads:
            raise ValueError("num_heads={} must be a multiple of "
                             "num_kv_heads={}.".format(num_heads,
                                                       num_kv_heads))
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim or d_model // num_heads
        self._cast = cast
        self.attention_impl = attention_impl
        self.rope_theta = rope_theta
        self.rope_style = rope_style
        self.rope_scaling = rope_scaling
        self.sliding_window = sliding_window
        self.attn_scale = attn_scale
        self.logit_softcap = logit_softcap
        self.qk_norm = qk_norm
        hd = self.head_dim
        self.query = nn.Linear(d_model, num_heads * hd, bias=qkv_bias,
                               device=device)
        self.key = nn.Linear(d_model, num_kv_heads * hd, bias=qkv_bias,
                             device=device)
        self.value = nn.Linear(d_model, num_kv_heads * hd, bias=qkv_bias,
                               device=device)
        self.out = nn.Linear(num_heads * hd, d_model, bias=False,
                             device=device)
        if qk_norm:
            self.q_norm = FusedRMSNorm(hd, norm_eps, cast.dtype, device=device)
            self.k_norm = FusedRMSNorm(hd, norm_eps, cast.dtype, device=device)

    def _project(self, layer, x, heads):
        cast = self._cast
        y = F.linear(x, cast(layer.weight), cast(layer.bias))
        return y.view(x.shape[0], x.shape[1], heads, self.head_dim)

    def _rope(self, x, positions):
        return apply_rope(x, positions, self.rope_theta, self.rope_style,
                          self.rope_scaling)

    def forward(self, x, mask=None, cache=None):
        """Without `cache`: training attention at positions 0..S-1, mask
        (optional [B, S]) marking the keys attention may see. With a
        layer's dense `cache`: decode (`_decode_attention`), mask marking
        the REAL incoming tokens."""
        q = self._project(self.query, x, self.num_heads)
        k = self._project(self.key, x, self.num_kv_heads)
        v = self._project(self.value, x, self.num_kv_heads)
        if self.qk_norm:
            # Plain, as in JAX (nn.RMSNorm over head_dim), before RoPE.
            q = self.q_norm.plain(q)
            k = self.k_norm.plain(k)
        if cache is not None:
            out = self._decode_attention(q, k, v, mask, cache)
        else:
            positions = torch.arange(x.shape[1], device=x.device)
            q = self._rope(q, positions)
            k = self._rope(k, positions)
            out = attention_ops.attention(
                q, k, v, causal=True, mask=mask,
                sm_scale=self.attn_scale, window=self.sliding_window,
                logit_softcap=self.logit_softcap, impl=self.attention_impl)
        out = out.to(self._cast.dtype).reshape(x.shape[0], x.shape[1], -1)
        return F.linear(out, self._cast(self.out.weight))

    def _decode_attention(self, q, k, v, mask, cache):
        """Attention over the dense cache, one path for prefill (the
        whole prompt at index 0) and single-token steps.

        The cache is slot-addressed (write pointer `cache_index`), and
        RoPE and the window band use each example's logical positions
        (`slot_pos`, real tokens only), so a left-padded prompt rotates
        and bands as its unpadded rows would; padded slots are never
        attended. q attends its own kv head as [B, S, H_kv, G, D] (no
        repeat of the cache), with f32 logits from f32 copies of q and
        the cache (JAX's preferred_element_type=f32), the softcap, masked
        logits -1e30 and an f32 softmax whose weights are rounded to the
        compute dtype before the product with V. The products read only
        the written prefix [:idx + S] of the cache: every slot past it is
        masked, so the result is JAX's, which reads all L."""
        batch, seq, heads, head_dim = q.shape
        cache_len = cache["cached_key"].shape[1]
        idx, positions, allowed = decoding.decode_slot_update(
            cache, mask, batch, seq, cache_len)
        q = self._rope(q, positions)
        k = self._rope(k, positions)
        dtype = self._cast.dtype
        end = idx + seq
        cache["cached_key"][:, idx:end] = k.to(dtype)
        cache["cached_value"][:, idx:end] = v.to(dtype)
        keys = cache["cached_key"][:, :end]
        values = cache["cached_value"][:, :end]
        allowed = allowed[:, :, :end]
        if self.sliding_window:
            # Keys in (pos - window, pos] on logical positions; older
            # cached entries are masked, not evicted.
            allowed = allowed & (cache["slot_pos"][:, None, :end]
                                 > positions[:, :, None]
                                 - self.sliding_window)
        scale = self.attn_scale or 1.0 / math.sqrt(head_dim)
        group = heads // self.num_kv_heads
        qg = q.reshape(batch, seq, self.num_kv_heads, group, head_dim)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                              keys.float()) * scale
        if self.logit_softcap:
            cap = float(self.logit_softcap)
            logits = cap * torch.tanh(logits / cap)
        logits = torch.where(allowed[:, None, None], logits,
                             torch.full((), -1e30, device=logits.device))
        weights = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", weights.float(),
                           values.float())
        return out.reshape(batch, seq, heads, head_dim).to(dtype)


class SwiGLU(nn.Module):
    """Gated MLP down(act(gate(x)) * up(x)), bias-free, through
    `ops.fused_mlp.fused_swiglu`; weights [out, in]."""

    def __init__(self, d_model, d_ff, cast, activation="silu", impl="auto",
                 device=None):
        super().__init__()
        mlp_ops._activation(activation)
        self._cast = cast
        self.activation = activation
        self.impl = impl
        self.gate = nn.Linear(d_model, d_ff, bias=False, device=device)
        self.up = nn.Linear(d_model, d_ff, bias=False, device=device)
        self.down = nn.Linear(d_ff, d_model, bias=False, device=device)

    def forward(self, x):
        cast = self._cast
        return mlp_ops.fused_swiglu(
            x, cast(self.gate.weight), cast(self.up.weight),
            cast(self.down.weight), activation=self.activation,
            compute_dtype=cast.dtype, impl=self.impl)


class LlamaBlock(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then the fused residual-add +
    norm, the MLP (or the MoE, `moe_experts > 0`) and the second
    residual add (see the module doc)."""

    def __init__(self, d_model, num_heads, num_kv_heads, d_ff, cast,
                 attention_impl="auto", rope_theta=10000.0,
                 rope_style="interleaved", norm_eps=1e-6, dropout_rate=0.0,
                 head_dim=None, rope_scaling=None, sliding_window=None,
                 qkv_bias=False, mlp_activation="silu", post_norms=False,
                 attn_scale=None, logit_softcap=None, qk_norm=False,
                 moe_experts=0, moe_top_k=2, moe_capacity_factor=2.0,
                 moe_norm_topk=True, device=None):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.post_norms = post_norms
        impl = _sub_impl(attention_impl)

        def norm():
            return FusedRMSNorm(d_model, norm_eps, cast.dtype, impl,
                                device=device)

        self.norm_attn = norm()
        self.attention = GQAttention(
            d_model, num_heads, num_kv_heads, cast,
            attention_impl=attention_impl, rope_theta=rope_theta,
            rope_style=rope_style, head_dim=head_dim,
            rope_scaling=rope_scaling, sliding_window=sliding_window,
            qkv_bias=qkv_bias, attn_scale=attn_scale,
            logit_softcap=logit_softcap, qk_norm=qk_norm, norm_eps=norm_eps,
            device=device)
        self.norm_mlp = norm()
        if moe_experts:
            self.moe = TopKMoEMLP(
                d_model, num_experts=moe_experts, top_k=moe_top_k,
                d_ff=d_ff, capacity_factor=moe_capacity_factor,
                compute_dtype=cast.dtype, activation=mlp_activation,
                norm_topk=moe_norm_topk, cast=cast, device=device)
        else:
            self.mlp = SwiGLU(d_model, d_ff, cast, activation=mlp_activation,
                              impl=impl, device=device)
        if post_norms:
            self.norm_attn_post = norm()
            self.norm_mlp_post = norm()

    def forward(self, x, mask=None, generator=None, cache=None,
                losses=None):
        """generator: a `torch.Generator` on x's device when dropout is
        on for this call (None = deterministic). cache: this layer's
        decode cache (None = training forward); decode runs without
        dropout and so on the fused tail, as the JAX decoder (cloned
        with dropout_rate 0) does. losses: a list the MoE's aux loss is
        appended to (None: not collected)."""
        y = self.attention(self.norm_attn(x), mask, cache)
        if self.post_norms:
            y = self.norm_attn_post.plain(y)
        if self.dropout_rate and cache is None:
            # Dropout sits between the sublayer output and the residual
            # add, so the fused tail does not apply.
            if generator is not None:
                y = _dropout(y, self.dropout_rate, generator)
            x = x + y
            y = self.norm_mlp.plain(x)
        else:
            y, x = self.norm_mlp(y, residual=x)
        if hasattr(self, "moe"):
            y, aux_loss = self.moe(y)
            if losses is not None:
                losses.append(aux_loss)
        else:
            y = self.mlp(y)
        if self.post_norms:
            y = self.norm_mlp_post.plain(y)
        if self.dropout_rate and generator is not None:
            y = _dropout(y, self.dropout_rate, generator)
        return x + y


class LlamaLM(nn.Module):
    """Llama-style decoder-only LM.

    The attribute names and defaults are the JAX `LlamaLM`'s, plus
    `device` (default: the CUDA card; raises without one) and `seed`:
    weights are drawn from it (normal, std 0.02; biases 0, norm scales
    1). Load real ones with `load_state_dict` (see
    `llama_params_from_flax`, `import_hf_llama`). `decode` is kept for
    the JAX signature: the port decodes whenever `forward` is given a
    cache (`init_cache`), and `generate()` drives that. With
    `moe_experts > 0` every block's MLP is a `TopKMoEMLP` (E experts of
    width d_ff, top `moe_top_k`); `aux_losses` holds each block's aux
    loss from the last training forward (module doc).
    """

    def __init__(self, vocab_size=32000, num_layers=4, num_heads=8,
                 num_kv_heads=None, d_model=512, d_ff=1408, max_seq_len=2048,
                 rope_theta=10000.0, rope_style="interleaved", norm_eps=1e-6,
                 dropout_rate=0.0, compute_dtype=torch.bfloat16,
                 attention_impl="auto", decode=False, head_dim=None,
                 rope_scaling=None, sliding_window=None, qkv_bias=False,
                 mlp_activation="silu", scale_embed=False,
                 post_block_norms=False, attn_scale=None,
                 attn_logit_softcap=None, final_logit_softcap=None,
                 qk_norm=False, attn_kinds=None, rope_theta_local=None,
                 rope_scaling_local=None, moe_experts=0, moe_top_k=2,
                 moe_capacity_factor=2.0, moe_norm_topk=True, device=None,
                 seed=0):
        super().__init__()
        device = runtime.resolve_device(device)
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.d_model = d_model
        self.d_ff = d_ff
        self.max_seq_len = max_seq_len
        self.rope_theta = rope_theta
        self.rope_style = rope_style
        self.norm_eps = norm_eps
        self.dropout_rate = float(dropout_rate)
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.decode = bool(decode)
        self.head_dim = head_dim or d_model // num_heads
        self.rope_scaling = rope_scaling
        self.sliding_window = sliding_window
        self.qkv_bias = qkv_bias
        self.mlp_activation = mlp_activation
        self.scale_embed = scale_embed
        self.post_block_norms = post_block_norms
        self.attn_scale = attn_scale
        self.attn_logit_softcap = attn_logit_softcap
        self.final_logit_softcap = final_logit_softcap
        self.qk_norm = qk_norm
        self.attn_kinds = attn_kinds
        self.rope_theta_local = rope_theta_local
        self.rope_scaling_local = rope_scaling_local
        self.moe_experts = moe_experts
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_norm_topk = moe_norm_topk
        #: Each MoE block's aux loss from the last training forward.
        self.aux_losses = []
        self._cast = _ComputeWeights(compute_dtype)
        self.embed = nn.Embedding(vocab_size, d_model, device=device)
        blocks = []
        for i in range(num_layers):
            window, theta, scaling = self._layer_attn(i)
            blocks.append(LlamaBlock(
                d_model, num_heads, self.num_kv_heads, d_ff, self._cast,
                attention_impl=attention_impl, rope_theta=theta,
                rope_style=rope_style, norm_eps=norm_eps,
                dropout_rate=dropout_rate, head_dim=head_dim,
                rope_scaling=scaling, sliding_window=window,
                qkv_bias=qkv_bias, mlp_activation=mlp_activation,
                post_norms=post_block_norms, attn_scale=attn_scale,
                logit_softcap=attn_logit_softcap, qk_norm=qk_norm,
                moe_experts=moe_experts, moe_top_k=moe_top_k,
                moe_capacity_factor=moe_capacity_factor,
                moe_norm_topk=moe_norm_topk, device=device))
        self.blocks = nn.ModuleList(blocks)
        self.norm_final = FusedRMSNorm(d_model, norm_eps, compute_dtype,
                                       _sub_impl(attention_impl),
                                       device=device)
        self.lm_head = nn.Linear(d_model, vocab_size, bias=False,
                                 device=device)
        if seed is not None:
            self.reset_parameters(seed)

    @property
    def device(self):
        return self.embed.weight.device

    def _layer_attn(self, i):
        """(window, theta, scaling) for layer i under attn_kinds."""
        if self.attn_kinds is None:
            return self.sliding_window, self.rope_theta, self.rope_scaling
        kind = self.attn_kinds[i % len(self.attn_kinds)]
        if kind == "global":
            return None, self.rope_theta, self.rope_scaling
        if kind != "local":
            raise ValueError(
                "attn_kinds entries must be 'local' or 'global'; got "
                "{!r}.".format(kind))
        if not self.sliding_window:
            raise ValueError(
                "attn_kinds includes 'local' layers but sliding_window "
                "is not set.")
        return (self.sliding_window,
                self.rope_theta_local or self.rope_theta,
                self.rope_scaling_local)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """Seeded init, drawn on the CPU so it is the same on any
        device."""
        gen = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                value = torch.zeros(p.shape)
            elif p.ndim == 1:
                value = torch.ones(p.shape)
            else:
                value = torch.randn(p.shape, generator=gen) * 0.02
            p.copy_(value)

    def init_cache(self, batch):
        """A zeroed dense decode cache for `batch` rows: per layer K/V
        [batch, max_seq_len, H_kv, head_dim] in the compute dtype and the
        slot bookkeeping (`decoding.dense_cache_layer`)."""
        return {"layers": [decoding.dense_cache_layer(self, batch)
                           for _ in range(self.num_layers)]}

    def forward(self, tokens, mask=None, cache=None, deterministic=True,
                generator=None):
        """tokens [B, S] -> f32 logits [B, S, V].

        Without `cache`: the training/scoring forward at positions
        0..S-1; mask (optional [B, S] bool) marks the keys attention may
        see; `deterministic=False` with `generator` (a `torch.Generator`
        on the model's device) applies dropout. In training mode it
        leaves the MoE blocks' aux losses in `aux_losses`.

        With `cache` (`init_cache`): decode, appending to the cache,
        without gradients. mask marks REAL incoming tokens: positions
        count only real tokens, so a left-padded prompt rotates as its
        unpadded rows would.
        """
        seq = tokens.shape[1]
        if seq > self.max_seq_len:
            raise ValueError(
                "Sequence length {} exceeds max_seq_len {}.".format(
                    seq, self.max_seq_len))
        self.aux_losses = []
        if cache is not None:
            with torch.no_grad():
                x = self._embed(tokens)
                for block, layer_cache in zip(self.blocks, cache["layers"]):
                    x = block(x, mask, cache=layer_cache)
                return self._head(x)
        gen = None if deterministic else generator
        losses = [] if self.training and self.moe_experts else None
        x = self._embed(tokens)
        for block in self.blocks:
            x = block(x, mask, generator=gen, losses=losses)
        self.aux_losses = losses or []
        return self._head(x)

    def _embed(self, tokens):
        dtype = self.compute_dtype
        x = self.embed.weight[tokens].to(dtype)
        if self.scale_embed:
            # The normalizer is rounded to the compute dtype first (a 0-d
            # CPU tensor, read on the host, as theta in apply_rope).
            x = x * torch.tensor(math.sqrt(self.d_model), dtype=dtype)
        return x

    def _head(self, x):
        """The final norm and the head in the compute dtype, then f32
        logits (soft-capped with `final_logit_softcap`), as in JAX and in
        training and decode alike."""
        x = self.norm_final(x)
        logits = F.linear(x, self._cast(self.lm_head.weight)).float()
        if self.final_logit_softcap:
            cap = float(self.final_logit_softcap)
            logits = cap * torch.tanh(logits / cap)
        return logits


__all__ = ["FusedRMSNorm", "GQAttention", "LlamaBlock", "LlamaLM",
           "QWEN3_30B_A3B", "RopeScaling", "SwiGLU", "TINYLLAMA_1_1B",
           "apply_rope", "yarn_attention_factor"]
