"""Flash attention: the training path's attention, forward and backward.

The port of `cloud_tpu/ops/attention.py`. Layout `[batch, seq, heads,
head_dim]` at every public function, as in the JAX package.

`attention` and `flash_attention` work by where their tensors lie:

- CPU tensors take `mha_reference`, the plain PyTorch version (autograd
  gives its gradients).
- CUDA tensors run `_FlashAttention`, one `torch.autograd.Function` over
  the three hand-written kernels of `csrc/flash_attention.cu` (forward;
  dq; dk/dv), or raise. There is no switch that sends a CUDA tensor to
  the plain version.

The contract is the JAX `flash_attention`'s: causal or not, `sm_scale`
(default 1/sqrt(D)), a per-example key mask `[B, S]` (True = attend),
grouped-query attention (k/v with H_kv heads, H a multiple of H_kv), a
sliding `window` (row i sees keys (i - window, i]; causal only) and a
Gemma2-style `logit_softcap` (cap * tanh(s / cap) after the scale,
before masking). A query row with no allowed key comes out as zeros and
passes no gradient, in both versions.

The kernels take bf16 or f32 q/k/v (all one type) at any head_dim,
accumulate in f32 and return the input type; anything else raises. A
head_dim up to 256 that is a multiple of 8 runs at the next template
width (64, 128 or 256) on zero-filled columns past D; a head_dim above
256 runs the wide kernels (`csrc/flash_attention_wide.cu`: the outputs
in column chunks, the scores recomputed by each chunk's block);
`kernel_library` picks the route. Any head_dim that is not a multiple of
8 goes to the kernels as a copy zero-padded to the next multiple of 8
(`_layout.pad_last`: rows 16 bytes apart), whose output is sliced back
to D. The default sm_scale is 1/sqrt(D) of the true D. An operand (q, k,
v or the backward's dO) that is not contiguous or not 16-byte aligned
goes to the kernels as a contiguous copy.
"""

import ctypes
import math

import torch

from cloud_tpu_torch.ops._layout import dense, pad_last

_NEG_INF = -1e30

#: Launches of each CUDA kernel since the last reset: one per call of the
#: wrapper that reaches the kernel, counted where it launches.
launches = {"flash_attention_fwd": 0, "flash_attention_dq": 0,
            "flash_attention_dkdv": 0}

_KINDS = {torch.float32: 0, torch.bfloat16: 1}
#: The widest head_dim of the template kernels; wider ones run the wide
#: kernels.
MAX_TEMPLATE_HEAD_DIM = 256
#: The widest head_dim the C interface carries (a 16-bit field).
MAX_HEAD_DIM = 32767


def reset_launches():
    for name in launches:
        launches[name] = 0


def repeat_kv(k, num_heads):
    """Broadcasts [B, S, H_kv, D] key/value heads to num_heads (each kv
    head serves num_heads // H_kv consecutive q heads)."""
    h_kv = k.shape[2]
    if num_heads == h_kv:
        return k
    if num_heads % h_kv:
        raise ValueError(
            "num_heads=%d must be a multiple of num_kv_heads=%d."
            % (num_heads, h_kv))
    return torch.repeat_interleave(k, num_heads // h_kv, dim=2)


def _check_args(q, k, v, causal, mask, window):
    """The JAX `flash_attention` argument checks; returns (heads, h_kv)."""
    if v.shape != k.shape:
        raise ValueError("k and v must have identical shapes; got "
                         "{} vs {}.".format(tuple(k.shape), tuple(v.shape)))
    heads, h_kv = q.shape[2], k.shape[2]
    if heads % h_kv:
        raise ValueError(
            "q heads {} must be a multiple of kv heads {}.".format(
                heads, h_kv))
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True.")
    batch, seq = q.shape[:2]
    if mask is not None and tuple(mask.shape) != (batch, seq):
        raise ValueError("mask must be [batch, seq] = {}; got {}.".format(
            (batch, seq), tuple(mask.shape)))
    return heads, h_kv


def _weights(q, k, causal, sm_scale, mask, window, logit_softcap):
    """The softmax weights [B, H, S_q, S_k] in f32 and the softcap's
    derivative at each logit (None without a cap): f32 logits; the
    softcap before any masking; the window band col in (row - window,
    row]; masked logits -1e30; rows with every key masked give zero
    weights."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    k = repeat_kv(k, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * sm_scale
    dcap = None
    if logit_softcap:
        cap = float(logit_softcap)
        th = torch.tanh(logits / cap)
        logits = cap * th
        dcap = 1 - th * th
    seq_q, seq_k = q.shape[1], k.shape[1]
    neg = torch.full((), _NEG_INF, device=logits.device)
    if causal:
        row = torch.arange(seq_q, device=q.device)[:, None]
        col = torch.arange(seq_k, device=q.device)[None, :]
        allowed = col <= row
        if window is not None:
            allowed = allowed & (col > row - int(window))
        logits = torch.where(allowed, logits, neg)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :].bool(), logits, neg)
    weights = torch.softmax(logits, dim=-1)
    if causal or mask is not None:
        all_masked = logits.amax(dim=-1, keepdim=True) <= _NEG_INF / 2
        weights = torch.where(all_masked, torch.zeros((), device=q.device),
                              weights)
    return weights, dcap


def mha_reference(q, k, v, causal=True, sm_scale=None, mask=None,
                  window=None, logit_softcap=None):
    """Plain multi-head attention, layout [B, S, H, D] (the kernels'
    oracle; weights as `_weights` makes them). The weights are cast to
    v's dtype before the product with v, as the kernels round P."""
    _check_args(q, k, v, causal, mask, window)
    weights, _ = _weights(q, k, causal, sm_scale, mask, window,
                          logit_softcap)
    weights = weights.to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", weights,
                       repeat_kv(v, q.shape[2]).float())
    return out.to(v.dtype)


def mha_backward_reference(q, k, v, dout, delta, causal=True,
                           sm_scale=None, mask=None, window=None,
                           logit_softcap=None):
    """The plain version of the dq and dk/dv kernels, on their inputs:
    (dq, dk, dv) in f32 from q, k, v, dO and delta = rowsum(dO * O)
    [B, H, S] as the flash backward is given it (from the forward's
    output in its dtype). dS = P (dP - delta) sm_scale (1 - tanh^2 of
    the uncapped logit under a softcap); dk and dv sum over each GQA
    group. With delta from an exact O it equals the autograd gradients
    of `mha_reference` in f32."""
    _check_args(q, k, v, causal, mask, window)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    batch, seq, heads, head_dim = q.shape
    h_kv = k.shape[2]
    with torch.no_grad():
        p, dcap = _weights(q, k, causal, sm_scale, mask, window,
                           logit_softcap)
        dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(),
                          repeat_kv(v, heads).float())
        ds = p * (dp - delta.float()[..., None]) * sm_scale
        if dcap is not None:
            ds = ds * dcap
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, repeat_kv(k, heads).float())
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
        dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
        group = (batch, seq, h_kv, heads // h_kv, head_dim)
        return dq, dk.reshape(group).sum(3), dv.reshape(group).sum(3)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def kernel_library(dtype, head_dim):
    """The CUDA source whose kernels a call at this dtype and (padded)
    head_dim launches: `flash_attention_wide` above
    MAX_TEMPLATE_HEAD_DIM (both types), else `flash_attention` (bf16) or
    `flash_attention_f32`. Pure Python: it builds nothing."""
    if head_dim > MAX_TEMPLATE_HEAD_DIM:
        return "flash_attention_wide"
    return ("flash_attention" if dtype == torch.bfloat16
            else "flash_attention_f32")


def _library(dtype, head_dim):
    """The kernels' library for q/k/v of `dtype` at `head_dim`
    (`kernel_library`; three sources, so that they build in parallel);
    each exports the same three functions."""
    from cloud_tpu_torch.ops import _build

    lib = _build.load(kernel_library(dtype, head_dim))
    ints = [ctypes.c_int] * 7        # batch seq heads kv_heads D causal win
    tail = [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    specs = {
        "flash_attention_forward": 6,
        "flash_attention_backward_dq": 8,
        "flash_attention_backward_dkdv": 9,
    }
    for name, pointers in specs.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * pointers
                           + ints + tail)
            fn.restype = ctypes.c_int
    return lib


def _check_kernel_operands(q, k, v, mask):
    """What the CUDA kernels take: one CUDA device, one dtype (f32 or
    bf16), head_dim from 1 to MAX_HEAD_DIM."""
    for t in (k, v) + (() if mask is None else (mask,)):
        if t.device != q.device:
            raise ValueError("flash_attention operands must share one "
                             "device; got {} and {}.".format(t.device,
                                                             q.device))
    if q.dtype not in _KINDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            "the CUDA kernels take q/k/v all float32 or all bfloat16; "
            "got {}, {}, {}.".format(q.dtype, k.dtype, v.dtype))
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError("the CUDA kernels take head_dim from 1 to {}; got "
                         "{}.".format(MAX_HEAD_DIM, q.shape[-1]))
    if q.shape[-1] != k.shape[-1] or q.shape[1] != k.shape[1] \
            or q.shape[0] != k.shape[0]:
        raise ValueError("q [B, S, H, D] and k/v [B, S, H_kv, D] must "
                         "agree on B, S and D; got {} and {}.".format(
                             tuple(q.shape), tuple(k.shape)))


def _scalars(q, k, config):
    batch, seq, heads, head_dim = q.shape
    causal, sm_scale, window, softcap = config
    return (batch, seq, heads, k.shape[2], head_dim, int(causal),
            int(window or 0), float(sm_scale), float(softcap or 0.0))


def _mask_arg(mask):
    return None if mask is None else mask.data_ptr()


def _launch_forward(q, k, v, mask, config):
    """Forward kernel: (out [B, S, H, D] in q's dtype, lse [B, H, S]
    f32)."""
    from cloud_tpu_torch.ops import _build

    batch, seq, heads = q.shape[:3]
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, seq), dtype=torch.float32,
                      device=q.device)
    fn = _library(q.dtype, q.shape[-1]).flash_attention_forward
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_KINDS[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 _mask_arg(mask), out.data_ptr(), lse.data_ptr(),
                 *_scalars(q, k, config), stream)
    _build.check(err, "flash_attention forward kernel launch")
    launches["flash_attention_fwd"] += 1
    return out, lse


def _launch_dq(q, k, v, mask, dout, lse, delta, config):
    from cloud_tpu_torch.ops import _build

    dq = torch.empty_like(q)
    fn = _library(q.dtype, q.shape[-1]).flash_attention_backward_dq
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_KINDS[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 _mask_arg(mask), dout.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), *_scalars(q, k, config),
                 stream)
    _build.check(err, "flash_attention dq kernel launch")
    launches["flash_attention_dq"] += 1
    return dq


def _launch_dkdv(q, k, v, mask, dout, lse, delta, config):
    from cloud_tpu_torch.ops import _build

    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _library(q.dtype, q.shape[-1]).flash_attention_backward_dkdv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_KINDS[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 _mask_arg(mask), dout.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 *_scalars(q, k, config), stream)
    _build.check(err, "flash_attention dk/dv kernel launch")
    launches["flash_attention_dkdv"] += 1
    return dk, dv


def _delta(dout, out):
    """rowsum(dO * O) in f32, [B, H, S] (outside the kernels, as the JAX
    backward computes it): one f32 copy of dO, multiplied in place by O
    (the same f32 products as casting both)."""
    prod = dout.to(torch.float32, copy=True).mul_(out)
    return prod.sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v): the forward kernel, then dq and dk/dv
    kernels from the saved lse. `mask` is a [B, S] bool tensor or None;
    `config` is (causal, sm_scale, window, softcap)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, config):
        out, lse = _launch_forward(q, k, v, mask, config)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.config = config
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dout = dense(dout)
        delta = _delta(dout, out)
        dq = _launch_dq(q, k, v, mask, dout, lse, delta, ctx.config)
        dk, dv = _launch_dkdv(q, k, v, mask, dout, lse, delta, ctx.config)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, sm_scale=None, mask=None,
                    window=None, logit_softcap=None):
    """Blockwise flash attention, layout [batch, seq, heads, head_dim].

    Args:
        q: [B, S, H, D]; k, v: [B, S, H_kv, D] (H a multiple of H_kv).
        causal: apply the causal mask.
        sm_scale: softmax temperature; default 1/sqrt(D) (the true D,
            also when the kernels run on a zero-padded copy).
        mask: optional [B, S] bool key mask (True = attend).
        window: sliding-window width (causal only); None/0 = off.
        logit_softcap: tanh logit cap; None/0 = off.

    Returns:
        [B, S, H, D] in q's dtype, differentiable in q, k, v. CPU tensors
        run `mha_reference`; CUDA tensors run the CUDA kernels or raise.
    """
    _check_args(q, k, v, causal, mask, window)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                             mask=mask, window=window,
                             logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError("flash_attention runs on CPU or CUDA tensors; got "
                         "{}.".format(q.device))
    if mask is not None:
        mask = mask.to(torch.bool).contiguous()
    _check_kernel_operands(q, k, v, mask)
    head_dim = q.shape[-1]
    q, k, v = (dense(pad_last(t, 8)) for t in (q, k, v))
    config = (bool(causal), float(sm_scale), int(window or 0),
              float(logit_softcap or 0.0))
    out = _FlashAttention.apply(q, k, v, mask, config)
    return out if out.shape[-1] == head_dim else out[..., :head_dim]


def attention(q, k, v, causal=True, sm_scale=None, mask=None, window=None,
              logit_softcap=None, impl="auto"):
    """Dispatching attention, by where the tensors lie: CPU tensors take
    `mha_reference`, CUDA tensors the flash kernels (or raise).

    impl is accepted for signature parity with the JAX package: "auto"
    and "flash" are valid; "reference" is refused on CUDA tensors (the
    plain version is for the CPU and for comparisons only).
    """
    if impl not in ("auto", "flash", "reference"):
        raise ValueError("Unknown attention impl: {!r}".format(impl))
    if impl == "reference" and q.device.type == "cuda":
        raise ValueError("impl='reference' does not run on CUDA tensors; "
                         "CUDA tensors take the flash kernels.")
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                           mask=mask, window=window,
                           logit_softcap=logit_softcap)


def allowed_pairs(seq, causal=True, window=None):
    """Number of (query row, key) pairs one head of one example attends:
    all S^2, or the causal triangle cut to the window band."""
    if not causal:
        return float(seq) * seq
    return float(sum(min(row + 1, int(window) if window else row + 1)
                     for row in range(seq)))


def flash_attention_cost(batch, seq, heads, kv_heads, head_dim, causal=True,
                         window=None, dtype=torch.bfloat16):
    """Work of one call of each kernel at these shapes (no key mask), for
    bounds.

    flops count 2 per multiply-add over the allowed (row, key) pairs
    (`allowed_pairs`): the forward does two products (QK^T, PV); dq
    three (QK^T again, dO V^T, dS K); dk/dv four (QK^T, dO V^T, P^T dO,
    dS^T Q). bytes count each input read once and each output written
    once: q/k/v (+ dO, lse, delta in the backward), out and lse
    (forward), dq (dq), dk and dv (dk/dv).
    Returns {"forward"|"dq"|"dkdv": {"flops", "bytes_moved"}}.
    """
    item = torch.empty((), dtype=dtype).element_size()
    pairs = allowed_pairs(seq, causal, window) * batch * heads
    mm = 2.0 * pairs * head_dim                   # flops of one product
    q_bytes = float(batch * seq * heads * head_dim * item)
    kv_bytes = float(batch * seq * kv_heads * head_dim * item)
    row_bytes = float(batch * heads * seq * 4)    # lse or delta
    inputs = q_bytes + 2 * kv_bytes
    return {
        "forward": {"flops": 2 * mm,
                    "bytes_moved": inputs + q_bytes + row_bytes},
        "dq": {"flops": 3 * mm,
               "bytes_moved": inputs + q_bytes + 2 * row_bytes + q_bytes},
        "dkdv": {"flops": 4 * mm,
                 "bytes_moved": (inputs + q_bytes + 2 * row_bytes
                                 + 2 * kv_bytes)},
    }


__all__ = ["allowed_pairs", "attention", "flash_attention",
           "flash_attention_cost", "kernel_library", "launches",
           "mha_backward_reference", "mha_reference", "repeat_kv",
           "reset_launches"]
