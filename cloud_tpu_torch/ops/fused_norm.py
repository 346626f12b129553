"""Fused residual-add + RMSNorm: the Llama block's norm tail.

The port of `cloud_tpu/ops/fused_norm.py`. `fused_rmsnorm(x, scale,
residual)` returns `(normed, h)`: `h = x + residual` (x itself without
a residual) is the continuing residual stream, rounded to its dtype
before any statistics are taken, and `normed = h * (rsqrt(mean(h^2) +
eps) * scale)` with f32 statistics and one cast to `out_dtype` at the
end, which is flax `RMSNorm` math for math.

It works by where its tensors lie:

- CPU tensors take `rmsnorm_residual_reference`, the plain version;
- CUDA tensors launch the hand-written kernel of `csrc/fused_norm.cu`
  (one warp per row, one pass that adds, writes h and sums h^2, a second
  that scales and writes normed) or raise. There is no switch that sends
  a CUDA tensor to the plain version.

The backward is plain PyTorch in f32 on both (`_norm_bwd_math`, the JAX
custom-vjp's math; the JAX package has no backward kernel either): both
inputs of the add receive dh, and dscale sums over rows.

The kernel takes x and residual of one dtype, f32 or bf16, `out_dtype`
f32 or bf16, any row count and a feature count that is a multiple of 8;
anything else raises.
"""

import ctypes

import torch

#: Launches of each CUDA kernel since the last reset, counted where the
#: wrapper launches it.
launches = {"fused_norm": 0, "fused_norm_noresidual": 0}

_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for name in launches:
        launches[name] = 0


def rmsnorm_residual_reference(x, scale, residual=None, eps=1e-6,
                               out_dtype=None):
    """Plain fused norm tail: returns (normed, h).

    h = x + residual (in the promoted input dtype) or x; normed is flax
    `RMSNorm(epsilon=eps, dtype=out_dtype)` of h: f32 statistics of the
    rounded h, `h * (rsqrt(var + eps) * scale)`, one cast at the end
    (default: h's dtype)."""
    h = x if residual is None else x + residual
    if out_dtype is None:
        out_dtype = h.dtype
    hf = h.float()
    var = (hf * hf).mean(-1, keepdim=True)
    mul = torch.rsqrt(var + eps) * scale.float()
    return (hf * mul).to(out_dtype), h


def _norm_bwd_math(h, scale, g_normed, g_h, eps):
    """The RMSNorm gradient in f32 from the saved residual stream h
    [rows, D]: dh = g w r - h r^3 / D sum(g w h) (+ the h cotangent);
    dscale = sum over rows of g h r, in scale's dtype."""
    features = h.shape[-1]
    hf = h.float()
    gf = g_normed.float()
    w = scale.float()
    var = (hf * hf).mean(-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    gw = gf * w
    inner = (gw * hf).sum(-1, keepdim=True)
    dh = gw * r - hf * (r * r * r / features) * inner
    if g_h is not None:
        dh = dh + g_h.float()
    dscale = (gf * hf * r).sum(0).to(scale.dtype)
    return dh, dscale


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _library():
    from cloud_tpu_torch.ops import _build

    lib = _build.load("fused_norm")
    for name, pointers in (("fused_rmsnorm_residual", 5),
                           ("fused_rmsnorm_noresidual", 3)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * pointers
                           + [ctypes.c_int] * 2
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _check_kernel_operands(x, scale, residual, out_dtype):
    """What the kernel takes: one CUDA device, x (and residual) f32 or
    bf16 of one dtype, out_dtype f32 or bf16, D a multiple of 8."""
    for t in (scale,) + (() if residual is None else (residual,)):
        if t.device != x.device:
            raise ValueError("fused_rmsnorm operands must share one device; "
                             "got {} and {}.".format(t.device, x.device))
    if x.dtype not in _KINDS or (residual is not None
                                 and residual.dtype != x.dtype):
        raise ValueError(
            "the CUDA kernel takes x (and residual) all float32 or all "
            "bfloat16; got {}{}.".format(
                x.dtype, "" if residual is None else
                " and {}".format(residual.dtype)))
    if out_dtype not in _KINDS:
        raise ValueError("the CUDA kernel writes float32 or bfloat16; got "
                         "out_dtype {}.".format(out_dtype))
    if x.shape[-1] % 8:
        raise ValueError("the CUDA kernel takes a feature count that is a "
                         "multiple of 8; got {}.".format(x.shape[-1]))


def _launch(x, residual, scale, eps, out_dtype):
    """x, residual: [rows, D] contiguous (residual may be None); scale
    [D] f32 contiguous -> (normed [rows, D] out_dtype, h [rows, D] or
    None without a residual)."""
    from cloud_tpu_torch.ops import _build

    rows, features = x.shape
    normed = torch.empty((rows, features), dtype=out_dtype, device=x.device)
    h = None if residual is None else torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if residual is None:
            err = lib.fused_rmsnorm_noresidual(
                _KINDS[x.dtype], _KINDS[out_dtype], x.data_ptr(),
                scale.data_ptr(), normed.data_ptr(), rows, features,
                float(eps), stream)
        else:
            err = lib.fused_rmsnorm_residual(
                _KINDS[x.dtype], _KINDS[out_dtype], x.data_ptr(),
                residual.data_ptr(), scale.data_ptr(), normed.data_ptr(),
                h.data_ptr(), rows, features, float(eps), stream)
    name = "fused_norm" if residual is not None else "fused_norm_noresidual"
    _build.check(err, name + " kernel launch")
    launches[name] += 1
    return normed, h


def _forward(x, residual, scale, eps, out_dtype):
    """The forward on [rows, D] tensors: the plain version for CPU
    tensors, the kernel for CUDA tensors. Returns (normed, h)."""
    if x.device.type == "cpu":
        return rmsnorm_residual_reference(x, scale, residual, eps, out_dtype)
    normed, h = _launch(x, residual, scale.float().contiguous(), eps,
                        out_dtype)
    return normed, (x if h is None else h)


class _FusedRMSNorm(torch.autograd.Function):
    """normed = rmsnorm(x) on [rows, D]; h is x itself and is returned
    by the caller, so its cotangent reaches x through autograd."""

    @staticmethod
    def forward(ctx, x, scale, eps, out_dtype):
        normed, _ = _forward(x, None, scale, eps, out_dtype)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return normed

    @staticmethod
    def backward(ctx, g_normed):
        x, scale = ctx.saved_tensors
        dh, dscale = _norm_bwd_math(x, scale, g_normed, None, ctx.eps)
        return dh.to(x.dtype), dscale, None, None


class _FusedRMSNormResidual(torch.autograd.Function):
    """(normed, h) = (rmsnorm(x + residual), x + residual) on [rows, D];
    both inputs of the add receive dh."""

    @staticmethod
    def forward(ctx, x, residual, scale, eps, out_dtype):
        normed, h = _forward(x, residual, scale, eps, out_dtype)
        ctx.save_for_backward(h, scale)
        ctx.eps = eps
        ctx.dtypes = (x.dtype, residual.dtype)
        return normed, h

    @staticmethod
    def backward(ctx, g_normed, g_h):
        h, scale = ctx.saved_tensors
        dh, dscale = _norm_bwd_math(h, scale, g_normed, g_h, ctx.eps)
        return (dh.to(ctx.dtypes[0]), dh.to(ctx.dtypes[1]), dscale, None,
                None)


def fused_rmsnorm(x, scale, residual=None, eps=1e-6, out_dtype=None,
                  impl="auto"):
    """Fused RMSNorm(+residual) tail: returns (normed, h).

    x: [..., D]; residual: x's shape or None; scale: [D] (the RMSNorm
    scale, f32). h = x + residual (x itself when residual is None);
    normed = RMSNorm(h) in `out_dtype` (default: h's dtype).

    CPU tensors run the plain version, CUDA tensors the kernel (or
    raise); both differentiate in x, residual and scale through the
    same plain f32 backward. impl: "auto" and "fused" take that path;
    "reference" runs `rmsnorm_residual_reference` under autograd and is
    refused on CUDA tensors.
    """
    features = x.shape[-1]
    if tuple(scale.shape) != (features,):
        raise ValueError(
            "scale must be [features] = ({},); got {}.".format(
                features, tuple(scale.shape)))
    if residual is not None and residual.shape != x.shape:
        raise ValueError(
            "residual must match x's shape {}; got {}.".format(
                tuple(x.shape), tuple(residual.shape)))
    if impl not in ("auto", "fused", "reference"):
        raise ValueError("Unknown fused_rmsnorm impl: {!r}".format(impl))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("fused_rmsnorm runs on CPU or CUDA tensors; got "
                         "{}.".format(x.device))
    if impl == "reference":
        if x.device.type == "cuda":
            raise ValueError("impl='reference' does not run on CUDA "
                             "tensors; CUDA tensors take the kernel.")
        return rmsnorm_residual_reference(x, scale, residual=residual,
                                          eps=eps, out_dtype=out_dtype)
    if out_dtype is None:
        out_dtype = x.dtype if residual is None else torch.promote_types(
            x.dtype, residual.dtype)
    if x.device.type == "cuda":
        _check_kernel_operands(x, scale, residual, out_dtype)
    elif scale.device.type != "cpu" or (residual is not None
                                        and residual.device.type != "cpu"):
        raise ValueError("fused_rmsnorm operands must share one device.")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, features).contiguous()
    if residual is None:
        normed = _FusedRMSNorm.apply(x2, scale, float(eps), out_dtype)
        return normed.reshape(lead + (features,)), x
    r2 = residual.reshape(-1, features).contiguous()
    normed, h = _FusedRMSNormResidual.apply(x2, r2, scale, float(eps),
                                            out_dtype)
    return (normed.reshape(lead + (features,)),
            h.reshape(lead + (features,)))


def fused_norm_cost(shape, dtype=torch.bfloat16, with_residual=True):
    """Work of one call at `shape` ([..., D]) with normed in `dtype`, for
    bounds: flops 4 per element (add, square, two scaled multiplies; 3
    without the add); bytes count each input read once and each output
    written once: x (+ residual), normed (+ h), scale. Returns
    {"flops", "bytes_moved"}."""
    rows = 1
    for dim in shape[:-1]:
        rows *= dim
    features = shape[-1]
    n = float(rows * features)
    item = torch.empty((), dtype=dtype).element_size()
    tensors = 4 if with_residual else 2  # x (+ r) in; normed (+ h) out
    return {"flops": (4.0 if with_residual else 3.0) * n,
            "bytes_moved": float(tensors * n * item + features * 4)}


__all__ = ["fused_norm_cost", "fused_rmsnorm", "launches",
           "reset_launches", "rmsnorm_residual_reference"]
