"""Fused gated MLP: down(act(gate(x)) * up(x)), the Llama block's MLP.

The port of `cloud_tpu/ops/fused_mlp.py`. The weights are in the port's
`[out, in]` layout (`nn.Linear`'s): w_gate and w_up `[d_ff, D]`, w_down
`[D_out, d_ff]`. Everything is cast to `compute_dtype` first; g = x
w_gate^T and u = x w_up^T are each rounded to it, act(g) is rounded, the
product act(g) * u is rounded, then the down projection: flax's three
bias-free `Dense` layers, rounding point for rounding point.

It works by where its tensors lie:

- CPU tensors take `swiglu_reference`, the plain version;
- CUDA tensors launch the two hand-written kernels of `csrc/fused_mlp.cu`
  (gate|up with act(g) * u in the epilogue, writing the [rows, d_ff]
  intermediate; then down) or raise. There is no switch that sends a
  CUDA tensor to the plain version, and no product of the forward goes
  to cuBLAS.

In bf16 both kernels are one Hopper GEMM: TMA loads 64-deep k tiles
into a 4-stage shared-memory ring, two consumer warpgroups multiply
with `wgmma` (m64n256k16) while a producer warpgroup keeps the ring
full, and one persistent block per SM walks 128 x 256 output tiles
(gate|up: 128 columns of g and the same 128 of u). The products bound
the work (0.382 ms for gate|up and 0.191 ms for down at 989 TFLOP/s,
rows 8192, D 2048, d_ff 5632). In f32 (the tests' oracle) they are FFMA
kernels.

The backward is plain PyTorch in f32 on both (`_swiglu_bwd`, the JAX
custom-vjp's math: the products recomputed from the saved x and
weights, f32 matrix products throughout).

The kernels take compute dtypes f32 or bf16 and widths D, d_ff and D_out
that are multiples of 8 (TMA reads rows a multiple of 16 bytes apart);
anything else raises. An operand that is not contiguous or not 16-byte
aligned goes to the kernels as a contiguous copy (`_layout.dense`).
"""

import ctypes

import torch
import torch.nn.functional as F

from cloud_tpu_torch.ops._layout import dense

#: Launches of each CUDA kernel since the last reset, counted where the
#: wrapper launches it.
launches = {"fused_mlp_gate_up": 0, "fused_mlp_down": 0}

_KINDS = {torch.float32: 0, torch.bfloat16: 1}

_ACTIVATIONS = {
    "silu": F.silu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": lambda x: F.gelu(x, approximate="none"),
}
# The activation's index in the kernels' epilogue.
_ACT_CODES = {"silu": 0, "gelu_tanh": 1, "gelu": 2}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _activation(name):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            "Unknown mlp activation {!r}; expected one of {}.".format(
                name, sorted(_ACTIVATIONS))) from None


def swiglu_reference(x, w_gate, w_up, w_down, activation="silu",
                     compute_dtype=None):
    """Plain gated MLP: down(act(gate(x)) * up(x)), weights [out, in].

    Everything is cast to `compute_dtype` (default: the promoted type of
    x and w_gate) first; each product returns the compute dtype."""
    act = _activation(activation)
    if compute_dtype is None:
        compute_dtype = torch.promote_types(x.dtype, w_gate.dtype)
    x = x.to(compute_dtype)
    g = F.linear(x, w_gate.to(compute_dtype))
    u = F.linear(x, w_up.to(compute_dtype))
    return F.linear(act(g) * u, w_down.to(compute_dtype))


def swiglu_rounded_reference(x, w_gate, w_up, w_down, activation="silu"):
    """The plain version computed in f32 from compute-dtype x and
    weights, rounded to that dtype exactly where the kernels round (g,
    u, act(g), act(g) * u): returns (a, y) in f32, a the [rows, d_ff]
    intermediate, y unrounded. The card checks hold the kernels against
    it element by element."""
    act = _activation(activation)

    def rnd(t):
        return t.to(x.dtype).float()

    g = rnd(x.float() @ w_gate.float().T)
    u = rnd(x.float() @ w_up.float().T)
    a = rnd(rnd(act(g)) * u)
    del g, u
    return a, a @ w_down.float().T


def _swiglu_bwd(x, w_gate, w_up, w_down, dy, activation):
    """The gated-MLP gradient in f32 from the saved x [rows, D] and the
    weights: returns (dx, dw_gate, dw_up, dw_down) in their dtypes."""
    xf = x.float()
    wgf, wuf, wdf = w_gate.float(), w_up.float(), w_down.float()
    g = xf @ wgf.T
    u = xf @ wuf.T
    with torch.enable_grad():
        gl = g.detach().requires_grad_(True)
        a = _ACTIVATIONS[activation](gl)
    dyf = dy.float()
    dh = dyf @ wdf
    dwd = dyf.T @ (a.detach() * u)
    du = dh * a.detach()
    da = dh * u
    dg, = torch.autograd.grad(a, gl, da)
    dx = dg @ wgf + du @ wuf
    dwg = dg.T @ xf
    dwu = du.T @ xf
    return (dx.to(x.dtype), dwg.to(w_gate.dtype), dwu.to(w_up.dtype),
            dwd.to(w_down.dtype))


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _library():
    from cloud_tpu_torch.ops import _build

    lib = _build.load("fused_mlp")
    fn = lib.fused_mlp_gate_up
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    fn = lib.fused_mlp_down
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_tma_addressable(t, name):
    """Raises ValueError unless TMA can address the matrix t: a base
    16-byte aligned, unit stride along the last dimension, and every
    other stride a multiple of 16 bytes."""
    item = t.element_size()
    if (t.data_ptr() % 16 or t.stride(-1) != 1
            or any(s * item % 16 for s in t.stride()[:-1])):
        raise ValueError(
            "the CUDA kernels read {} with TMA, which takes a 16-byte "
            "aligned base and rows a multiple of 16 bytes apart; got "
            "address {:#x}, strides {} of {}-byte values.".format(
                name, t.data_ptr(), tuple(t.stride()), item))


def _check_kernel_operands(x, w_gate, w_up, w_down, compute_dtype):
    """What the kernels take: one CUDA device, compute dtype f32 or bf16,
    widths that are multiples of 8 (TMA reads rows a multiple of 16
    bytes apart). Layout is not checked: the operands reach the kernels
    through `dense`."""
    for t in (w_gate, w_up, w_down):
        if t.device != x.device:
            raise ValueError("fused_swiglu operands must share one device; "
                             "got {} and {}.".format(t.device, x.device))
    if compute_dtype not in _KINDS:
        raise ValueError("the CUDA kernels compute in float32 or bfloat16; "
                         "got {}.".format(compute_dtype))
    widths = (x.shape[-1], w_gate.shape[0], w_down.shape[0])
    if any(w % 8 for w in widths):
        raise ValueError("the CUDA kernels take D, d_ff and D_out that are "
                         "multiples of 8; got {}.".format(widths))


def launch_gate_up(x, w_gate, w_up, activation):
    """Kernel (a): a [rows, d_ff] = act(x Wg^T) * (x Wu^T) at the
    reference's rounding points; x [rows, D], weights [d_ff, D], all
    in one dtype that TMA can address (raises ValueError otherwise)."""
    from cloud_tpu_torch.ops import _build

    for t, name in ((x, "x"), (w_gate, "w_gate"), (w_up, "w_up")):
        _check_tma_addressable(t, name)
    rows, features = x.shape
    d_ff = w_gate.shape[0]
    a = torch.empty((rows, d_ff), dtype=x.dtype, device=x.device)
    fn = _library().fused_mlp_gate_up
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_KINDS[x.dtype], _ACT_CODES[activation], x.data_ptr(),
                 w_gate.data_ptr(), w_up.data_ptr(), a.data_ptr(), rows,
                 features, d_ff, stream)
    _build.check(err, "fused_mlp gate|up kernel launch")
    launches["fused_mlp_gate_up"] += 1
    return a


def launch_down(a, w_down):
    """Kernel (b): y [rows, D_out] = a Wd^T; a [rows, d_ff], w_down
    [D_out, d_ff], in one dtype that TMA can address (raises ValueError
    otherwise)."""
    from cloud_tpu_torch.ops import _build

    _check_tma_addressable(a, "a")
    _check_tma_addressable(w_down, "w_down")
    rows, d_ff = a.shape
    d_out = w_down.shape[0]
    y = torch.empty((rows, d_out), dtype=a.dtype, device=a.device)
    fn = _library().fused_mlp_down
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(_KINDS[a.dtype], a.data_ptr(), w_down.data_ptr(),
                 y.data_ptr(), rows, d_ff, d_out, stream)
    _build.check(err, "fused_mlp down kernel launch")
    launches["fused_mlp_down"] += 1
    return y


class _FusedSwiGLU(torch.autograd.Function):
    """y = down(act(gate(x)) * up(x)) on x [rows, D] and weights in the
    compute dtype: the plain version on CPU tensors, the two kernels on
    CUDA tensors; the f32 plain backward on both."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, activation):
        if x.device.type == "cpu":
            y = swiglu_reference(x, w_gate, w_up, w_down, activation,
                                 x.dtype)
        else:
            y = launch_down(launch_gate_up(x, w_gate, w_up, activation),
                            w_down)
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        ctx.activation = activation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w_gate, w_up, w_down = ctx.saved_tensors
        grads = _swiglu_bwd(x, w_gate, w_up, w_down, dy, ctx.activation)
        return grads + (None,)


def fused_swiglu(x, w_gate, w_up, w_down, activation="silu",
                 compute_dtype=None, impl="auto"):
    """Fused gated MLP: down(act(gate(x)) * up(x)).

    x: [..., D]; w_gate, w_up: [d_ff, D]; w_down: [D_out, d_ff] (the
    port's [out, in] layout, any parameter dtype: cast to
    `compute_dtype` here, default the promoted type of x and w_gate).
    Returns [..., D_out] in the compute dtype, differentiable in x and
    the three weights.

    CPU tensors run the plain version, CUDA tensors the kernels (or
    raise); both differentiate through the same plain f32 backward.
    impl: "auto" and "fused" take that path; "reference" runs
    `swiglu_reference` under autograd and is refused on CUDA tensors.
    """
    features = x.shape[-1]
    if w_gate.ndim != 2 or w_gate.shape[1] != features:
        raise ValueError(
            "w_gate must be [d_ff, features={}]; got {}.".format(
                features, tuple(w_gate.shape)))
    if w_up.shape != w_gate.shape:
        raise ValueError(
            "w_up must match w_gate's shape {}; got {}.".format(
                tuple(w_gate.shape), tuple(w_up.shape)))
    if w_down.ndim != 2 or w_down.shape[1] != w_gate.shape[0]:
        raise ValueError(
            "w_down must be [d_out, d_ff={}]; got {}.".format(
                w_gate.shape[0], tuple(w_down.shape)))
    _activation(activation)
    if impl not in ("auto", "fused", "reference"):
        raise ValueError("Unknown fused_swiglu impl: {!r}".format(impl))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("fused_swiglu runs on CPU or CUDA tensors; got "
                         "{}.".format(x.device))
    if impl == "reference":
        if x.device.type == "cuda":
            raise ValueError("impl='reference' does not run on CUDA "
                             "tensors; CUDA tensors take the kernels.")
        return swiglu_reference(x, w_gate, w_up, w_down, activation,
                                compute_dtype)
    if compute_dtype is None:
        compute_dtype = torch.promote_types(x.dtype, w_gate.dtype)
    lead = x.shape[:-1]
    x2 = x.to(compute_dtype).reshape(-1, features)
    w_gate, w_up, w_down = (w.to(compute_dtype)
                            for w in (w_gate, w_up, w_down))
    if x.device.type == "cuda":
        _check_kernel_operands(x2, w_gate, w_up, w_down, compute_dtype)
    elif any(w.device.type != "cpu" for w in (w_gate, w_up, w_down)):
        raise ValueError("fused_swiglu operands must share one device.")
    x2, w_gate, w_up, w_down = (dense(t) for t in (x2, w_gate, w_up, w_down))
    y = _FusedSwiGLU.apply(x2, w_gate, w_up, w_down, activation)
    return y.reshape(lead + (w_down.shape[0],))


def fused_mlp_cost(shape, d_ff, dtype=torch.bfloat16):
    """Work of one call at x's `shape` ([..., D]), for bounds, per kernel
    and for the pair: flops 2 per multiply-add of each product (gate|up:
    4 rows D d_ff; down: 2 rows d_ff D_out); bytes count each input read
    once and each output written once, including the [rows, d_ff]
    intermediate that the two-kernel design writes and reads back
    (`intermediate_bytes`; the TPU kernel keeps it in VMEM); D_out = D.
    Returns
    {"gate_up"|"down"|"total": {"flops", "bytes_moved"},
    "intermediate_bytes"}."""
    rows = 1
    for dim in shape[:-1]:
        rows *= dim
    features = d_out = shape[-1]
    item = torch.empty((), dtype=dtype).element_size()
    x_bytes = float(rows * features * item)
    a_bytes = float(rows * d_ff * item)
    y_bytes = float(rows * d_out * item)
    gate_up = {"flops": 4.0 * rows * features * d_ff,
               "bytes_moved": x_bytes + 2.0 * d_ff * features * item
               + a_bytes}
    down = {"flops": 2.0 * rows * d_ff * d_out,
            "bytes_moved": a_bytes + float(d_out * d_ff * item) + y_bytes}
    total = {"flops": gate_up["flops"] + down["flops"],
             "bytes_moved": x_bytes + y_bytes
             + float((2 * features + d_out) * d_ff * item)}
    return {"gate_up": gate_up, "down": down, "total": total,
            "intermediate_bytes": 2.0 * a_bytes}


__all__ = ["fused_mlp_cost", "fused_swiglu", "launch_down", "launch_gate_up",
           "launches", "reset_launches", "swiglu_reference",
           "swiglu_rounded_reference"]
