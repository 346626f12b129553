"""The decode block's small kernels: the residual add with the LayerNorm,
the dense attention of a narrow window, and the int8 page write.

Decode (the serving tick and the prefill windows) replays CUDA graphs
whose cost is per launch: a GPT-2 block was some 25 small launches. On
the TPU, XLA fuses these steps (`cloud_tpu/models/transformer.py`: the
LayerNorms with the residual adds, `_decode_attention` at :86, the int8
page write), so no Pallas kernel stands behind them; here they are three
hand-written kernels in `csrc/decode_block.cu`:

- `add_layer_norm(x, r, weight, bias, eps, out_dtype)`: (y, h) with
  h = x + r in f32 (x itself without r) and y = LayerNorm(h) cast to
  `out_dtype`;
- `window_attention(q, k, v, bias, sm_scale)`: one example's W queries
  over its dense cache of L positions: f32 logits of the compute-dtype q
  and K plus the additive mask `bias`, an f32 softmax, its product with
  V (f32 accumulation) in the compute dtype (the plain version rounds
  the weights to the compute dtype before the product; the kernel, split
  over the keys, keeps them in f32);
- `int8_page_write(pages, scales, x, phys, off, valid)`: decode K/V
  written into int8 pages with a per-page per-head amax rescale;
- `page_gather(pages, scales, gvec, plen, out)`: a prefill's dense cache
  seeded from pool pages (a prefix hit's gather, JAX's `_gather_impl`,
  `cloud_tpu/serving/engine.py:852`), zeros past `plen`.

Each works by where its tensors lie: CPU tensors take its plain version
(`add_layer_norm_reference`, `window_attention_reference`,
`int8_page_write_reference`), which is the PyTorch code the decode
forward ran before; CUDA tensors launch the kernel or raise. There is no
switch that sends a CUDA tensor to the plain version. The int8 write and
the gather equal their plain versions bit for bit; the other two sum in
another order than cuBLAS and PyTorch's LayerNorm.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

#: Launches of each CUDA kernel since the last reset, counted where the
#: wrapper launches it.
launches = {"add_layer_norm": 0, "window_attention": 0,
            "int8_page_write": 0, "page_gather": 0}

_KINDS = {torch.float32: 0, torch.bfloat16: 1}

#: The head dims the window kernel is built for.
WINDOW_HEAD_DIMS = (16, 32, 64, 128)


def reset_launches():
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def add_layer_norm_reference(x, r, weight, bias, eps, out_dtype):
    """(y, h): h = x + r (x when r is None), y = F.layer_norm(h) in f32,
    cast to `out_dtype`."""
    h = x if r is None else x + r
    y = F.layer_norm(h.float(), (h.shape[-1],), weight, bias, eps)
    return y.to(out_dtype), h


def dense_decode_attention(q, k, v, bias, sm_scale):
    """The batched dense decode attention: q [B, S, H, D], k / v [B, L, H,
    D] in the compute dtype, bias [B, 1, S, L] f32 (0 or -1e30) ->
    [B, S, H, D]: f32 logits of the compute-dtype q and K (f32
    accumulation) plus the bias, an f32 softmax whose weights are rounded
    to the compute dtype, and their product with V in the compute dtype
    (f32 accumulation); JAX's `_decode_attention`."""
    batch, seq, heads, head_dim = q.shape
    length = k.shape[1]
    qh = q.float().permute(0, 2, 1, 3).reshape(batch * heads, seq, head_dim)
    kt = k.float().permute(0, 2, 3, 1).reshape(batch * heads, head_dim,
                                               length)
    logits = torch.baddbmm(
        bias.expand(batch, heads, seq, length).reshape(
            batch * heads, seq, length), qh, kt, alpha=sm_scale)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    vh = v.permute(0, 2, 1, 3).reshape(batch * heads, length, head_dim)
    out = torch.bmm(weights, vh).view(batch, heads, seq, head_dim)
    return out.permute(0, 2, 1, 3)


def window_attention_reference(q, k, v, bias, sm_scale):
    """`dense_decode_attention` of one example: q [W, H, D], k / v [L,
    H, D], bias [W, L] -> [W, H, D]."""
    return dense_decode_attention(q[None], k[None], v[None],
                                  bias[None, None], sm_scale)[0]


def int8_page_write_reference(pages, scales, x, phys, off, valid=None):
    """Writes decode K/V into int8 pages with a per-page per-head amax
    rescale, in place.

    pages [2, N, P, H, D] int8; scales [2, N, H] f32; x [2, slots, seq,
    H, D]; phys / off [slots, seq] the physical page and in-page offset
    of each token; valid [slots, seq] (None: all) zeroes the tokens of
    dead rows before the amax, so they never inflate a page's scale. Per
    position j the page's scale grows to cover the token (`new = max(old,
    amax / 127)`), the page's block is rescaled by `old / new` (an exact
    no-op when the scale does not grow) and the token quantized at `new`.
    K or V alone goes as pages [N, P, H, D], scales [N, H] and x [slots,
    seq, H, D]. Returns (pages, scales)."""
    if pages.dim() == 4:
        int8_page_write_reference(pages[None], scales[None], x[None], phys,
                                  off, valid)
        return pages, scales
    if valid is not None:
        x = x * valid.to(x.dtype)[None, :, :, None, None]
    slots, seq = x.shape[1:3]
    xf = x.float()
    rows = torch.arange(slots, device=x.device)
    for j in range(seq):
        p = phys[:, j]
        o = off[:, j]
        xj = xf[:, :, j]                        # [2, slots, H, D]
        amax = xj.abs().amax(dim=-1)            # [2, slots, H]
        old = scales[:, p]
        # A true division: PyTorch on the card multiplies by the
        # reciprocal of a Python-number divisor, one bit off at times.
        new = torch.maximum(old, amax / torch.full_like(amax, 127.0))
        safe = torch.where(new > 0, new, torch.ones_like(new))
        factor = (old / safe)[:, :, None, :, None]
        block = torch.clamp(torch.round(pages[:, p].float() * factor),
                            -127, 127)
        block[:, rows, o] = torch.clamp(
            torch.round(xj / safe[..., None]), -127, 127)
        pages[:, p] = block.to(torch.int8)
        scales[:, p] = new
    return pages, scales


def page_gather_reference(pages, scales, gvec, plen, out):
    """Seeds dense cache K/V `out` [layers, 2, 1, L, H, D] from the pool:
    position l < plen from page gvec[l // P] of `pages` [layers, 2, N, P,
    H, D] (int8 pages times their [layers, 2, N, H] f32 `scales`, cast to
    out's dtype), zeros past plen (a 0-d int64 tensor). Returns out."""
    valid = torch.arange(out.shape[-3], device=out.device) < plen
    got = pages.index_select(2, gvec)
    if scales is not None:
        s = scales.index_select(2, gvec)
        got = (got.float() * s[:, :, :, None, :, None]).to(out.dtype)
    torch.where(valid[:, None, None], got.view(out.shape),
                torch.zeros((), dtype=out.dtype, device=out.device),
                out=out)
    return out


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _library():
    from cloud_tpu_torch.ops import _build

    lib = _build.load("decode_block")
    if lib.add_layer_norm.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.add_layer_norm.argtypes = (
            [i32, i32] + [ptr] * 6 + [i32, i32, ctypes.c_float, ptr])
        lib.window_attention.argtypes = (
            [i32, ptr, i64, ptr, ptr, i64, ptr, ptr, ptr, ptr] + [i32] * 4
            + [ctypes.c_float, ptr])
        lib.window_attention_part_floats.argtypes = [i32] * 4
        lib.window_attention_part_floats.restype = i64
        lib.page_gather.argtypes = [i32, i32] + [ptr] * 5 + [i32] * 6 + [
            ptr]
        lib.int8_page_write.argtypes = (
            [i32, ptr, ptr, ptr, i64, i64, ptr, ptr, i64, ptr, i64]
            + [i32] * 5 + [ptr])
        for fn in (lib.add_layer_norm, lib.window_attention,
                   lib.int8_page_write, lib.page_gather):
            fn.restype = ctypes.c_int
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_counters = {}


def _split_counters(device, n):
    """The window kernel's merge counters on `device`: at least n zeroed
    u32, kept for the process (each launch leaves them zero, so one set
    serves every launch; the engine's prefills never overlap)."""
    have = _counters.get(device)
    if have is None or have.numel() < n:
        have = _counters[device] = torch.zeros(
            (max(n, 1024),), dtype=torch.int32, device=device)
    return have


def _aligned(t, name):
    if t.data_ptr() % 16:
        raise ValueError("{} must be 16-byte aligned for the CUDA kernel."
                         .format(name))


def _on_device(*tensors):
    """'cpu' or 'cuda' for operands that share one device; raises
    otherwise."""
    device = tensors[0].device
    for t in tensors[1:]:
        if t is not None and t.device != device:
            raise ValueError("operands must share one device; got {} and "
                             "{}.".format(t.device, device))
    if device.type not in ("cpu", "cuda"):
        raise ValueError("runs on CPU or CUDA tensors; got {}.".format(
            device))
    return device.type


def add_layer_norm(x, r, weight, bias, eps, out_dtype):
    """(y, h): h = x + r, y = LayerNorm(h) * weight + bias in
    `out_dtype`. x: [..., D] f32 (the residual stream); r: x's shape in
    f32 or bf16, or None (then h is x); weight, bias: [D] f32. CUDA
    tensors take the kernel (contiguous rows, D a multiple of 8)."""
    features = x.shape[-1]
    if r is not None and r.shape != x.shape:
        raise ValueError("r must match x's shape {}; got {}.".format(
            tuple(x.shape), tuple(r.shape)))
    if _on_device(x, r, weight, bias) == "cpu":
        return add_layer_norm_reference(x, r, weight, bias, eps, out_dtype)
    if (x.dtype != torch.float32 or weight.dtype != torch.float32
            or bias.dtype != torch.float32
            or (r is not None and r.dtype not in _KINDS)
            or out_dtype not in _KINDS or features % 8):
        raise ValueError(
            "the CUDA kernel takes x, weight and bias in float32, r in "
            "float32 or bfloat16, out_dtype float32 or bfloat16 and a "
            "feature count that is a multiple of 8; got x {}, r {}, "
            "out_dtype {}, D {}.".format(
                x.dtype, None if r is None else r.dtype, out_dtype,
                features))
    for t, name in ((x, "x"), (r, "r"), (weight, "weight"), (bias, "bias")):
        if t is not None and not t.is_contiguous():
            raise ValueError("{} must be contiguous for the CUDA kernel."
                             .format(name))
        if t is not None:
            _aligned(t, name)
    from cloud_tpu_torch.ops import _build

    rows = x.numel() // features
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    h = x if r is None else torch.empty_like(x)
    err = _library().add_layer_norm(
        0 if r is None else _KINDS[r.dtype], _KINDS[out_dtype],
        x.data_ptr(), None if r is None else r.data_ptr(),
        weight.data_ptr(), bias.data_ptr(),
        None if r is None else h.data_ptr(), y.data_ptr(), rows, features,
        float(eps), _stream(x))
    _build.check(err, "add_layer_norm kernel launch")
    launches["add_layer_norm"] += 1
    return y, h


def window_attention(q, k, v, bias, sm_scale=None):
    """One example's window attention: q [W, H, D] (rows at any stride,
    heads and features contiguous), k / v [L, H, D] of one stride, bias
    [W, L] f32 -> [W, H, D] in q's dtype; as `window_attention_reference`.
    CUDA tensors take the kernel (q, k, v of one dtype, f32 or bf16; D in
    WINDOW_HEAD_DIMS; 16-byte aligned rows)."""
    rows, heads, head_dim = q.shape
    length = k.shape[0]
    if (tuple(k.shape) != (length, heads, head_dim)
            or tuple(v.shape) != tuple(k.shape)
            or tuple(bias.shape) != (rows, length)):
        raise ValueError(
            "window_attention takes q [W, H, D], k / v [L, H, D] and bias "
            "[W, L]; got {}, {}, {}, {}.".format(
                tuple(q.shape), tuple(k.shape), tuple(v.shape),
                tuple(bias.shape)))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    if _on_device(q, k, v, bias) == "cpu":
        return window_attention_reference(q, k, v, bias, sm_scale)
    kv_row = k.stride(0)
    if (q.dtype not in _KINDS or k.dtype != q.dtype or v.dtype != q.dtype
            or bias.dtype != torch.float32
            or head_dim not in WINDOW_HEAD_DIMS
            or q.stride()[1:] != (head_dim, 1)
            or k.stride()[1:] != (head_dim, 1) or v.stride() != k.stride()
            or q.stride(0) % 8 or kv_row % 8 or not bias.is_contiguous()):
        raise ValueError(
            "the CUDA kernel takes q, k, v of one dtype (float32 or "
            "bfloat16) with heads and features contiguous, row strides "
            "that are multiples of 8, D in {} and a "
            "contiguous float32 bias; got q {} {}, k {} {}, bias {}.".format(
                WINDOW_HEAD_DIMS, q.dtype, q.stride(), k.dtype, k.stride(),
                bias.dtype))
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _aligned(t, name)
    from cloud_tpu_torch.ops import _build

    lib = _library()
    out = torch.empty((rows, heads, head_dim), dtype=q.dtype,
                      device=q.device)
    part = torch.empty((lib.window_attention_part_floats(
        rows, length, heads, head_dim),), dtype=torch.float32,
        device=q.device)
    counters = _split_counters(q.device, heads * -(-rows // 4))
    err = lib.window_attention(
        _KINDS[q.dtype], q.data_ptr(), q.stride(0), k.data_ptr(),
        v.data_ptr(), kv_row, bias.data_ptr(), out.data_ptr(),
        part.data_ptr(), counters.data_ptr(), rows, length, heads, head_dim,
        float(sm_scale), _stream(q))
    _build.check(err, "window_attention kernel launch")
    launches["window_attention"] += 1
    return out


def int8_page_write(pages, scales, x, phys, off, valid=None):
    """Writes decode K/V into int8 pages in place; as
    `int8_page_write_reference` (layouts there). CUDA tensors take the
    kernel, one launch a position: x f32 or bf16 with heads and features
    contiguous, phys / off int64, valid bool. Returns (pages, scales)."""
    if _on_device(pages, scales, x, phys, off, valid) == "cpu":
        return int8_page_write_reference(pages, scales, x, phys, off, valid)
    _, num_pages, page_size, heads, head_dim = pages.shape
    slots, seq = x.shape[1:3]
    if (pages.dtype != torch.int8 or not pages.is_contiguous()
            or scales.dtype != torch.float32 or not scales.is_contiguous()
            or tuple(scales.shape) != (2, num_pages, heads)
            or x.dtype not in _KINDS or x.shape[3:] != (heads, head_dim)
            or x.stride()[3:] != (head_dim, 1)
            or phys.dtype != torch.int64 or off.dtype != torch.int64
            or tuple(phys.shape) != (slots, seq) or off.stride() != phys.stride()
            or (valid is not None and (valid.dtype != torch.bool
                                       or tuple(valid.shape) != (slots, seq)))):
        raise ValueError(
            "the CUDA kernel takes contiguous int8 pages [2, N, P, H, D] and "
            "f32 scales [2, N, H], x [2, slots, seq, H, D] f32 or bf16 with "
            "heads and features contiguous, int64 phys / off [slots, seq] of "
            "one stride and a bool valid; got pages {} {}, x {} {}, phys "
            "{}.".format(pages.dtype, tuple(pages.shape), x.dtype,
                         tuple(x.shape), phys.dtype))
    from cloud_tpu_torch.ops import _build

    lib = _library()
    stream = _stream(x)
    for j in range(seq):
        err = lib.int8_page_write(
            _KINDS[x.dtype], pages.data_ptr(), scales.data_ptr(),
            x[:, :, j].data_ptr(), x.stride(0), x.stride(1),
            phys[:, j].data_ptr(), off[:, j].data_ptr(), phys.stride(0),
            None if valid is None else valid[:, j].data_ptr(),
            0 if valid is None else valid.stride(0), slots, num_pages,
            page_size, heads, head_dim, stream)
        _build.check(err, "int8_page_write kernel launch")
        launches["int8_page_write"] += 1
    return pages, scales


def page_gather(pages, scales, gvec, plen, out):
    """Seeds a dense cache from the pool, in place; as
    `page_gather_reference` (layouts there). CUDA tensors take the
    kernel: contiguous pages (in out's dtype, or int8 with scales) and
    out, int64 gvec and plen. Returns out."""
    if _on_device(pages, scales, gvec, plen, out) == "cpu":
        return page_gather_reference(pages, scales, gvec, plen, out)
    layers, two, num_pages, page_size, heads, head_dim = pages.shape
    length = out.shape[-3]
    kind = 2 if scales is not None else _KINDS.get(pages.dtype)
    if (kind is None or (kind == 2) != (pages.dtype == torch.int8)
            or (kind != 2 and pages.dtype != out.dtype)
            or out.dtype not in _KINDS or not pages.is_contiguous()
            or not out.is_contiguous()
            or tuple(out.shape) != (layers, two, 1, length, heads, head_dim)
            or gvec.dtype != torch.int64 or not gvec.is_contiguous()
            or gvec.numel() * page_size != length
            or plen.dtype != torch.int64 or plen.numel() != 1
            or (scales is not None
                and (scales.dtype != torch.float32
                     or not scales.is_contiguous()))
            or (heads * head_dim) % 8):
        raise ValueError(
            "the CUDA kernel takes contiguous pages [layers, 2, N, P, H, D] "
            "in out's dtype (or int8 with f32 scales), out [layers, 2, 1, L, "
            "H, D], int64 gvec [L / P] and plen; got pages {} {}, out {} "
            "{}.".format(pages.dtype, tuple(pages.shape), out.dtype,
                         tuple(out.shape)))
    for t, name in ((pages, "pages"), (out, "out")):
        _aligned(t, name)
    from cloud_tpu_torch.ops import _build

    err = _library().page_gather(
        kind, _KINDS[out.dtype], pages.data_ptr(),
        None if scales is None else scales.data_ptr(), gvec.data_ptr(),
        plen.data_ptr(), out.data_ptr(), layers * two, num_pages,
        page_size, length, heads, head_dim, _stream(out))
    _build.check(err, "page_gather kernel launch")
    launches["page_gather"] += 1
    return out


# ---------------------------------------------------------------------------
# Costs, for bounds
# ---------------------------------------------------------------------------


def add_layer_norm_cost(rows, features, r_itemsize=2, y_itemsize=2):
    """Work of one call with a residual: flops 8 per element (add, mean,
    deviation, square, scale, shift); bytes: x and r read, h and y
    written, weight and bias read."""
    return {"flops": 8.0 * rows * features,
            "bytes_moved": float(rows * features * (4 + r_itemsize + 4
                                                    + y_itemsize)
                                 + 2 * features * 4)}


def window_attention_cost(rows, length, heads, head_dim, itemsize=2):
    """Work of one call: flops of the two products (2 per multiply-add)
    over every key; bytes: q and out, K and V of every position, and the
    f32 bias, each once."""
    return {"flops": 4.0 * rows * length * heads * head_dim,
            "bytes_moved": float(2 * rows * heads * head_dim * itemsize
                                 + 2 * length * heads * head_dim * itemsize
                                 + rows * length * 4)}


def int8_page_write_cost(slots, heads, head_dim, page_size, itemsize=2,
                         rescaled=0):
    """Work of one position's write: bytes of the tokens read and
    written, the scales read and written, and (`rescaled` blocks whose
    scale grew) each such page block read and written; flops 3 per token
    element and 2 per rescaled element."""
    tokens = 2 * slots * heads * head_dim
    block = page_size * head_dim
    return {"flops": float(3 * tokens + 2 * rescaled * block),
            "bytes_moved": float(tokens * (itemsize + 1)
                                 + 2 * 2 * slots * heads * 4
                                 + 2 * rescaled * block)}


def page_gather_cost(layers, length, heads, head_dim, itemsize=2,
                     page_itemsize=2, plen=None):
    """Work of one gather: bytes of the `plen` gathered positions read
    (and their scales for int8 pages) and of the whole cache written;
    one flop per dequantized element."""
    plen = length if plen is None else plen
    elems = 2 * layers * heads * head_dim
    scale_bytes = 2 * layers * heads * 4 * -(-plen // 16) if (
        page_itemsize == 1) else 0
    return {"flops": float(elems * plen if page_itemsize == 1 else 0),
            "bytes_moved": float(elems * (plen * page_itemsize
                                          + length * itemsize)
                                 + scale_bytes)}


__all__ = ["add_layer_norm", "add_layer_norm_cost",
           "add_layer_norm_reference", "dense_decode_attention",
           "int8_page_write", "int8_page_write_cost",
           "int8_page_write_reference", "launches", "page_gather",
           "page_gather_cost", "page_gather_reference", "reset_launches",
           "WINDOW_HEAD_DIMS",
           "window_attention", "window_attention_cost",
           "window_attention_reference"]
