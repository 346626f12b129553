"""Paged decode attention: the serving tick's attention over a page pool.

One (or `seq`) query positions per slot attend over that slot's
logical KV cache, which lives scattered across a physical page pool
(`key_pages`/`value_pages` `[num_pages, page_size, H, D]`) and is
addressed through a per-slot page table. The port of
`cloud_tpu/ops/paged_attention.py`.

`paged_attention` works by where its tensors lie:

- CPU tensors take `paged_attention_reference`, the plain PyTorch
  version (a gather of the dense per-slot view, then masked softmax).
- CUDA tensors launch the hand-written kernels in
  `csrc/paged_attention.cu` (fp pages, or int8 pages with per-page
  per-head f32 scales; a slot's live pages split over several blocks,
  then their partial results merged), or raise. There is no switch that
  sends a CUDA tensor to the plain version. An operand that is not
  contiguous or not 16-byte aligned goes to the kernels as a contiguous
  copy.

Masking is the caller's `allowed [slots, seq, cache_len]`. A query row
with no allowed key (an evicted slot, a padded row) comes out as exact
zeros in both versions; `cloud_tpu`'s gathered reference averages such
a row uniformly instead, while its kernel writes zeros, which is the
behaviour kept here.

Int8 pages (`key_scales`/`value_scales` given, `[num_pages, heads]`
f32): `k_f32 = k_int8 * scale[page, head]`, both products in f32, the
output in q's dtype. A zero scale is a never-written page and
dequantizes to zeros.
"""

import ctypes
import functools
import math

import torch

from cloud_tpu_torch.ops._layout import dense

_NEG_INF = -1e30

#: Launches of each CUDA kernel since the last reset: one per call of
#: the wrapper that reaches the kernel, counted where it launches.
launches = {"paged_attention": 0, "paged_attention_int8": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _check_scales(key_pages, key_scales, value_scales):
    """Validates the int8-page calling convention: both scale arrays or
    neither; int8 pages; [num_pages, heads] f32 scales. Returns whether
    the pages are quantized."""
    if (key_scales is None) != (value_scales is None):
        raise ValueError(
            "key_scales and value_scales must be given together.")
    if key_scales is None:
        return False
    num_pages, _, heads, _ = key_pages.shape
    if key_pages.dtype != torch.int8:
        raise ValueError(
            "scales imply int8 pages; got page dtype {}.".format(
                key_pages.dtype))
    for name, s in (("key_scales", key_scales),
                    ("value_scales", value_scales)):
        if tuple(s.shape) != (num_pages, heads):
            raise ValueError(
                "{} must be [num_pages, heads] = {}; got {}.".format(
                    name, (num_pages, heads), tuple(s.shape)))
        if s.dtype != torch.float32:
            raise ValueError("{} must be float32; got {}.".format(
                name, s.dtype))
    return True


def _check_shapes(q, key_pages, value_pages, page_table, allowed):
    num_pages, page_size, heads, head_dim = key_pages.shape
    slots, seq, q_heads, q_dim = q.shape
    pages_per_slot = page_table.shape[1]
    cache_len = pages_per_slot * page_size
    if q_heads != heads or q_dim != head_dim:
        raise ValueError(
            "q [slots, seq, H, D] must match the pages' H and D; got q "
            "{} for pages {}.".format(tuple(q.shape),
                                      tuple(key_pages.shape)))
    if value_pages.shape != key_pages.shape:
        raise ValueError(
            "key_pages and value_pages must have identical shapes; "
            "got {} vs {}.".format(tuple(key_pages.shape),
                                   tuple(value_pages.shape)))
    if page_table.shape[0] != slots:
        raise ValueError(
            "page_table must be [slots, pages_per_slot] with slots = "
            "{}; got {}.".format(slots, tuple(page_table.shape)))
    if tuple(allowed.shape) != (slots, seq, cache_len):
        raise ValueError(
            "allowed must be [slots, seq, cache_len] = {}; got "
            "{}.".format((slots, seq, cache_len), tuple(allowed.shape)))
    if value_pages.dtype != key_pages.dtype:
        raise ValueError("key_pages and value_pages dtypes differ: {} vs "
                         "{}.".format(key_pages.dtype, value_pages.dtype))


def paged_attention_reference(q, key_pages, value_pages, page_table,
                              allowed, sm_scale=None, key_scales=None,
                              value_scales=None):
    """Plain paged decode attention (the kernels' oracle).

    q: [slots, seq, H, D]; key_pages/value_pages: [N, P, H, D];
    page_table: [slots, pages_per_slot] int32; allowed:
    [slots, seq, cache_len] bool (True = attend) ->
    [slots, seq, H, D] in the page dtype (q's dtype for int8 pages).

    Gathers each slot's logical [cache_len] view, takes f32 logits,
    masks with -1e30, softmaxes in f32, casts the weights to the page
    dtype (f32 for int8 pages) and sums over V in f32. Rows with no
    allowed key are zeros.
    """
    num_pages, page_size, heads, head_dim = key_pages.shape
    slots, pages_per_slot = page_table.shape
    cache_len = pages_per_slot * page_size
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    quantized = _check_scales(key_pages, key_scales, value_scales)
    pt = page_table.long()
    k_view = key_pages[pt].float()
    v_view = value_pages[pt].float()
    if quantized:
        k_view = k_view * key_scales[pt][:, :, None, :, None]
        v_view = v_view * value_scales[pt][:, :, None, :, None]
    k_view = k_view.reshape(slots, cache_len, heads, head_dim)
    v_view = v_view.reshape(slots, cache_len, heads, head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_view) * sm_scale
    logits = torch.where(allowed[:, None], logits,
                         torch.full((), _NEG_INF, device=logits.device))
    weight_dtype = torch.float32 if quantized else value_pages.dtype
    weights = torch.softmax(logits, dim=-1).to(weight_dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v_view)
    live = allowed.any(dim=-1)[:, :, None, None]
    out = torch.where(live, out, torch.zeros((), device=out.device))
    return out.to(q.dtype if quantized else value_pages.dtype)


_KINDS = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.float32, torch.int8): 2,
    (torch.bfloat16, torch.int8): 3,
}


def _library():
    from cloud_tpu_torch.ops import _build

    lib = _build.load("paged_attention")
    fn = lib.paged_attention_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


#: Bytes of the kernel's ring of K and V pages (two stages), kept at about
#: 96 KB so that two blocks share an SM.
_RING_BYTES = 96 * 1024


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(slots, heads, head_dim, page_size, pages_per_slot, item, sms):
    """How the kernel splits a call (flash-decoding): (group, chunks).
    A block computes `group` heads (every head, unless two stages of K
    and V pages of that many heads exceed _RING_BYTES: then the largest
    divisor of heads that fits) over one of `chunks` runs of a slot's
    live pages; chunks makes about two blocks per SM over the grid, and
    at most one per page."""
    group = heads
    while group > 1 and (heads % group or 4 * page_size * group * head_dim
                         * item > _RING_BYTES):
        group -= 1
    blocks = slots * (heads // group)
    chunks = max(1, min(pages_per_slot, -(-2 * sms // blocks)))
    return group, chunks


def _launch_kernel(q, key_pages, value_pages, page_table, allowed,
                   sm_scale, key_scales, value_scales):
    """Launches the CUDA kernels (the split pass, then the merge) on
    PyTorch's current stream. Validates device and dtype first, copies an
    operand that is not contiguous or 16-byte aligned (`dense`); raises
    on what the kernel does not take and on a CUDA error from the
    launch."""
    from cloud_tpu_torch.ops import _build

    quantized = key_scales is not None
    operands = [q, key_pages, value_pages, page_table, allowed]
    if quantized:
        operands += [key_scales, value_scales]
    for t in operands:
        if t.device != q.device:
            raise ValueError("paged_attention operands must share one "
                             "device; got {} and {}.".format(t.device,
                                                             q.device))
    kind = _KINDS.get((q.dtype, key_pages.dtype))
    if kind is None:
        raise ValueError(
            "the CUDA kernel takes q/pages of (f32|bf16)/(same|int8); "
            "got q {} with {} pages.".format(q.dtype, key_pages.dtype))
    if page_table.dtype != torch.int32 or allowed.dtype != torch.bool:
        raise ValueError("page_table must be int32 and allowed bool; got "
                         "{} and {}.".format(page_table.dtype,
                                             allowed.dtype))
    num_pages, page_size, heads, head_dim = key_pages.shape
    item = key_pages.element_size()
    if head_dim * item % 16:
        raise ValueError(
            "the CUDA kernel copies K/V rows in 16-byte pieces: head_dim "
            "* element size must be a multiple of 16; got {} x {}.".format(
                head_dim, item))
    q, key_pages, value_pages, page_table, allowed = (
        dense(t) for t in (q, key_pages, value_pages, page_table, allowed))
    if quantized:
        key_scales, value_scales = dense(key_scales), dense(value_scales)
    slots, seq = q.shape[:2]
    pages_per_slot = page_table.shape[1]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _library()
    group, chunks = plan(slots, heads, head_dim, page_size, pages_per_slot,
                         item, _sm_count(q.device.index))
    part = torch.empty(slots * chunks * seq * heads * (head_dim + 2),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(kind, q.data_ptr(), key_pages.data_ptr(),
                 value_pages.data_ptr(), page_table.data_ptr(),
                 allowed.data_ptr(),
                 key_scales.data_ptr() if quantized else None,
                 value_scales.data_ptr() if quantized else None,
                 part.data_ptr(), out.data_ptr(), slots, seq, heads,
                 head_dim, page_size, pages_per_slot, num_pages, group,
                 chunks, float(sm_scale), stream)
    _build.check(err, "paged_attention kernel launch")
    launches["paged_attention_int8" if quantized
             else "paged_attention"] += 1
    return out


def paged_attention(q, key_pages, value_pages, page_table, allowed,
                    sm_scale=None, key_scales=None, value_scales=None):
    """Paged decode attention; layouts as `paged_attention_reference`.

    CPU tensors run the plain version; CUDA tensors run the CUDA kernel
    (fp pages: out in the page dtype, which must equal q's; int8 pages:
    out in q's dtype) and raise on anything it does not take.
    """
    _check_shapes(q, key_pages, value_pages, page_table, allowed)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(key_pages.shape[-1])
    quantized = _check_scales(key_pages, key_scales, value_scales)
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, key_pages, value_pages, page_table, allowed,
            sm_scale=sm_scale, key_scales=key_scales,
            value_scales=value_scales)
    if q.device.type != "cuda":
        raise ValueError("paged_attention runs on CPU or CUDA tensors; "
                         "got {}.".format(q.device))
    return _launch_kernel(q, key_pages, value_pages, page_table, allowed,
                          sm_scale, key_scales if quantized else None,
                          value_scales if quantized else None)


def paged_decode_attention(q, key_pages, value_pages, page_table, allowed,
                           sm_scale=None, interpret=None, key_scales=None,
                           value_scales=None):
    """`paged_attention` under the JAX package's name and argument list
    (`cloud_tpu/ops/paged_attention.py` `paged_decode_attention`). The
    port has no interpret mode: CPU tensors take the plain version, CUDA
    tensors the kernel, so `interpret` may only be None or False."""
    if interpret:
        raise ValueError("the port has no interpret mode; CPU tensors run "
                         "the plain version (paged_attention_reference).")
    return paged_attention(q, key_pages, value_pages, page_table, allowed,
                           sm_scale=sm_scale, key_scales=key_scales,
                           value_scales=value_scales)


def paged_attention_cost(slots, seq, heads, head_dim, page_size,
                         pages_per_slot, dtype=torch.bfloat16,
                         kv_dtype=None):
    """Per-call flops / bytes-moved of paged attention at these shapes,
    counted analytically with every page of every slot live.

    flops: two products (QK and PV) of 2 flops per multiply-add.
    bytes_moved: the slots' K/V pages in `kv_dtype` (default `dtype`),
    q and out in `dtype`, the page table and the mask, plus the
    per-page per-head f32 scales of int8 pages.
    Returns {"flops", "bytes_moved"}.
    """
    cache_len = page_size * pages_per_slot
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    itemsize = torch.empty((), dtype=dtype).element_size()
    kv_itemsize = torch.empty((), dtype=kv_dtype).element_size()
    flops = 4.0 * slots * seq * cache_len * heads * head_dim
    bytes_moved = float(
        2 * slots * cache_len * heads * head_dim * kv_itemsize  # K/V
        + 2 * slots * seq * heads * head_dim * itemsize        # q + out
        + slots * pages_per_slot * 4                           # table
        + slots * seq * cache_len)                             # mask
    if kv_dtype == torch.int8:
        bytes_moved += float(2 * slots * pages_per_slot * heads * 4)
    return {"flops": flops, "bytes_moved": bytes_moved}


__all__ = ["launches", "paged_attention", "paged_attention_cost",
           "paged_attention_reference", "paged_decode_attention", "plan",
           "reset_launches"]
