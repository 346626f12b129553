#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one CUDA card.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

It builds the port's CUDA kernels from `cloud_tpu_torch/ops/csrc/`
(nvcc, sm_90a, one process per source, into the gitignored `build/`),
then:

1. prints the card (torch's name, and nvidia-smi's name and power
   limit);
2. holds each paged-attention kernel against its plain PyTorch version
   on the card at the served shapes (slots 8, H 12, D 64, page 16, 64
   pages per slot, bf16; seq 1 and 4; shared pages, an evicted slot,
   garbage in the scratch page; int8 pages with a zero-scale page),
   requires exact zeros on masked rows, and times kernel, plain
   version, bound and the library yardstick (gathered view +
   scaled_dot_product_attention, which the port never calls);
3. holds the three flash-attention kernels (forward, dq, dk/dv),
   called through the public `flash_attention` and `torch.autograd`,
   against `mha_reference` in f32 on the same inputs and its autograd
   gradients, element by element: out, lse, dq, dk, dv at the GPT-2
   training shape (B 8, S 1024, H 12, D 64, causal; bf16 and f32), a
   Llama shape (B 2, S 2048, H 32, H_kv 8, D 128, bf16), TinyLlama's
   training shape (B 4, S 2048, H 32, H_kv 4, D 64, bf16), and at the
   GPT-2 shape with a key mask that leaves rows with no key, window
   256, softcap 50 (logits scaled to reach the cap), S 1000 and
   causal=False, TinyLlama's widths at B 3, S 1000, Gemma-2-2B's
   attention (B 2, S 2048, H 8, H_kv 4, head_dim 256, softcap 50,
   sm_scale 1/16; without and with window 512), and head_dims that are
   no template width: Phi-3-mini's attention (B 2, S 2048, H 32, D 96),
   phi-2's D 80 at the same shape, D 32 and D 36 (through the
   zero-padded copy) and D 96 in f32 at a small shape; Qwen3-30B-A3B's
   attention (B 2, S 2048, H 32, H_kv 4, D 128); and head_dims past 256
   on the wide kernels: DeepSeek-V4-Flash's dense attention (B 1, S
   2048, 64 heads over 1 KV head, D 512), D 264, D 320 with window,
   softcap and key mask, D 576 over one KV head and f32 D 320; and
   ViT-B/16's attention at phase 11's shape (B 256, S 197, H 12, D 64,
   non-causal); then
   times each kernel at the GPT-2, the TinyLlama, the Gemma-2, the
   Phi-3-mini, the phi-2, the Qwen3-30B-A3B, the DeepSeek-V4-Flash and
   the ViT-B/16 (non-causal) shapes beside its bound,
   the plain version and scaled_dot_product_attention (forward; the
   whole backward, beside the port's whole backward: delta, dq and
   dk/dv, all three by the profiler's device time, or all three by
   CUDA events where the profiler loses kernels of one), which the port never
   calls, and the host time of each wrapper's launch;
4. holds the fused RMSNorm kernels (with and without the residual add)
   against `rmsnorm_residual_reference` at rows 8192 and 8191 x D 2048,
   bf16 and f32 (h bit for bit, normed element by element), and times
   them beside the bound, the plain version and F.rms_norm; holds the
   fused SwiGLU kernels (gate|up, down) against the plain computation
   with the same rounding points at rows 8192, 1000 and 8 x D 2048 x
   d_ff 5632 (silu; gelu_tanh and gelu at rows 1024), at rows 1000 x D
   520 x d_ff 1352 (no width a multiple of the tiles), rows 128 x d_ff
   1024 (fewer tiles than SMs) and f32 at a small shape, and times them
   beside their bounds and the three F.linear calls of the plain
   version;
5. serves 16 requests through `Scheduler` on GPT-2 small (random
   weights from a seed), with fp pages; checks that every tick went
   through the kernel, that sampled requests equal solo `generate()`
   and that greedy tokens agree with an f32 teacher-forced forward;
   does the same with int8 pages and 8 requests, then times 20 ticks
   of a full engine under torch.profiler (device busy share);
6. trains GPT-2 small (bf16, batch 8, seq 1024) with
   `Trainer(optimizer=adamw on a warmup-cosine schedule).fit` for
   TRAIN_EPOCHS epochs of TRAIN_STEPS steps on synthetic sequences
   whose next token the current token says nothing of but the one
   before it fixes: checks one step's loss and every
   parameter's gradient norm against the same step with attention by
   the plain version, that every step launched each flash kernel once
   per layer, and that the last epoch's loss fell well below the
   entropy of the next token given the current one (only attention to
   earlier positions gets there); times steps (p50, tokens/s, MFU,
   device busy share under torch.profiler); then `evaluate` and
   `predict` on held-out sequences;
7. trains TinyLlama-1.1B (`LlamaLM(**TINYLLAMA_1_1B)`, bf16, batch 4,
   seq 2048) the same way for LLAMA_EPOCHS epochs of LLAMA_STEPS steps:
   the one-step check (batch 1) against attention, norm and MLP all by
   their plain versions; every step launching each flash and MLP kernel
   once per layer and the norm kernels 2 x layers + 1 times; the loss
   gate (`llama_loss_gate`); step timing and the top kernels;
   `evaluate` and `predict`;
8. generates with phase 7's trained TinyLlama-1.1B (optimizer state
   freed) through `generate()` (8 prompts of 96-480 tokens of held-out
   chain sequences, left-padded into one 512 bucket, 64 new tokens),
   and with the same weights imported by `import_hf_llama` from an
   HF-named state dict: the imported model's greedy tokens equal the
   trained model's; each greedy token lies within 0.25 logit of an f32
   teacher-forced forward's row max and is its argmax at 95 % of
   positions; the continuation follows the chain rule; one call
   launches the norm kernels (2 x layers + 1) x 64 times, each MLP
   kernel layers x 64 times and no flash kernel; two sampled calls
   with one seed agree. Times the prefill, the decode step (p50,
   tokens/s, busy share and top kernels under torch.profiler over 20
   steps) and the norm and MLP kernels at rows 8 beside their bounds,
   plain versions and library calls;
9. trains Qwen3-30B-A3B (`QWEN3_30B_A3B`: full width, all 128 experts,
   top 8, 4 of its 48 layers, bf16, batch 2 x 2048, capacity factor
   2.0, aux_loss_weight 0.01) the same way for QWEN3_EPOCHS epochs of
   QWEN3_STEPS steps: the one-step check against attention and norm by
   their plain versions, the experts' routes of the two runs compared
   first; every step launching each flash kernel once per layer and the
   norm kernels 2 x layers + 1 times (no MLP kernel: the experts are
   plain products); the loss gate; step time, tokens/s, MFU on the
   active parameters, busy share and top kernels; the aux loss per
   epoch and the expert load (routes per expert, share dropped) at the
   first and last step; then sets the model drop-free and generates
   with it and its `import_hf_llama` copy (as `qwen3_moe`) as phase 8
   does (the chain rule held only if the fit left the cycle plateau);
10. holds `lm_head_loss` (bf16, 5 % of labels -1, chunk 8192) at
   Qwen3-30B-A3B's head (N 4096, D 2048, V 151936) and TinyLlama's (N
   8192, D 2048, V 32000) against `lm_head_loss_reference` in f32 per
   element (loss, dh, dW), with its peak extra memory and fwd+bwd time
   beside the materialised f32 reference's and the one-call library
   route's (F.linear + F.cross_entropy in bf16); then drives the
   training loop on GPT-2 small (phase 6's model and batch): (U) 3
   epochs of 8 steps with ema_decay 0.999, async logging and the
   callbacks MetricsLogger, ModelCheckpoint (every epoch, async),
   TerminateOnNaN and EarlyStopping; (R) a fresh Trainer from the same
   seed under `fit(resume="auto")` with the chaos plan `preempt@12`,
   which must end at step 24 with parameters, EMA shadow and last-epoch
   loss bit-equal to U's, one fault, one retry and one resume; each of U
   and R launching each flash kernel layers x 24 times; a third Trainer
   restoring U's last checkpoint, whose `evaluate(use_ema=True)` equals
   U's; (T) one epoch with `trainable="lm_head|block_11"`, frozen
   parameters bit-equal, AdamW state for the trained ones alone; and
   the checkpoint's bytes, sync and async save and restore seconds.
   The checkpoints live under `build/chip_smoke_ckpt/` and are removed;
11. trains the image families through `Trainer.fit` (every number
   printed beside the card's name and power limit): (a) MNIST's
   `MLP(hidden=512)` and `ConvNet` on class-template 28 x 28 images:
   held-out accuracy gates, the MLP fit at steps_per_execution 1 and 16
   bit-equal (the CUDA graph route against eager steps) with steps/s of
   both, `cache="device"` with `input_cast="uint8"` moving no h2d byte
   after its upload with the host-fed fit's history, the streaming
   datasets and `prefetch_to_device` giving the array fit's history, and
   each of the eight optimizers' 20 f32 steps against the same steps on
   the CPU; (b) ResNet-50 at full width (stages 3-4-6-3, 1000 classes,
   224 x 224) at bench.py's operating point (batch 256, bf16, SGD 0.1
   momentum 0.9, resident data, bf16 input cast, steps_per_execution 5,
   warm start) on class-template images over 10 of the 1000 classes:
   the first step's latency with a warm start (its warm-up, then step
   1, which moves no counter) and then without one, the fit that
   follows taking its new upload into the captured graph, the held-out accuracy gate,
   `evaluate`/`predict` with train=False, step p50, images/s, MFU from
   the convolutions' and the head's shapes, busy share and kernels a
   step under torch.profiler, peak memory, one step in bf16 against f32,
   one BatchNorm's running statistics against flax's rule by hand, and
   remat's gradients bit-equal to the plain step's with the statistics
   moved once and both peaks; (c) ViT-B/16 at full width (AdamW, bf16,
   batch 256): one step against attention by `mha_reference`, each
   flash kernel launched once per layer every step, the held-out gate,
   step p50, images/s, MFU and busy share;
12. prints the kernel table as one JSON line (one row per kernel and
   path that launches it, with that path's launches and the times at
   its shape), the card line, and the contract line
   `{"ok": true, "device": {...}}` last.

Any failure raises and exits non-zero. Without a CUDA card, or without
the rest of the repository beside it, it exits non-zero before
printing any result. Details go to build/chip_smoke.json.

    python3 chip_smoke.py --llama-gate TREE SEEDS OUT

runs phase 7's fit alone on the port found in TREE (this checkout, or
an earlier commit unpacked there with `git archive`), once per data
seed in the comma-separated SEEDS, and writes each seed's losses and
gate to OUT (JSON).

    python3 chip_smoke.py --phase11

builds the kernels and runs the ViT shape's flash check and timing,
and phase 11 alone (no kernel table, no contract line), writing
build/chip_smoke_phase11.json.

    python3 chip_smoke.py --flash-times TREE OUT

times the three bf16 flash kernels alone at GPT-2's, TinyLlama's and
Gemma-2's training shapes on the port in TREE and writes them to OUT
(JSON): run it for two trees, in turns, in one call to compare them on
one card.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
KERNEL_TOL = 2e-2                  # bf16 outputs, as the JAX suite
# Flash kernels against their plain versions run in f32 on the same
# inputs (the forward: mha_reference; dq and dk/dv: mha_backward_reference
# given the delta = rowsum(dO O) the backward computed from the forward's
# output), element by element: |kernel - plain| <= rtol |plain| +
# atol rms(row), where a row is the D values of one (example, position,
# head) of out, dq, dk or dv, and rms(row) is at least ROW_FLOOR times the
# rms of the whole tensor (rows that are 0 in exact arithmetic, such as dq
# of a row that sees one key, are rounding noise in both versions). bf16:
# rtol 2^-8 covers the rounding of the kernels' outputs to bf16 (at most
# 2^-9 relative); atol covers the roundings inside (P and dS to bf16
# before the second product), which add up over a row's terms as the
# row's value does. f32: summation order only. lse (f32 in both) within
# 1e-3 absolute (bf16) and 1e-4 (f32).
FLASH_TOL = {"bf16": {"rtol": 2.0 ** -8, "atol": 3e-2, "lse": 1e-3},
             "f32": {"rtol": 0.0, "atol": 1e-4, "lse": 1e-4}}
ROW_FLOOR = 1e-2
# End to end, the gradients against mha_reference's autograd in f32 (whose
# delta comes from the exact O): max |kernel - plain| within this share of
# max |plain|. The bf16 O moves delta by up to ~2^-9 |dO| |O|, which in a
# row with few keys outweighs that row's dq; this reading is the whole
# backward's, printed beside the per-element one.
END_TO_END_TOL = {"bf16": 3e-2, "f32": 1e-4}
# Training one-step check, kernels against the plain attention on the
# same bf16 model and batch: the loss within 2e-3 relative, each
# parameter's gradient norm within 3e-2 relative.
STEP_LOSS_TOL, STEP_GRAD_TOL = 2e-3, 3e-2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_EPOCHS, TRAIN_STEPS = 8, 1024, 6, 20
# AdamW's peak learning rate, warmed up over the first tenth of the
# steps, then cosine decay to 0.
TRAIN_LR = 3e-4
# The last epoch's mean loss must be below this share of the entropy of
# the next token given the current one alone, measured on the training
# data (about 3.9 nats): a model that sees only the current token and
# its position cannot get below that entropy; information from earlier
# tokens reaches a position only through the attention layers.
LOSS_FALL = 0.75
SLOTS, HEADS, HEAD_DIM, PAGE, PAGES_PER_SLOT = 8, 12, 64, 16, 64
GPT2_SMALL = dict(vocab_size=50257, num_layers=12, num_heads=12,
                  d_model=768, d_ff=3072, max_seq_len=1024, norm_eps=1e-5)
# Teacher-forced check of greedy tokens against an f32 forward: a
# served token may sit at most this far below the f32 row max (12
# layers of bf16 matmuls, and int8 K/V, move the logits by a few
# hundredths), and at least this share of tokens must be the exact f32
# argmax (random weights put the top two logits of 50257 close).
LOGIT_MARGIN = {"": 0.25, "int8": 0.5}
MIN_EXACT = 0.95


def log(*args):
    print(*args, flush=True)


def timed_ms(fn, reps=7, iters=20):
    """Device time per call: `iters` calls captured in one CUDA graph,
    replayed `reps` times between CUDA events; the median replay over
    `iters`. The graph takes the host's launch cost out of the number.
    Inputs stay the same across calls, so they may sit in L2."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def backward_ms(out, leaves, grad, iters=10):
    """Device time per call of a backward alone (`torch.autograd.grad`
    through `out`'s graph, kept with retain_graph): the summed duration
    of the device kernels of `iters` eager calls under torch.profiler,
    over `iters`. A CUDA graph cannot hold this backward (the capture
    fails on the graph's AccumulateGrad streams), and CUDA events around
    eager calls would time the host, whose launches take as long as
    scaled_dot_product_attention's backward kernels. Returns (device ms,
    kernels per call)."""
    import torch

    def call():
        return torch.autograd.grad(out, leaves, grad, retain_graph=True)

    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    kernels = [evt for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(evt, "is_user_annotation", False)]
    total = sum(evt.time_range.elapsed_us() for evt in kernels)
    return total / 1e3 / iters, len(kernels) / iters


def bound_of(cost):
    """(least time in ms, "bytes" or "operations") for a cost dict of
    flops and bytes on an H100 (bf16 tensor-core peak)."""
    t_bytes = cost["bytes_moved"] / HBM_BYTES_PER_S
    t_ops = cost["flops"] / PEAK_FLOPS["bf16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


# -- phase 2: kernels against their plain versions -------------------

def kernel_inputs(rng, seq, quantized, device):
    """Random pages at the served shapes. Slot 1 shares slot 0's first
    four pages, slot 3 is evicted (scratch-only table, nothing allowed),
    scratch page 0 holds large finite garbage; in int8 mode page
    `zero_page` (owned by slot 2) has scale 0 and zero content."""
    import torch

    num_pages = SLOTS * PAGES_PER_SLOT + 1
    cache_len = PAGES_PER_SLOT * PAGE
    shape = (num_pages, PAGE, HEADS, HEAD_DIM)
    table = 1 + rng.permutation(num_pages - 1).reshape(SLOTS,
                                                       PAGES_PER_SLOT)
    table[1, :4] = table[0, :4]
    lengths = rng.integers(seq + 16, cache_len + 1, size=SLOTS)
    lengths[0] = cache_len
    allowed = (np.arange(cache_len)[None, None, :]
               <= (lengths[:, None] - seq + np.arange(seq))[:, :, None])
    table[3] = 0
    allowed[3] = False
    for s in range(SLOTS):
        used = -(-lengths[s] // PAGE)
        if s != 3:
            table[s, used:] = 0  # unallocated tail: scratch
    q = rng.normal(size=(SLOTS, seq, HEADS, HEAD_DIM))
    out = {"q": torch.tensor(q, dtype=torch.bfloat16, device=device),
           "page_table": torch.tensor(table, dtype=torch.int32,
                                      device=device),
           "allowed": torch.tensor(allowed, device=device)}
    if quantized:
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (num_pages, HEADS)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (num_pages, HEADS)).astype(np.float32)
        zero_page = table[2, 0]
        k[zero_page] = v[zero_page] = 0
        ks[zero_page] = vs[zero_page] = 0.0
        k[0] = 120
        v[0] = -120
        ks[0] = vs[0] = 50.0
        out.update(key_pages=torch.tensor(k, device=device),
                   value_pages=torch.tensor(v, device=device),
                   key_scales=torch.tensor(ks, device=device),
                   value_scales=torch.tensor(vs, device=device))
    else:
        k = rng.normal(size=shape)
        v = rng.normal(size=shape)
        k[0] = 1e3
        v[0] = -1e3
        out.update(key_pages=torch.tensor(k, dtype=torch.bfloat16,
                                          device=device),
                   value_pages=torch.tensor(v, dtype=torch.bfloat16,
                                            device=device))
    return out


def bound_ms(inp, quantized):
    """Least time for this call's work on an H100: the larger of the
    bytes it must move (q and out once, table, mask, each distinct
    live K/V page once, its scales) over HBM bandwidth, and the flops
    of its allowed (query, key) pairs (QK and PV, 2 per multiply-add)
    over the peak of the type the products run in."""
    table = inp["page_table"].cpu().numpy()
    allowed = inp["allowed"].cpu().numpy()
    slots, seq, cache_len = allowed.shape
    page_live = allowed.reshape(slots, seq, PAGES_PER_SLOT, PAGE).any(
        axis=(1, 3))
    distinct = len(set(table[page_live].tolist()))
    kv_item = 1 if quantized else 2
    page_bytes = PAGE * HEADS * HEAD_DIM * kv_item * 2
    nbytes = (distinct * page_bytes
              + 2 * inp["q"].numel() * inp["q"].element_size()
              + table.nbytes + allowed.nbytes)
    if quantized:
        nbytes += distinct * HEADS * 4 * 2
    flops = 4.0 * HEAD_DIM * HEADS * float(allowed.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["f32" if quantized else "bf16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_call(inp, quantized):
    """One PyTorch call computing the same function: the gathered dense
    view, then scaled_dot_product_attention with the boolean mask.
    Timed as a yardstick only."""
    import torch
    import torch.nn.functional as F

    pt = inp["page_table"].long()
    slots = pt.shape[0]
    k = inp["key_pages"][pt]
    v = inp["value_pages"][pt]
    dtype = torch.float32 if quantized else torch.bfloat16
    if quantized:
        k = k.float() * inp["key_scales"][pt][:, :, None, :, None]
        v = v.float() * inp["value_scales"][pt][:, :, None, :, None]
    k = k.reshape(slots, -1, HEADS, HEAD_DIM).transpose(1, 2)
    v = v.reshape(slots, -1, HEADS, HEAD_DIM).transpose(1, 2)
    q = inp["q"].to(dtype).transpose(1, 2)
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=inp["allowed"][:, None])


def check_kernels(device):
    import torch
    from cloud_tpu_torch.ops import paged_attention as pa_mod  # noqa: F401

    pa = sys.modules["cloud_tpu_torch.ops.paged_attention"]
    rng = np.random.default_rng(0)
    rows = {}
    for quantized in (False, True):
        name = "paged_attention_int8" if quantized else "paged_attention"
        row = {"max_abs_err": 0.0}
        for seq in (1, 4):
            inp = kernel_inputs(rng, seq, quantized, device)
            args = (inp["q"], inp["key_pages"], inp["value_pages"],
                    inp["page_table"], inp["allowed"])
            kw = ({"key_scales": inp["key_scales"],
                   "value_scales": inp["value_scales"]} if quantized
                  else {})
            out = pa.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            ref = pa.paged_attention_reference(*args, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= KERNEL_TOL:
                raise AssertionError(
                    "{} seq={} disagrees with its plain version: max abs "
                    "err {} > {}".format(name, seq, err, KERNEL_TOL))
            dead = ~inp["allowed"].any(dim=-1)
            if not dead.any() or (out[dead] != 0).any():
                raise AssertionError(
                    "{} seq={}: masked rows are not exact zeros".format(
                        name, seq))
            if not torch.isfinite(out).all():
                raise AssertionError("{}: non-finite output".format(name))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            log("kernel {} seq={}: max abs err {:.3e} (tol {})".format(
                name, seq, err, KERNEL_TOL))
            if seq != 1:
                continue
            # The tick's shape (seq 1) is the one timed.
            row["ms"] = timed_ms(lambda: pa.paged_attention(*args, **kw))
            row["plain_ms"] = timed_ms(
                lambda: pa.paged_attention_reference(*args, **kw))
            row["library_ms"] = timed_ms(
                lambda: library_call(inp, quantized))
            row["bound_ms"], row["bound_by"] = bound_ms(inp, quantized)
            log("kernel {} seq=1: {:.4f} ms (bound {:.4f} ms by {}), "
                "plain {:.4f} ms, library {:.4f} ms".format(
                    name, row["ms"], row["bound_ms"], row["bound_by"],
                    row["plain_ms"], row["library_ms"]))
        rows[name] = row
    return rows


# -- phase 5: serving ---------------------------------------------------

def serve(model, ref_model, n_requests, n_sampled, kv_dtype, seed):
    import torch
    from cloud_tpu_torch.models import generate
    from cloud_tpu_torch.ops import paged_attention as _  # noqa: F401
    from cloud_tpu_torch.serving import Scheduler, ServeRequest

    from cloud_tpu_torch.ops import decode_block

    pa = sys.modules["cloud_tpu_torch.ops.paged_attention"]
    rng = np.random.default_rng(seed)
    requests = []
    for i in range(n_requests):
        prompt = rng.integers(0, model.vocab_size,
                              size=int(rng.integers(16, 201))).tolist()
        sampled = i >= n_requests - n_sampled
        requests.append(ServeRequest(
            prompt=prompt, max_new_tokens=int(rng.integers(32, 65)),
            temperature=0.8 if sampled else 0.0,
            top_k=40 if sampled else None, rng_seed=1000 + i))
    with Scheduler(model, slots=SLOTS, page_size=PAGE,
                   prefix_cache=False, kv_dtype=kv_dtype) as sched:
        sched.warmup([16, 32, 64, 128, 256],
                     sampling_configs=((), dict(temperature=0.8, top_k=40)))
        pa.reset_launches()
        decode_block.reset_launches()
        t0 = time.monotonic()
        futures = [sched.submit(r) for r in requests]
        results = [f.result(timeout=600) for f in futures]
        wall = time.monotonic() - t0
        launches = dict(pa.launches, **decode_block.launches)
        stats = sched.stats()
        sched.assert_drained()
    ticks = stats["ticks"]
    name = "paged_attention_int8" if kv_dtype else "paged_attention"
    other = "paged_attention" if kv_dtype else "paged_attention_int8"
    want = model.num_layers * ticks
    if ticks < 1 or launches[name] != want or launches[other] != 0:
        raise AssertionError(
            "{} launches {} over {} ticks; expected {} (= layers x ticks) "
            "and none of {}".format(name, launches, ticks, want, other))
    tokens_out = sum(r.max_new_tokens for r in requests)
    for req, res in zip(requests, results):
        if res.tokens.shape != (len(req.prompt) + req.max_new_tokens,):
            raise AssertionError("bad result shape {}".format(
                res.tokens.shape))
        if not ((res.tokens >= 0) & (res.tokens < model.vocab_size)).all():
            raise AssertionError("token outside the vocabulary")

    sampled_checked = 0
    for req, res in zip(requests, results):
        if not req.temperature:
            continue
        solo = generate(model, [req.prompt], req.max_new_tokens,
                        seed=req.rng_seed, temperature=req.temperature,
                        top_k=req.top_k, kv_dtype=kv_dtype)[0].numpy()
        if not np.array_equal(solo, res.tokens):
            raise AssertionError(
                "sampled request (seed {}) differs from solo generate()"
                .format(req.rng_seed))
        sampled_checked += 1

    exact = total = 0
    worst = 0.0
    for req, res in zip(requests, results):
        if req.temperature:
            continue
        tokens = torch.as_tensor(res.tokens, device=model.device)[None]
        logits = ref_model(tokens, None, ref_model.init_cache(1))[0]
        p = len(req.prompt)
        rows = logits[p - 1:p - 1 + req.max_new_tokens]
        chosen = rows.gather(1, tokens[0, p:, None])[:, 0]
        gap = (rows.max(dim=1).values - chosen).cpu().numpy()
        if not np.isfinite(gap).all():
            raise AssertionError("non-finite reference logits")
        worst = max(worst, float(gap.max()))
        exact += int((rows.argmax(dim=1) == tokens[0, p:]).sum())
        total += req.max_new_tokens
    share = exact / total
    log("serve kv_dtype={!r}: teacher-forced greedy check: {}/{} exact "
        "argmax ({:.4f}), worst gap {:.4f} (margin {}, need >= {})".format(
            kv_dtype, exact, total, share, worst, LOGIT_MARGIN[kv_dtype],
            MIN_EXACT))
    if worst > LOGIT_MARGIN[kv_dtype] or share < MIN_EXACT:
        raise AssertionError("greedy tokens disagree with the f32 "
                             "teacher-forced forward")
    ttfts = np.array([r.ttft_s for r in results])
    summary = {
        "kv_dtype": kv_dtype or "bf16", "requests": n_requests,
        "sampled_equal_solo": sampled_checked, "ticks": ticks,
        "launches": launches[name], "tokens": tokens_out,
        "wall_s": wall, "tokens_per_s": tokens_out / wall,
        "ttft_p50_s": float(np.percentile(ttfts, 50)),
        "ttft_p99_s": float(np.percentile(ttfts, 99)),
        "tick_p50_s": stats["token_latency"]["p50"],
        "greedy_exact_share": share, "greedy_worst_gap": worst,
    }
    log("serve kv_dtype={!r}: {} requests, {} ticks, launches {}, "
        "{:.1f} tokens/s, TTFT p50 {:.4f} s p99 {:.4f} s".format(
            kv_dtype, n_requests, ticks, launches,
            summary["tokens_per_s"], summary["ttft_p50_s"],
            summary["ttft_p99_s"]))
    return launches, summary


def kernel_table(prof, calls, top=16):
    """The device kernels of a profile by name, per call: [(count, us,
    name)], the `top` that took the most time."""
    import torch

    table = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n, us = table.get(evt.name, (0, 0.0))
        table[evt.name] = (n + 1, us + evt.time_range.elapsed_us())
    rows = sorted(((n / calls, us / calls, name[:60])
                   for name, (n, us) in table.items()), key=lambda r: -r[1])
    return [(round(n, 2), round(us, 1), name) for n, us, name in rows[:top]]


def tick_breakdown(model, graphs=None, kv_dtype=""):
    """One engine with all 8 slots decoding (128-token prompts): the
    host wall time of each of 20 ticks (p50; tokens/s at 8 slots from
    it), then under torch.profiler 20 more: the device time of all
    kernels and of the paged-attention kernels (the per-chunk kernel and
    the merge), the kernels a tick, the per-chunk kernel's count a tick,
    and the busy share (device time over the profiled wall).
    graphs: None replays the tick's CUDA graph (captured before the
    timed ticks), False runs the tick eagerly (the engine's yardstick).
    Returns a dict; device figures are None when the profiler reports
    no device time."""
    import torch
    from cloud_tpu_torch.serving.engine import DecodeEngine

    engine = DecodeEngine(model, SLOTS, PAGE, SLOTS * PAGES_PER_SLOT + 1,
                          graphs=graphs, page_dtype=kv_dtype)
    greedy = dict(temperature=0.0, top_k=None, top_p=None, eos_token=None)
    rng = np.random.default_rng(3)
    engine.warm(widths=[128])
    for slot in range(SLOTS):
        result = engine.prefill(
            rng.integers(0, model.vocab_size, size=128), 64, slot, greedy)
        vec = 1 + slot * PAGES_PER_SLOT + np.arange(PAGES_PER_SLOT)
        engine.insert(slot, result, vec, vec, greedy)
    for _ in range(3):
        engine.tick()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ticks = 20
    host = []
    for _ in range(ticks):
        t1 = time.monotonic()
        engine.tick()
        host.append(time.monotonic() - t1)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / ticks
    device_us = attn_us = 0.0
    attn_kernels = 0
    log("tick kernels ({}, {} pages; per tick: count, us): {}".format(
        "replayed" if engine.graphs else "eager", kv_dtype or "bf16",
        kernel_table(prof, ticks)))
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = evt.time_range.elapsed_us()
        device_us += dev
        if "paged_attention_" in evt.name:
            attn_us += dev
        if "paged_attention_kernel" in evt.name:
            attn_kernels += 1
    out = {"graphs": engine.graphs, "kv_dtype": kv_dtype or "bf16",
           "profiled_tick_ms": wall_ms, "kernels_per_tick": sum(
               1 for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA) / ticks,
           "tick_p50_ms": statistics.median(host) * 1e3,
           "tokens_per_s": SLOTS / statistics.median(host),
           "paged_kernels_per_tick": attn_kernels / ticks,
           "device_ms_per_tick": None, "attention_ms_per_tick": None,
           "device_busy_share": None}
    if device_us > 0:
        out.update(device_ms_per_tick=device_us / 1e3 / ticks,
                   attention_ms_per_tick=attn_us / 1e3 / ticks,
                   device_busy_share=device_us / 1e3 / ticks / wall_ms)
    # The per-chunk kernel counted over 5 ticks, up to three times, each
    # after a warm-up step of the profiler (whose records are dropped):
    # the profiler can drop a record at the start of a session in a
    # long-lived process (a count below the launches; above them would
    # be a launch too many).
    counts = []

    def count(prof):
        counts.append(sum(
            1 for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and "paged_attention_kernel" in evt.name))

    for _ in range(3):
        with torch.profiler.profile(
                activities=acts, on_trace_ready=count,
                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                 active=1,
                                                 repeat=1)) as prof:
            for _ in range(2):
                for _ in range(5):
                    engine.tick()
                torch.cuda.synchronize()
                prof.step()
        if counts and counts[-1] == 5 * model.num_layers:
            break
    out["paged_kernels_in_5_ticks"] = counts
    log("tick breakdown ({}, {} pages, 8 slots, depth 128-192, under "
        "the profiler): {}".format("replayed" if engine.graphs else "eager",
                                   kv_dtype or "bf16", json.dumps(out)))
    return out


def tick_breakdowns(model):
    """The tick eager and replayed, side by side; the profiler must see
    each layer's paged kernel once a tick, replayed and eager alike: in
    one of three tries of 5 ticks, layers x 5, and never more."""
    both = {"eager": tick_breakdown(model, graphs=False),
            "replayed": tick_breakdown(model)}
    want = 5 * model.num_layers
    for label, out in both.items():
        counts = out["paged_kernels_in_5_ticks"]
        if max(counts) > want or want not in counts:
            raise AssertionError(
                "the profiler saw {} paged kernels in 5 {} ticks (three "
                "tries); expected {} (layers x ticks) in one".format(
                    counts, label, want))
    return both


# -- phase 3: flash attention against its plain version --------------

# (B, S, H, H_kv, D): Qwen3-30B-A3B's attention at phase 9's batch, and
# DeepSeek-V4-Flash's dense attention (64 heads over one KV head, head_dim
# 512) at B 1, S 2048.
QWEN3_ATTENTION = (2, 2048, 32, 4, 128)
DEEPSEEK_V4_ATTENTION = (1, 2048, 64, 1, 512)
# ViT-B/16's attention at phase 11's batch 256: 197 tokens (196 patches
# of 16 x 16 at 224 x 224, and the cls token), 12 heads of 64,
# non-causal. No tile divides 197: the kernels mask the keys past S.
VIT_ATTENTION = (256, 197, 12, 12, 64)

FLASH_CASES = (
    # name, dtype, (B, S, H, H_kv, D), kwargs, mask kind, q scale
    ("gpt2_bf16", "bf16", (8, 1024, 12, 12, 64), dict(causal=True), None, 1),
    ("gpt2_f32", "f32", (8, 1024, 12, 12, 64), dict(causal=True), None, 1),
    ("llama_bf16", "bf16", (2, 2048, 32, 8, 128), dict(causal=True), None,
     1),
    # TinyLlama-1.1B's training shape: GQA group 8, head_dim 64.
    ("tinyllama_bf16", "bf16", (4, 2048, 32, 4, 64), dict(causal=True), None,
     1),
    ("gpt2_mask", "bf16", (8, 1024, 12, 12, 64), dict(causal=True), "dead",
     1),
    ("gpt2_window", "bf16", (8, 1024, 12, 12, 64),
     dict(causal=True, window=256), None, 1),
    # q x 30: logits of std 30, so the cap of 50 bends most of them and
    # its derivative 1 - tanh^2 ranges over (0, 1].
    ("gpt2_softcap", "bf16", (8, 1024, 12, 12, 64),
     dict(causal=True, logit_softcap=50.0), None, 30),
    ("gpt2_s1000", "bf16", (8, 1000, 12, 12, 64), dict(causal=True), None,
     1),
    ("gpt2_noncausal", "bf16", (8, 1024, 12, 12, 64), dict(causal=False),
     None, 1),
    # TinyLlama's widths at a ragged S: the last tiles of each example are
    # partial, and a q tile's rows past S border the next example's rows.
    ("tinyllama_s1000", "bf16", (3, 1000, 32, 4, 64), dict(causal=True),
     None, 1),
    # Gemma-2-2B's attention (the public google/gemma-2-2b config.json: 8
    # heads over 4 KV heads, head_dim 256, attn_logit_softcapping 50,
    # query_pre_attn_scalar 256, so sm_scale 1/16; sliding window 4096,
    # which does nothing at S 2048, so window 512 stands in for it), at B 2,
    # S 2048. q x 20: logits of std 20, so the cap bends them.
    ("gemma2_bf16", "bf16", (2, 2048, 8, 4, 256),
     dict(causal=True, sm_scale=1 / 16, logit_softcap=50.0), None, 20),
    ("gemma2_window_bf16", "bf16", (2, 2048, 8, 4, 256),
     dict(causal=True, sm_scale=1 / 16, logit_softcap=50.0, window=512),
     None, 20),
    # head_dims between the template widths. Phi-3-mini's attention (the
    # public microsoft/Phi-3-mini-4k-instruct config.json: 32 heads, no
    # GQA, hidden 3072, so head_dim 96) and phi-2's head_dim 80 (the public
    # microsoft/phi-2: 32 heads, hidden 2560) at B 2, S 2048; D 32 and D
    # 36 (not a multiple of 8: the zero-padded copy) and D 96 in f32 at a
    # small shape.
    ("phi3_d96_bf16", "bf16", (2, 2048, 32, 32, 96), dict(causal=True),
     None, 1),
    ("phi2_d80_bf16", "bf16", (2, 2048, 32, 32, 80), dict(causal=True),
     None, 1),
    ("d32_bf16", "bf16", (2, 300, 8, 4, 32), dict(causal=True), "dead", 1),
    ("d36_bf16", "bf16", (2, 300, 8, 4, 36), dict(causal=True), "dead", 1),
    ("d96_f32", "f32", (2, 300, 8, 4, 96), dict(causal=True), "dead", 1),
    # Qwen3-30B-A3B's attention (phase 9's training shape: 32 heads over 4
    # KV heads, head_dim 128) at B 2, S 2048.
    ("qwen3moe_bf16", "bf16", QWEN3_ATTENTION, dict(causal=True), None, 1),
    # head_dims past the widest template: the wide kernels. The dense
    # attention of the public deepseek-ai/DeepSeek-V4-Flash (64 heads over
    # one KV head, head_dim 512) at B 1, S 2048; D 264, D 320 with window,
    # softcap and key mask (q x 4: logits of std ~4 against the cap of 8),
    # D 576 (sarvam-105b's) over one KV head, and f32 at D 320, at a small
    # shape.
    ("deepseek_v4_flash_d512_bf16", "bf16", DEEPSEEK_V4_ATTENTION,
     dict(causal=True), None, 1),
    ("d264_bf16", "bf16", (2, 300, 8, 4, 264), dict(causal=True), "dead", 1),
    ("d320_window_softcap_mask_bf16", "bf16", (2, 300, 8, 4, 320),
     dict(causal=True, window=64, logit_softcap=8.0), "dead", 4),
    ("d576_bf16", "bf16", (2, 300, 8, 1, 576), dict(causal=True), None, 1),
    ("d320_f32", "f32", (2, 300, 8, 4, 320), dict(causal=True), "dead", 1),
    # ViT-B/16's attention (phase 11's training shape), non-causal.
    ("vit_b16_bf16", "bf16", VIT_ATTENTION, dict(causal=False), None, 1),
)
GEMMA2_ATTENTION = (2, 2048, 8, 4, 256)
PHI3_ATTENTION = (2, 2048, 32, 32, 96)
PHI2_ATTENTION = (2, 2048, 32, 32, 80)
# The case at each training path's shape; its errors go into that path's
# rows of the kernel table.
FLASH_PATH_CASES = {"gpt2_bf16": "gpt2_train",
                    "tinyllama_bf16": "tinyllama_train",
                    "qwen3moe_bf16": "qwen3moe_train",
                    "vit_b16_bf16": "vit_train"}


def flash_inputs(rng, dtype, shape, mask_kind, device, q_scale=1):
    import torch

    batch, seq, heads, kv_heads, head_dim = shape
    tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32

    def t(h, scale=1):
        x = rng.standard_normal((batch, seq, h, head_dim), dtype=np.float32)
        return torch.tensor(x * scale, dtype=tdtype, device=device)

    q, k, v, dout = t(heads, q_scale), t(kv_heads), t(kv_heads), t(heads)
    mask = None
    if mask_kind == "dead":
        m = rng.random((batch, seq)) < 0.8
        m[0] = False          # every row of example 0: no allowed key
        m[1, :100] = False    # rows 0..99 of example 1: no allowed key
        mask = torch.tensor(m, device=device)
    return q, k, v, dout, mask


def reference_lse(q, k, mask, causal=True, window=None, logit_softcap=None,
                  sm_scale=None):
    """logsumexp of the plain version's masked f32 logits, [B, H, S];
    -1e30 on rows with no allowed key."""
    import torch
    from cloud_tpu_torch.ops import attention as tatt

    k = tatt.repeat_kv(k, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (sm_scale or 1 / np.sqrt(q.shape[-1]))
    if logit_softcap:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    seq = q.shape[1]
    allowed = torch.ones((seq, seq), dtype=torch.bool, device=q.device)
    if causal:
        row = torch.arange(seq, device=q.device)[:, None]
        col = torch.arange(seq, device=q.device)[None, :]
        allowed = col <= row
        if window:
            allowed = allowed & (col > row - window)
    allowed = allowed[None, None].expand(q.shape[0], 1, seq, seq)
    if mask is not None:
        allowed = allowed & mask[:, None, None, :]
    logits = torch.where(allowed, logits, torch.full((), -float("inf"),
                                                     device=q.device))
    lse = torch.logsumexp(logits, dim=-1)
    return torch.where(allowed.any(-1), lse,
                       torch.full((), -1e30, device=q.device))


def compare(got, want, rtol, atol):
    """Element-wise comparison of a kernel's tensor with the plain
    version's (f32), rows along the last axis: the worst ratio of
    |got - want| to rtol |want| + atol rms(row of want) (the gate: at
    most 1; rms(row) floored at ROW_FLOOR x the tensor's rms), the worst
    |got - want| over its (floored) row rms, the worst over max |want|,
    the largest |got - want|, and where the worst ratio lies."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = torch.clamp(want.square().mean(-1, keepdim=True).sqrt(),
                      min=ROW_FLOOR * want.square().mean().sqrt().item())
    zero = torch.zeros((), device=err.device)
    ratio = torch.where(err == 0, zero, err / (rtol * want.abs() + atol * rms))
    row = torch.where(err == 0, zero, err / rms)
    worst = int(ratio.argmax())
    return {"tol_ratio": ratio.max().item(),
            "row_normalized": row.max().item(),
            "max_normalized": err.max().item() / max(
                want.abs().max().item(), 1e-30),
            "max_abs_err": err.max().item(),
            "worst_at": list(np.unravel_index(worst, tuple(err.shape)))}


def check_flash_kernels(device, names=None):
    """Every FLASH_CASES case through the public `flash_attention` and
    `torch.autograd.grad` (the training path's calls): out element by
    element (`compare`) against `mha_reference` in f32 on the same
    inputs, with the lse the forward kernel saved for the backward; dq,
    dk, dv element by element against `mha_backward_reference` on the
    backward's inputs, and end to end against mha_reference's autograd.
    Returns ({path: per-kernel max abs error over the case at that
    training path's shape}, details of every case)."""
    import torch
    from cloud_tpu_torch.ops import attention as tatt

    rng = np.random.default_rng(10)
    details = {}
    path_err = {}
    for name, dtype, shape, kw, mask_kind, q_scale in FLASH_CASES:
        if names is not None and name not in names:
            continue
        q, k, v, dout, mask = flash_inputs(rng, dtype, shape, mask_kind,
                                           device, q_scale)
        leaves = [x.requires_grad_(True) for x in (q, k, v)]
        out = tatt.flash_attention(*leaves, mask=mask, **kw)
        node = out.grad_fn
        while not hasattr(node, "saved_tensors"):
            # The slice back to D of a call on a zero-padded copy.
            node = node.next_functions[0][0]
        lse = node.saved_tensors[-1]   # [B, H, S], f32
        dq, dk, dv = torch.autograd.grad(out, leaves, dout)
        torch.cuda.synchronize()
        f32 = [x.detach().float() for x in (q, k, v, dout)]
        # delta as the backward computes it, from the forward's output.
        delta = (f32[3] * out.detach().float()).sum(-1).transpose(1, 2)
        plain = (tatt.mha_reference(*f32[:3], mask=mask, **kw),) + \
            tatt.mha_backward_reference(*f32, delta, mask=mask, **kw)
        rlse = reference_lse(f32[0], f32[1], mask, **kw)
        ref_leaves = [x.requires_grad_(True) for x in f32[:3]]
        whole = torch.autograd.grad(
            tatt.mha_reference(*ref_leaves, mask=mask, **kw), ref_leaves,
            f32[3])
        tol = FLASH_TOL[dtype]
        row = {"shape": shape, "dtype": dtype, "kwargs": kw,
               "mask": mask_kind, "q_scale": q_scale}
        for key, got, want in zip(("out", "dq", "dk", "dv"),
                                  (out, dq, dk, dv), plain):
            if got.dtype != q.dtype or got.shape != want.shape:
                raise AssertionError("flash {} {}: {} {}, want {} {}".format(
                    name, key, got.dtype, tuple(got.shape), q.dtype,
                    tuple(want.shape)))
            row[key] = compare(got, want, tol["rtol"], tol["atol"])
            if not torch.isfinite(got).all() or \
                    not row[key]["tol_ratio"] <= 1.0:
                raise AssertionError(
                    "flash {} {}: error {:.3e} of the bound (rtol {} + atol "
                    "{} x row rms) at {}".format(
                        name, key, row[key]["tol_ratio"], tol["rtol"],
                        tol["atol"], row[key]["worst_at"]))
        for key, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), whole):
            err = compare(got, want, 0.0, 1.0)["max_normalized"]
            row[key]["end_to_end_max_normalized"] = err
            if not err <= END_TO_END_TOL[dtype]:
                raise AssertionError(
                    "flash {} {}: end to end {:.3e} of max |x| > {}".format(
                        name, key, err, END_TO_END_TOL[dtype]))
        live = rlse > -1e29
        lse_err = (lse - rlse)[live].abs().max().item()
        row["lse"] = {"max_abs_err": lse_err}
        if not lse_err <= tol["lse"] or not (lse[~live] <= -1e29).all():
            raise AssertionError("flash {} lse: err {} > {} or a dead row "
                                 "lse above -1e29".format(name, lse_err,
                                                          tol["lse"]))
        if mask_kind == "dead":
            if not ((out[0] == 0).all() and (dq[0] == 0).all()
                    and (dk[0] == 0).all() and (dv[0] == 0).all()
                    and (out[1, :100] == 0).all()):
                raise AssertionError("flash {}: rows with no allowed key "
                                     "are not zeros".format(name))
        details[name] = row
        keys = ("out", "dq", "dk", "dv")
        log("flash {} {}: of the bound (rtol {} + atol {} x row rms) out "
            "{:.3f} dq {:.3f} dk {:.3f} dv {:.3f}; worst err over its row's "
            "rms out {:.2e} dq {:.2e} dk {:.2e} dv {:.2e}; end to end over "
            "max |x| dq {:.2e} dk {:.2e} dv {:.2e} (tol {}); lse {:.2e}"
            .format(name, shape, tol["rtol"], tol["atol"],
                    *[row[x]["tol_ratio"] for x in keys],
                    *[row[x]["row_normalized"] for x in keys],
                    *[row[x]["end_to_end_max_normalized"] for x in keys[1:]],
                    END_TO_END_TOL[dtype], lse_err))
        path = FLASH_PATH_CASES.get(name)
        if path:
            path_err[path] = {
                "flash_attention_fwd": row["out"]["max_abs_err"],
                "flash_attention_dq": row["dq"]["max_abs_err"],
                "flash_attention_dkdv": max(row["dk"]["max_abs_err"],
                                            row["dv"]["max_abs_err"])}
        del q, k, v, dout, out, lse, dq, dk, dv, plain, whole, delta
        del leaves, ref_leaves, f32
        torch.cuda.empty_cache()
    return path_err, details


def host_us(fn, n=200):
    """Host time per call of `fn` in microseconds: `n` calls back to back
    on the host clock, without waiting for the device (what the wrapper
    costs the Python thread that launches it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def sdpa_backends(call):
    """Which scaled_dot_product_attention backends take `call`'s inputs
    (each alone under `sdpa_kernel`) and the device kernels the default
    call launched (torch.profiler): the flash backend stops at head_dim
    256, so a wide head_dim runs another."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    accepted = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                call()
            accepted.append(backend.name)
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    names = sorted({evt.name[:80] for evt in prof.events()
                    if evt.device_type == torch.autograd.DeviceType.CUDA})
    return {"accepted": accepted, "kernels": names}


def time_flash_kernels(device, shape=(8, 1024, 12, 12, 64), causal=True):
    """Each kernel at a training shape (B, S, H, H_kv, D; bf16, causal
    unless `causal` is False; GPT-2's by default) by CUDA graph
    replays, beside its bound, the
    plain version (the forward by graph replays; the backward, which
    computes dq, dk and dv together, by `backward_ms`) and
    scaled_dot_product_attention (the same; enable_gqa for H_kv < H),
    and the host time of each wrapper's launch (`host_us`).
    Row "backward" holds the whole backward of the port (`_delta`, dq,
    dk/dv through `flash_attention`'s autograd), SDPA and the plain
    version, all by `backward_ms` (or all by `event_ms` when the
    profiler loses kernels of one of them: its `method`), and `_delta`
    alone."""
    import torch
    import torch.nn.functional as F
    from cloud_tpu_torch.ops import attention as tatt

    batch, seq, heads, kv_heads, head_dim = shape
    gqa = {"enable_gqa": True} if kv_heads != heads else {}
    rng = np.random.default_rng(11)
    q, k, v, dout, _ = flash_inputs(rng, "bf16",
                                    (batch, seq, heads, kv_heads, head_dim),
                                    None, device)
    config = (bool(causal), 1.0 / np.sqrt(head_dim), 0, 0.0)
    out, lse = tatt._launch_forward(q, k, v, None, config)
    delta = tatt._delta(dout, out)
    calls = {
        "flash_attention_fwd": lambda: tatt._launch_forward(q, k, v, None,
                                                            config),
        "flash_attention_dq": lambda: tatt._launch_dq(q, k, v, None, dout,
                                                      lse, delta, config),
        "flash_attention_dkdv": lambda: tatt._launch_dkdv(
            q, k, v, None, dout, lse, delta, config),
    }
    rows = {name: {"ms": timed_ms(call), "host_us": host_us(call)}
            for name, call in calls.items()}
    # The forward's C entry point alone, on arguments built once: what the
    # tensor-map encodes and the launch cost the host, apart from the
    # Python wrapper's checks, allocations and stream lookup.
    fn = tatt._library(q.dtype, head_dim).flash_attention_forward
    out_c, lse_c = torch.empty_like(out), torch.empty_like(lse)
    args = (tatt._KINDS[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None, out_c.data_ptr(), lse_c.data_ptr(),
            *tatt._scalars(q, k, config),
            torch.cuda.current_stream().cuda_stream)
    rows["flash_attention_fwd"]["c_call_host_us"] = host_us(
        lambda: fn(*args))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    qt, kt, vt = (x.transpose(1, 2) for x in leaves)

    def plain_fwd():
        with torch.no_grad():
            return tatt.mha_reference(q, k, v, causal=causal)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  **gqa)

    plain_f = timed_ms(plain_fwd)
    backends = sdpa_backends(sdpa_fwd)
    lib_f = timed_ms(sdpa_fwd)
    # The three backwards, each from its own forward's graph: the plain
    # version's, SDPA's and the port's (delta = rowsum(dO O), plain
    # PyTorch as the JAX backward computes it, then dq and dk/dv,
    # through `flash_attention`'s autograd).
    forwards = {
        "plain": lambda: (tatt.mha_reference(*leaves, causal=causal), dout),
        "sdpa": lambda: (F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, **gqa), dout.transpose(1, 2)),
        "port": lambda: (tatt.flash_attention(*leaves, causal=causal),
                         dout)}

    def by_profiler(o, g):
        return backward_ms(o, leaves, g)

    def by_events(o, g):
        return event_ms(lambda: torch.autograd.grad(o, leaves, g,
                                                    retain_graph=True),
                        iters=10), float("nan")

    timed = {name: by_profiler(*make()) for name, make in forwards.items()}
    method = "profiler"
    if not all(kernels and float(kernels).is_integer()
               for _, kernels in timed.values()):
        # A backward launches the same kernels on every call: none, or a
        # mean count that is not whole, means the profiler lost records
        # (it did at ViT's shape, for SDPA's and the plain backward): all
        # three by CUDA events around queued calls instead, one yardstick
        # for each, the host's launches hidden behind the device's work.
        method = "cuda events"
        timed = {name: by_events(*make()) for name, make in forwards.items()}
    plain_b, plain_kernels = timed["plain"]
    lib_b, lib_kernels = timed["sdpa"]
    port_b, port_kernels = timed["port"]
    rows["sdpa"] = backends
    rows["backward"] = {"port_ms": port_b, "port_kernels": port_kernels,
                        "delta_ms": timed_ms(lambda: tatt._delta(dout, out)),
                        "sdpa_ms": lib_b, "sdpa_kernels": lib_kernels,
                        "plain_ms": plain_b, "method": method}
    cost = tatt.flash_attention_cost(batch, seq, heads, kv_heads, head_dim,
                                     causal=causal)
    for name, part, plain, lib in (
            ("flash_attention_fwd", "forward", plain_f, lib_f),
            ("flash_attention_dq", "dq", plain_b, lib_b),
            ("flash_attention_dkdv", "dkdv", plain_b, lib_b)):
        row = rows[name]
        row["bound_ms"], row["bound_by"] = bound_of(cost[part])
        row["plain_ms"] = plain
        row["library_ms"] = lib
        row["flops"] = cost[part]["flops"]
        row["bytes"] = cost[part]["bytes_moved"]
        log("kernel {} (B {}, S {}, H {}, H_kv {}, D {}, bf16, {}): "
            "{:.4f} ms (bound {:.4f} ms by {}; {:.1f} TFLOP/s), plain {:.4f} "
            "ms, library {:.4f} ms; host {:.1f} us per launch".format(
                name, *shape, "causal" if causal else "non-causal",
                row["ms"], row["bound_ms"], row["bound_by"],
                row["flops"] / row["ms"] / 1e9, plain, lib,
                row["host_us"]))
    log("sdpa at this shape: backends that take it {}; the default call "
        "ran {}".format(backends["accepted"], backends["kernels"]))
    log("host per forward launch: {:.1f} us through the wrapper, {:.1f} us "
        "for the C entry point alone (tensor-map encodes and the launch)"
        .format(rows["flash_attention_fwd"]["host_us"],
                rows["flash_attention_fwd"]["c_call_host_us"]))
    log("plain backward (dq+dk+dv) {:.4f} ms ({:g} kernels per call); sdpa "
        "backward {:.4f} ms ({:g} kernels per call); the port's backward "
        "(delta + dq + dk/dv) {:.4f} ms ({:g} kernels per call; delta alone "
        "{:.4f} ms by graph replays), {:.2f}x sdpa's; each backward alone, "
        "timed by {}".format(
            plain_b, plain_kernels, lib_b, lib_kernels, port_b, port_kernels,
            rows["backward"]["delta_ms"], port_b / lib_b,
            "the profiler" if method == "profiler" else "CUDA events"))
    del q, k, v, dout, out, lse, delta, leaves, out_c, lse_c
    torch.cuda.empty_cache()
    return rows


# -- phase 6: training -------------------------------------------------

def training_data(seed, n, vocab, seq, alphabet=64):
    """n sequences of seq + 1 tokens over an alphabet of `alphabet` token
    ids (drawn from the vocabulary): two interleaved chains, each token
    the image under one fixed random permutation of the token two places
    before it, from two random starts. The next token is independent of
    the current one (the other chain) and fixed by the one before it.
    Returns (x, y) int64 arrays [n, seq] (y is x shifted by one)."""
    rng = np.random.default_rng(seed)
    letters = rng.permutation(vocab)[:alphabet]
    perm = rng.permutation(alphabet)
    idx = np.empty((n, seq + 1), dtype=np.int64)
    idx[:, :2] = rng.integers(0, alphabet, size=(n, 2))
    for t in range(2, seq + 1):
        idx[:, t] = perm[idx[:, t - 2]]
    tokens = letters[idx]
    return tokens[:, :-1].copy(), tokens[:, 1:].copy()


def next_token_entropy(x, y):
    """Entropy in nats of y given x alone (the current token), over
    every position of the data: the least mean loss of any model that
    sees only the current token and its position (every position of the
    chains is alike)."""
    pairs = x.astype(np.int64).ravel() * (int(x.max()) + 1) + y.ravel()
    _, joint = np.unique(pairs, return_counts=True)
    _, marginal = np.unique(x, return_counts=True)
    total = float(x.size)
    # H(Y | X) = H(X, Y) - H(X).
    return float(-(joint / total * np.log(joint / total)).sum()
                 + (marginal / total * np.log(marginal / total)).sum())


def cycle_level(x, y):
    """Mean loss in nats of a model that knows which permutation cycles
    the sequence's two chains run on but not where on them it stands:
    the mean over positions of ln |cycle of the next token|. Each token
    of a chain is the image of the token two places before it under one
    permutation of the alphabet, read here from the data."""
    tokens = np.concatenate([x[:, :1], y], axis=1)
    step2 = dict(zip(tokens[:, :-2].ravel().tolist(),
                     tokens[:, 2:].ravel().tolist()))
    size = {}
    for start in step2:
        if start in size:
            continue
        cycle, tok = [start], step2[start]
        while tok != start:
            cycle.append(tok)
            tok = step2[tok]
        for tok in cycle:
            size[tok] = len(cycle)
    sizes = np.vectorize(size.__getitem__)(y)
    return float(np.log(sizes).mean())


def llama_loss_gate(entropy, cycle):
    """The TinyLlama fit's gate on its last epoch's loss: halfway between
    the entropy of the next token given the current one and the cycle
    level (`cycle_level`).

    No model without working attention gets below that entropy: each
    position then sees only its own token and its position, and every
    position of the chains is alike. The first thing attention gives is
    the bag of earlier tokens, which names the two cycles, and with them
    the loss falls to the cycle level, a plateau; learning where on the
    cycle each chain stands takes it on towards 0, and when that starts
    varies with the rounding of the bf16 gradients. The gate sits below
    what a model without attention can reach and above the plateau, so
    it shows that information came through attention whether or not the
    plateau ends within the fit."""
    return 0.5 * (entropy + cycle)


def matmul_params(model):
    """Parameters that take part in matrix products (every Linear
    weight, the output head included; not the embedding tables)."""
    return sum(p.numel() for n, p in model.named_parameters()
               if n.endswith("weight") and p.ndim == 2
               and not n.startswith(("embed", "pos_embed")))


def one_step_check(model, x, y):
    """Loss and each parameter's gradient norm of one training step from
    the model's current weights, with attention by the kernels and by
    the plain version (the model's attention call swapped for
    mha_reference for the second run only)."""
    import torch
    import torch.nn.functional as F
    from cloud_tpu_torch.models import transformer as ttf
    from cloud_tpu_torch.ops import attention as tatt

    def step():
        model.zero_grad(set_to_none=True)
        logits = model(x)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y.reshape(-1))
        loss.backward()
        norms = {n: p.grad.float().norm().item()
                 for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), norms

    tatt.reset_launches()
    loss_k, norms_k = step()
    launched = dict(tatt.launches)
    kernel_attention = ttf.attention_ops.attention

    def plain(q, k, v, causal=True, mask=None, **kw):
        return tatt.mha_reference(q, k, v, causal=causal, mask=mask, **kw)

    ttf.attention_ops.attention = plain
    try:
        loss_p, norms_p = step()
    finally:
        ttf.attention_ops.attention = kernel_attention
    if launched["flash_attention_fwd"] != model.num_layers:
        raise AssertionError("one-step check did not run the kernels: "
                             "{}".format(launched))
    # The attention key bias gets a zero gradient in exact arithmetic (it
    # shifts every logit of a row alike); its norm is rounding noise in
    # both runs and is not compared.
    worst, worst_name = 0.0, None
    for name, want in norms_p.items():
        if name.endswith("attention.key.bias"):
            continue
        rel = abs(norms_k[name] - want) / max(want, 1e-12)
        if rel > worst:
            worst, worst_name = rel, name
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log("train one-step check: loss kernels {:.6f} plain {:.6f} (rel "
        "{:.2e}, tol {}); worst grad-norm rel diff {:.2e} at {} (tol "
        "{})".format(loss_k, loss_p, loss_rel, STEP_LOSS_TOL, worst,
                     worst_name, STEP_GRAD_TOL))
    if not (np.isfinite(loss_k) and loss_rel <= STEP_LOSS_TOL
            and worst <= STEP_GRAD_TOL):
        raise AssertionError("one training step disagrees with the plain "
                             "attention")
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "loss_rel_diff": loss_rel, "worst_grad_norm_rel_diff": worst,
            "worst_grad_norm_param": worst_name}


def train(device):
    """Phase 6; returns (flash launches in fit, summary dict)."""
    import torch
    from cloud_tpu_torch.models import TransformerLM
    from cloud_tpu_torch.ops import attention as tatt
    from cloud_tpu_torch.training import Trainer, make_optimizer
    from cloud_tpu_torch.training.schedules import warmup_cosine

    model = TransformerLM(compute_dtype=torch.bfloat16, device=device,
                          seed=0, **GPT2_SMALL)
    n_train = TRAIN_BATCH * TRAIN_STEPS
    x, y = training_data(5, n_train + 2 * TRAIN_BATCH, model.vocab_size,
                         TRAIN_SEQ)
    x_val, y_val = x[n_train:], y[n_train:]
    x, y = x[:n_train], y[:n_train]
    entropy = next_token_entropy(x, y)
    check = one_step_check(model,
                           torch.as_tensor(x[:TRAIN_BATCH], device=device),
                           torch.as_tensor(y[:TRAIN_BATCH], device=device))

    total = TRAIN_EPOCHS * TRAIN_STEPS
    trainer = Trainer(model, optimizer=make_optimizer(
        "adamw", warmup_cosine(TRAIN_LR, total, total // 10)),
        metrics=("accuracy",), seed=0)
    reset_all_launches()
    t0 = time.monotonic()
    history = trainer.fit(x, y, batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                          verbose=False)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches = all_launches()
    steps = trainer.state.step
    want = {k: (model.num_layers * steps if k in tatt.launches else 0)
            for k in launches}
    if steps != TRAIN_EPOCHS * TRAIN_STEPS or launches != want:
        raise AssertionError(
            "fit launched {} over {} steps; expected {} (layers x steps of "
            "each flash kernel, no other)".format(launches, steps, want))
    losses = history["loss"]
    log("train fit: {} steps in {:.2f} s, history {}; entropy of the next "
        "token given the current one {:.4f} nats, gate {} x that".format(
            steps, fit_s, json.dumps(history), entropy, LOSS_FALL))
    if not (all(np.isfinite(losses))
            and losses[-1] < LOSS_FALL * entropy < losses[0]):
        raise AssertionError(
            "the last epoch's loss {} is not below {} x {:.4f} (the "
            "entropy of the next token given the current one)".format(
                losses[-1], LOSS_FALL, entropy))

    batches = [(x[i:i + TRAIN_BATCH], y[i:i + TRAIN_BATCH])
               for i in range(0, n_train, TRAIN_BATCH)]
    step_s, times = time_steps(trainer, batches)
    prof = profile_steps(train_step(trainer, batches), ("flash_",))
    cost = tatt.flash_attention_cost(TRAIN_BATCH, TRAIN_SEQ,
                                     model.num_heads, model.num_heads,
                                     model.head_dim, causal=True)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = matmul_params(model)
    # Forward + backward of attention without recomputation: 3 x the
    # forward's two products, per layer.
    step_flops = (6.0 * n_params * tokens
                  + 3 * cost["forward"]["flops"] * model.num_layers)
    mfu = step_flops / step_s / PEAK_FLOPS["bf16"]
    val, pred_loss, val2 = evaluate_and_predict(trainer, x_val, y_val,
                                                TRAIN_BATCH, TRAIN_SEQ,
                                                model.vocab_size)
    summary = {
        "model": "GPT-2 small bf16", "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": steps, "history": history,
        "peak_lr": TRAIN_LR, "next_token_entropy_given_current": entropy,
        "fit_s": fit_s, "launches": launches, "one_step_check": check,
        "step_p50_s": step_s, "step_times_s": times,
        "tokens_per_s": tokens / step_s, "matmul_params": n_params,
        "step_flops": step_flops, "mfu": mfu,
        "device_busy_share": prof["device_busy_share"],
        "flash_share_of_device": prof["matched_share_of_device"],
        "device_ms_per_step": prof["device_ms_per_step"],
        "kernels_per_step": prof["kernels_per_step"],
        "top_kernels": prof["top_kernels"],
        "evaluate": val, "predict_loss_2_seqs": pred_loss,
        "evaluate_loss_2_seqs": val2["loss"],
    }
    log("train: step p50 {:.2f} ms, {:.0f} tokens/s, MFU {:.4f}, device "
        "busy {}, flash kernels {} of device time; evaluate {}".format(
            step_s * 1e3, tokens / step_s, mfu, prof["device_busy_share"],
            summary["flash_share_of_device"], json.dumps(val)))
    log_top_kernels("train", prof["top_kernels"])
    return launches, summary


def time_steps(trainer, batches, n=10):
    """Host wall time of `n` more steps through the Trainer's step body,
    each closed by a synchronize: (p50 seconds, every step's seconds)."""
    import torch

    times = []
    for i in range(n):
        t1 = time.monotonic()
        trainer._train_step(batches[i % len(batches)], False)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t1)
    return float(np.median(times)), times


def train_step(trainer, batches):
    """step(i): the Trainer's step body on batch i (cycling)."""
    return lambda i: trainer._train_step(batches[i % len(batches)], False)


def profile_steps(step, match, n=3):
    """`n` calls step(0) .. step(n - 1) under torch.profiler: the device
    busy share (the union of the device events' intervals over the host
    wall time; events may overlap, so their sum may exceed it), device
    ms per step, the share of device time in kernels whose name holds
    one of `match`, the device kernels launched per step, and the top
    10 kernels by device time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.monotonic()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        prof_wall_us = (time.monotonic() - t1) * 1e6
    spans, by_name = [], {}
    for evt in prof.events():
        # User annotations on the device timeline (Optimizer.step spans)
        # cover kernels that are counted on their own.
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        by_name[evt.name] = (by_name.get(evt.name, 0.0)
                             + evt.time_range.elapsed_us())
    device_us = 0.0
    end = None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            device_us += hi - lo
            end = hi
        elif hi > end:
            device_us += hi - end
            end = hi
    matched_us = sum(v for k, v in by_name.items()
                     if any(m in k for m in match))
    total_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "device_busy_share": (device_us / prof_wall_us if device_us > 0
                              else None),
        "device_ms_per_step": total_us / 1e3 / n,
        "kernels_per_step": len(spans) / n,
        "matched_share_of_device": (matched_us / total_us if total_us
                                    else None),
        "top_kernels": [{"name": k[:120], "ms_per_step": v / 1e3 / n,
                         "share": v / total_us if total_us else None}
                        for k, v in top],
    }


def log_top_kernels(phase, top):
    for row in top:
        log("{} top kernel {:.3f} ms/step ({:.1%}): {}".format(
            phase, row["ms_per_step"], row["share"] or 0.0, row["name"]))


def evaluate_and_predict(trainer, x_val, y_val, batch, seq, vocab):
    """`evaluate` on the held-out sequences and `predict` on the first
    two, whose loss must equal `evaluate`'s on the same two. Returns
    (evaluate logs, predict's loss, evaluate's logs on the two)."""
    val = trainer.evaluate(x_val, y_val, batch_size=batch, verbose=False)
    pred = trainer.predict(x_val[:2], batch_size=2)
    if pred.shape != (2, seq, vocab) or not np.isfinite(pred).all():
        raise AssertionError("predict gave {} {}".format(pred.shape,
                                                         pred.dtype))
    logp = pred - pred.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    pred_loss = float(-np.take_along_axis(logp, y_val[:2, :, None],
                                          -1).mean())
    val2 = trainer.evaluate(x_val[:2], y_val[:2], batch_size=2,
                            verbose=False)
    if not (np.isfinite(val["loss"]) and abs(pred_loss - val2["loss"])
            <= 1e-3 * max(1.0, val2["loss"])):
        raise AssertionError("predict's loss {} disagrees with evaluate's "
                             "{}".format(pred_loss, val2["loss"]))
    return val, pred_loss, val2


# -- phase 4: fused RMSNorm and fused SwiGLU against their plain versions --

LLAMA_ROWS, LLAMA_D, LLAMA_F = 4 * 2048, 2048, 5632
# Fused norm, per element (`compare`), against the plain version with an
# f32 output on the same inputs (the same h): |kernel - plain| <= rtol
# |plain| + atol rms(row). bf16 output: rtol 2^-8, the output's single
# rounding (at most half a bf16 step); atol 1e-5 covers the last bits of
# the f32 statistics (the row sum in another order; rsqrtf). f32 output:
# rtol 1e-6, atol 1e-5, the statistics alone. h must be bit-equal.
NORM_TOL = {"bf16": (2.0 ** -8, 1e-5), "f32": (1e-6, 1e-5)}
NORM_CASES = (
    # name, rows, dtype, residual
    ("residual_bf16", LLAMA_ROWS, "bf16", True),
    ("noresidual_bf16", LLAMA_ROWS, "bf16", False),
    ("residual_bf16_rows8191", LLAMA_ROWS - 1, "bf16", True),
    ("noresidual_bf16_rows8191", LLAMA_ROWS - 1, "bf16", False),
    ("residual_f32", LLAMA_ROWS, "f32", True),
    ("noresidual_f32", LLAMA_ROWS, "f32", False),
)
# Fused MLP, per element, against the plain computation in f32 on the same
# compute-dtype inputs with the kernels' rounding points (g, u, act(g) and
# act(g) * u rounded to the compute dtype): the pair's output y within rtol
# 2^-8 (its rounding) + atol 1e-2 rms(row) (an element of the intermediate
# next to a rounding boundary may round the other way after f32 sums in
# another order); the intermediate a within rtol 2^-5 + the same atol (g
# or u rounded the other way moves it by one bf16 step of g or u, up to
# 2^-7 of them, which the activation's slope |d ln act / d ln g| can
# double and more on its negative side, plus the two later roundings);
# the down
# kernel alone, on the gate|up kernel's own a, within rtol 2^-8 + atol
# 1e-3 rms(row) (summation order). f32: rtol 1e-5 + atol 1e-5 rms(row) for
# all three (summation order).
MLP_TOL = {"bf16": {"y": (2.0 ** -8, 1e-2), "a": (2.0 ** -5, 1e-2),
                    "down": (2.0 ** -8, 1e-3)},
           "f32": {"y": (1e-5, 1e-5), "a": (1e-5, 1e-5),
                   "down": (1e-5, 1e-5)}}
MLP_CASES = (
    # name, rows, D, F, dtype, activation
    ("silu_bf16", LLAMA_ROWS, LLAMA_D, LLAMA_F, "bf16", "silu"),
    ("gelu_tanh_bf16", 1024, LLAMA_D, LLAMA_F, "bf16", "gelu_tanh"),
    ("gelu_bf16", 1024, LLAMA_D, LLAMA_F, "bf16", "gelu"),
    ("silu_bf16_rows1000", 1000, LLAMA_D, LLAMA_F, "bf16", "silu"),
    ("silu_bf16_rows8", 8, LLAMA_D, LLAMA_F, "bf16", "silu"),
    # No width a multiple of the bf16 tiles (128 rows, 256 weight rows,
    # 64 deep): K tails 520 = 8 x 64 + 8 and 1352 = 21 x 64 + 8.
    ("silu_bf16_ragged", 1000, 520, 1352, "bf16", "silu"),
    # Fewer tiles than SMs (8 of each kernel).
    ("silu_bf16_rows128", 128, LLAMA_D, 1024, "bf16", "silu"),
    ("silu_f32", 256, 512, 1352, "f32", "silu"),
)


def _dtype(name):
    import torch

    return torch.bfloat16 if name == "bf16" else torch.float32


def check_norm_kernels(device):
    """NORM_CASES through the public `fused_rmsnorm` (launch counted),
    then the main shapes (rows 8192, D 2048, bf16) timed beside the
    bound, the plain version and F.rms_norm (which the port never
    calls). Returns (rows by kernel name, details by case)."""
    import torch
    import torch.nn.functional as F
    from cloud_tpu_torch.ops import fused_norm as tfn

    rng = np.random.default_rng(20)
    details, rows_out = {}, {}
    max_err = {"fused_norm": 0.0, "fused_norm_noresidual": 0.0}
    for name, rows, dtype, residual in NORM_CASES:
        tdt = _dtype(dtype)
        x = torch.tensor(rng.standard_normal((rows, LLAMA_D),
                                             dtype=np.float32),
                         dtype=tdt, device=device)
        r = torch.tensor(rng.standard_normal((rows, LLAMA_D),
                                             dtype=np.float32),
                         dtype=tdt, device=device) if residual else None
        scale = torch.tensor(1.0 + 0.1 * rng.standard_normal(LLAMA_D),
                             dtype=torch.float32, device=device)
        kernel = "fused_norm" if residual else "fused_norm_noresidual"
        before = tfn.launches[kernel]
        normed, h = tfn.fused_rmsnorm(x, scale, residual=r, eps=1e-5)
        torch.cuda.synchronize()
        if tfn.launches[kernel] != before + 1:
            raise AssertionError("fused_rmsnorm did not launch " + kernel)
        plain, plain_h = tfn.rmsnorm_residual_reference(
            x, scale, residual=r, eps=1e-5, out_dtype=torch.float32)
        if normed.dtype != tdt or not torch.equal(h, plain_h):
            raise AssertionError("fused norm {}: h differs from x + r or "
                                 "normed is {}".format(name, normed.dtype))
        rtol, atol = NORM_TOL[dtype]
        row = compare(normed, plain, rtol, atol)
        details[name] = row
        log("fused norm {} (rows {}, D {}): of the bound (rtol {} + atol {} "
            "x row rms) {:.3f}; max abs err {:.3e}; h bit-equal".format(
                name, rows, LLAMA_D, rtol, atol, row["tol_ratio"],
                row["max_abs_err"]))
        if not torch.isfinite(normed).all() or not row["tol_ratio"] <= 1.0:
            raise AssertionError("fused norm {}: error {:.3e} of the bound "
                                 "at {}".format(name, row["tol_ratio"],
                                                row["worst_at"]))
        if dtype == "bf16":
            max_err[kernel] = max(max_err[kernel], row["max_abs_err"])
        if rows == LLAMA_ROWS and dtype == "bf16":
            xs, rs = x, r

            def library(xs=xs, rs=rs, scale=scale):
                h = xs if rs is None else xs + rs
                return F.rms_norm(h, (LLAMA_D,), scale, 1e-5), h

            cost = tfn.fused_norm_cost((rows, LLAMA_D), tdt,
                                       with_residual=residual)
            row = rows_out[kernel] = {
                "ms": timed_ms(lambda: tfn._launch(xs, rs, scale, 1e-5,
                                                   tdt)),
                "plain_ms": timed_ms(lambda: tfn.rmsnorm_residual_reference(
                    xs, scale, rs, 1e-5)),
                "library_ms": timed_ms(library),
                "bytes": cost["bytes_moved"]}
            row["bound_ms"], row["bound_by"] = bound_of(cost)
            log("kernel {} (rows {}, D {}, bf16): {:.4f} ms (bound {:.4f} ms "
                "by {}; {:.0f} GB/s), plain {:.4f} ms, library (F.rms_norm"
                "{}) {:.4f} ms".format(
                    kernel, rows, LLAMA_D, row["ms"], row["bound_ms"],
                    row["bound_by"], cost["bytes_moved"] / row["ms"] / 1e6,
                    row["plain_ms"], " of x + r" if residual else "",
                    row["library_ms"]))
        del x, r, normed, h, plain, plain_h
    for kernel in max_err:
        rows_out[kernel]["max_abs_err"] = max_err[kernel]
    details["timing"] = rows_out
    torch.cuda.empty_cache()
    return rows_out, details


def check_mlp_kernels(device):
    """MLP_CASES through the public `fused_swiglu` (both launches
    counted) and each kernel alone, element by element; then the main
    shape (rows 8192, D 2048, F 5632, bf16, silu) timed beside the
    bounds and the plain version (three F.linear, the library yardstick
    as well: the same calls). Returns (rows by kernel, details)."""
    import torch
    import torch.nn.functional as F
    from cloud_tpu_torch.ops import fused_mlp as tfm

    rng = np.random.default_rng(21)
    details = {}
    max_err = {"fused_mlp_gate_up": 0.0, "fused_mlp_down": 0.0}
    rows_out = {}
    for name, rows, d, f, dtype, activation in MLP_CASES:
        tdt = _dtype(dtype)

        def t(*shape, scale=1.0):
            return torch.tensor(rng.standard_normal(shape, dtype=np.float32)
                                * scale, dtype=tdt, device=device)

        x = t(rows, d)
        wg, wu = t(f, d, scale=d ** -0.5), t(f, d, scale=d ** -0.5)
        wd = t(d, f, scale=f ** -0.5)
        before = dict(tfm.launches)
        y = tfm.fused_swiglu(x, wg, wu, wd, activation=activation)
        a = tfm.launch_gate_up(x, wg, wu, activation)
        y_down = tfm.launch_down(a, wd)
        torch.cuda.synchronize()
        if (tfm.launches["fused_mlp_gate_up"] != before["fused_mlp_gate_up"]
                + 2 or tfm.launches["fused_mlp_down"]
                != before["fused_mlp_down"] + 2):
            raise AssertionError("fused_swiglu did not launch both kernels")
        want_a, want_y = tfm.swiglu_rounded_reference(x, wg, wu, wd,
                                                      activation)
        want_down = a.float() @ wd.float().T
        tol = MLP_TOL[dtype]
        row = {"y": compare(y, want_y, *tol["y"]),
               "a": compare(a, want_a, *tol["a"]),
               "down": compare(y_down, want_down, *tol["down"])}
        details[name] = row
        log("fused mlp {} (rows {}, D {}, F {}): of the bound y {:.3f} "
            "(rtol {} + atol {} x row rms), a {:.3f} ({} + {}), down alone "
            "{:.3f} ({} + {}); worst err over its row's rms y {:.2e} a "
            "{:.2e}".format(
                name, rows, d, f, row["y"]["tol_ratio"], *tol["y"],
                row["a"]["tol_ratio"], *tol["a"], row["down"]["tol_ratio"],
                *tol["down"], row["y"]["row_normalized"],
                row["a"]["row_normalized"]))
        for key in ("y", "a", "down"):
            if not row[key]["tol_ratio"] <= 1.0:
                raise AssertionError("fused mlp {} {}: error {:.3e} of the "
                                     "bound at {}".format(
                                         name, key, row[key]["tol_ratio"],
                                         row[key]["worst_at"]))
        if not torch.isfinite(y).all():
            raise AssertionError("fused mlp {}: non-finite output".format(
                name))
        if dtype == "bf16":
            max_err["fused_mlp_gate_up"] = max(max_err["fused_mlp_gate_up"],
                                               row["a"]["max_abs_err"])
            max_err["fused_mlp_down"] = max(max_err["fused_mlp_down"],
                                            row["down"]["max_abs_err"])
        del want_a, want_y, want_down
        if name == "silu_bf16":
            act = tfm._ACTIVATIONS[activation]
            cost = tfm.fused_mlp_cost((rows, d), f, tdt)
            timing = {
                "gate_up_ms": timed_ms(lambda: tfm.launch_gate_up(
                    x, wg, wu, activation)),
                "down_ms": timed_ms(lambda: tfm.launch_down(a, wd)),
                "pair_ms": timed_ms(lambda: tfm.launch_down(
                    tfm.launch_gate_up(x, wg, wu, activation), wd)),
                "plain_gate_up_ms": timed_ms(
                    lambda: act(F.linear(x, wg)) * F.linear(x, wu)),
                "plain_down_ms": timed_ms(lambda: F.linear(a, wd)),
                "plain_pair_ms": timed_ms(lambda: tfm.swiglu_reference(
                    x, wg, wu, wd, activation)),
            }
            for part, key in (("gate_up", "gate_up_ms"),
                              ("down", "down_ms"), ("total", "pair_ms")):
                timing[part + "_bound_ms"], timing[part + "_bound_by"] = \
                    bound_of(cost[part])
                timing[part + "_tflops"] = (cost[part]["flops"]
                                            / timing[key] / 1e9)
            timing["intermediate_bytes"] = cost["intermediate_bytes"]
            details["timing"] = timing
            log("kernels fused_mlp (rows {}, D {}, F {}, bf16, silu): "
                "gate|up {:.4f} ms (bound {:.4f} ms; {:.0f} TFLOP/s), down "
                "{:.4f} ms (bound {:.4f} ms; {:.0f} TFLOP/s), pair {:.4f} ms "
                "(bound {:.4f} ms); plain = library (the same F.linear "
                "calls): gate|up part {:.4f} ms, down {:.4f} ms, whole "
                "{:.4f} ms".format(
                    rows, d, f, timing["gate_up_ms"],
                    timing["gate_up_bound_ms"], timing["gate_up_tflops"],
                    timing["down_ms"], timing["down_bound_ms"],
                    timing["down_tflops"], timing["pair_ms"],
                    timing["total_bound_ms"], timing["plain_gate_up_ms"],
                    timing["plain_down_ms"], timing["plain_pair_ms"]))
            for kernel, part in (("fused_mlp_gate_up", "gate_up"),
                                 ("fused_mlp_down", "down")):
                rows_out[kernel] = {
                    "ms": timing[part + "_ms"],
                    "bound_ms": timing[part + "_bound_ms"],
                    "bound_by": timing[part + "_bound_by"],
                    "plain_ms": timing["plain_" + part + "_ms"],
                    "library_ms": timing["plain_" + part + "_ms"]}
        del x, wg, wu, wd, y, a, y_down
        torch.cuda.empty_cache()
    for kernel in rows_out:
        rows_out[kernel]["max_abs_err"] = max_err[kernel]
    return rows_out, details


# -- phase 7: TinyLlama-1.1B training -------------------------------------

LLAMA_BATCH, LLAMA_SEQ, LLAMA_EPOCHS, LLAMA_STEPS = 4, 2048, 12, 20
# AdamW's peak learning rate (warmup over the first tenth of the steps,
# then cosine decay to 0): at every peak tried from 5e-5 to 2.4e-3, 120
# steps end on the plateau of a model that predicts the tokens of the
# sequence's two permutation cycles without their order (about ln 33
# nats); at 5e-5 the model leaves it after about 120 steps and learns
# the chains, which 240 steps complete (PERF.md, Findings).
LLAMA_LR = 5e-5
# The data seed of phase 7's fit (`--llama-gate` runs others).
LLAMA_SEED = 6


def plain_kernels_swapped():
    """A context in which the Llama model's attention, fused norm and
    fused MLP run their plain versions (autograd through them)."""
    import contextlib

    from cloud_tpu_torch.ops import attention as tatt
    from cloud_tpu_torch.ops import fused_mlp as tfm
    from cloud_tpu_torch.ops import fused_norm as tfn

    def attention(q, k, v, causal=True, mask=None, impl="auto", **kw):
        return tatt.mha_reference(q, k, v, causal=causal, mask=mask, **kw)

    def norm(x, scale, residual=None, eps=1e-6, out_dtype=None,
             impl="auto"):
        return tfn.rmsnorm_residual_reference(x, scale, residual, eps,
                                              out_dtype)

    def mlp(x, wg, wu, wd, activation="silu", compute_dtype=None,
            impl="auto"):
        return tfm.swiglu_reference(x, wg, wu, wd, activation,
                                    compute_dtype)

    @contextlib.contextmanager
    def swapped():
        saved = (tatt.attention, tfn.fused_rmsnorm, tfm.fused_swiglu)
        tatt.attention, tfn.fused_rmsnorm, tfm.fused_swiglu = \
            attention, norm, mlp
        try:
            yield
        finally:
            tatt.attention, tfn.fused_rmsnorm, tfm.fused_swiglu = saved

    return swapped()


def reset_all_launches():
    from cloud_tpu_torch.ops import attention as tatt
    from cloud_tpu_torch.ops import fused_mlp as tfm
    from cloud_tpu_torch.ops import fused_norm as tfn
    from cloud_tpu_torch.ops import paged_attention as _  # noqa: F401

    for mod in (tatt, tfm, tfn,
                sys.modules["cloud_tpu_torch.ops.paged_attention"]):
        mod.reset_launches()


def all_launches():
    from cloud_tpu_torch.ops import attention as tatt
    from cloud_tpu_torch.ops import fused_mlp as tfm
    from cloud_tpu_torch.ops import fused_norm as tfn

    out = {}
    for mod in (tatt, tfm, tfn,
                sys.modules["cloud_tpu_torch.ops.paged_attention"]):
        out.update(mod.launches)
    return out


def expected_llama_launches(layers, steps, mlp=True):
    """Launches of `steps` training steps of a LlamaLM: each flash kernel
    and the norm with the residual once per layer, the norm without it
    once per layer and for the final norm, each MLP kernel once per layer
    (none where MoE blocks take the MLP's place, `mlp=False`)."""
    mlps = layers * steps if mlp else 0
    return {"flash_attention_fwd": layers * steps,
            "flash_attention_dq": layers * steps,
            "flash_attention_dkdv": layers * steps,
            "fused_mlp_gate_up": mlps,
            "fused_mlp_down": mlps,
            "fused_norm": layers * steps,
            "fused_norm_noresidual": (layers + 1) * steps,
            "paged_attention": 0, "paged_attention_int8": 0}


def llama_one_step_check(model, x, y):
    """Loss and every parameter's gradient norm of one step from the
    model's current weights, on the kernels and with attention, norm and
    MLP all swapped for their plain versions. Parameters whose gradient
    is exactly zero on the plain run are excluded and named. With MoE
    blocks, the experts each token was routed to in the two runs are
    compared first, and the share of routes that differ is reported."""
    import torch
    import torch.nn.functional as F

    routes = []
    hooks = [block.moe.register_forward_pre_hook(
        lambda mod, args: routes.append(mod.route(args[0])[1].detach()))
        for block in model.blocks if hasattr(block, "moe")]

    def step():
        model.zero_grad(set_to_none=True)
        logits = model(x)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y.reshape(-1))
        loss.backward()
        norms = {n: p.grad.float().norm().item()
                 for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), norms

    reset_all_launches()
    loss_k, norms_k = step()
    routes_k, routes[:] = list(routes), []
    launched = all_launches()
    want = expected_llama_launches(model.num_layers, 1,
                                   mlp=not model.moe_experts)
    if launched != want:
        raise AssertionError("one-step check launched {}; expected {}"
                             .format(launched, want))
    # The plain attention keeps f32 logits [B, H, S, S] and the softmax
    # weights for its backward in every layer.
    seq = x.shape[1]
    reckoned = (2 * x.shape[0] * model.num_heads * seq * seq * 4
                * model.num_layers)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with plain_kernels_swapped():
        loss_p, norms_p = step()
    peak = torch.cuda.max_memory_allocated() - base
    for hook in hooks:
        hook.remove()
    if any(all_launches()[k] != want[k] for k in want):
        raise AssertionError("the plain run launched a kernel")
    flipped = None
    if routes_k:
        flipped = float(sum(int((a != b).sum()) for a, b in
                            zip(routes_k, routes))
                        / sum(a.numel() for a in routes_k))
        log("one-step check: {:.4%} of the routes (token, slot) differ "
            "between the kernel run and the plain run".format(flipped))
    excluded = sorted(n for n, v in norms_p.items() if v == 0.0)
    worst, worst_name = 0.0, None
    for name, value in norms_p.items():
        if name in excluded:
            continue
        rel = abs(norms_k[name] - value) / value
        if rel > worst:
            worst, worst_name = rel, name
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log("llama one-step check (batch {} x {}): loss kernels {:.6f} plain "
        "{:.6f} (rel {:.2e}, tol {}); worst grad-norm rel diff {:.2e} at {} "
        "(tol {}); excluded (zero gradient) {}; the plain attention's saved "
        "f32 logits and weights reckoned {:.1f} GB, peak above the model "
        "{:.1f} GB".format(x.shape[0], seq, loss_k, loss_p, loss_rel,
                           STEP_LOSS_TOL, worst, worst_name, STEP_GRAD_TOL,
                           excluded, reckoned / 1e9, peak / 1e9))
    if not (np.isfinite(loss_k) and loss_rel <= STEP_LOSS_TOL
            and worst <= STEP_GRAD_TOL):
        raise AssertionError("one Llama training step disagrees with the "
                             "plain versions")
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "loss_rel_diff": loss_rel, "worst_grad_norm_rel_diff": worst,
            "worst_grad_norm_param": worst_name, "excluded": excluded,
            "plain_attention_bytes_reckoned": reckoned,
            "plain_run_peak_bytes": peak, "routes_flipped_share": flipped}


def llama_data(seed, vocab, batch=LLAMA_BATCH, steps=LLAMA_STEPS,
               n_val=2 * LLAMA_BATCH):
    """Phase 7's data from `seed` (phase 9's with its batch and steps):
    `steps` batches to train on (x, y) and `n_val` sequences to validate
    (x_val, y_val; generate's prompts are cut from them), with the
    entropy of the next token given the current one, the cycle level and
    the loss gate read from the training part."""
    n_train = batch * steps
    x, y = training_data(seed, n_train + n_val, vocab, LLAMA_SEQ)
    out = {"x": x[:n_train], "y": y[:n_train], "x_val": x[n_train:],
           "y_val": y[n_train:]}
    out["entropy"] = next_token_entropy(out["x"], out["y"])
    out["cycle"] = cycle_level(out["x"], out["y"])
    out["gate"] = llama_loss_gate(out["entropy"], out["cycle"])
    return out


def llama_fit(model, x, y, batch=LLAMA_BATCH, epochs=LLAMA_EPOCHS,
              peak_lr=LLAMA_LR):
    """Phase 7's fit of (x, y) (phase 9's with its batch, epochs and
    rate): AdamW, warmup-cosine to `peak_lr` over `epochs` epochs, the
    Trainer's default aux_loss_weight (0.01) on MoE aux losses, with the
    launches counted from 0 around it and held to layers x steps.
    Returns (trainer, history, launches, fit seconds)."""
    import torch
    from cloud_tpu_torch.training import Trainer, make_optimizer
    from cloud_tpu_torch.training.schedules import warmup_cosine

    total = epochs * (len(x) // batch)
    trainer = Trainer(model, optimizer=make_optimizer(
        "adamw", warmup_cosine(peak_lr, total, total // 10)),
        metrics=("accuracy",), seed=0)
    reset_all_launches()
    t0 = time.monotonic()
    history = trainer.fit(x, y, batch_size=batch, epochs=epochs,
                          verbose=False)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches = all_launches()
    steps = trainer.state.step
    want = expected_llama_launches(model.num_layers, steps,
                                   mlp=not model.moe_experts)
    if steps != total or launches != want:
        raise AssertionError("llama fit launched {} over {} steps; expected "
                             "{}".format(launches, steps, want))
    return trainer, history, launches, fit_s


def llama_gate_passes(losses, gate):
    """Every epoch's loss finite, the first above the gate and the last
    below it."""
    return bool(all(np.isfinite(losses)) and losses[-1] < gate < losses[0])


def train_llama(device):
    """Phase 7: TinyLlama-1.1B through `Trainer.fit`; returns (launches
    in fit, summary dict, the trained model without its optimizer state
    or gradients, its data)."""
    import torch
    from cloud_tpu_torch.models import TINYLLAMA_1_1B, LlamaLM
    from cloud_tpu_torch.ops import attention as tatt

    torch.cuda.empty_cache()
    t0 = time.monotonic()
    model = LlamaLM(compute_dtype=torch.bfloat16, device=device, seed=0,
                    **TINYLLAMA_1_1B)
    n_total = sum(p.numel() for p in model.parameters())
    log("llama: TinyLlama-1.1B ({:,} parameters) built in {:.1f} s".format(
        n_total, time.monotonic() - t0))
    data = llama_data(LLAMA_SEED, model.vocab_size)
    x, y, x_val, y_val = data["x"], data["y"], data["x_val"], data["y_val"]
    entropy, cycle, gate = data["entropy"], data["cycle"], data["gate"]
    check = llama_one_step_check(model,
                                 torch.as_tensor(x[:1], device=device),
                                 torch.as_tensor(y[:1], device=device))
    torch.cuda.empty_cache()

    trainer, history, launches, fit_s = llama_fit(model, x, y)
    steps = trainer.state.step
    n_train = len(x)
    losses = history["loss"]
    log("llama fit: {} steps in {:.2f} s, history {}; entropy of the next "
        "token given the current one {:.4f} nats, cycle level {:.4f}, gate "
        "{:.4f} (halfway); peak memory {:.1f} GB".format(
            steps, fit_s, json.dumps(history), entropy, cycle, gate,
            torch.cuda.max_memory_allocated() / 1e9))
    if not llama_gate_passes(losses, gate):
        raise AssertionError(
            "llama: the last epoch's loss {} is not below the gate {:.4f} "
            "(halfway between the entropy of the next token given the "
            "current one, {:.4f}, and the cycle level, {:.4f})".format(
                losses[-1], gate, entropy, cycle))

    batches = [(x[i:i + LLAMA_BATCH], y[i:i + LLAMA_BATCH])
               for i in range(0, n_train, LLAMA_BATCH)]
    step_s, times = time_steps(trainer, batches)
    prof = profile_steps(train_step(trainer, batches),
                         ("flash_", "rmsnorm_kernel", "gemm_bf16"))
    cost = tatt.flash_attention_cost(LLAMA_BATCH, LLAMA_SEQ, model.num_heads,
                                     model.num_kv_heads, model.head_dim,
                                     causal=True)
    tokens = LLAMA_BATCH * LLAMA_SEQ
    n_params = matmul_params(model)
    step_flops = (6.0 * n_params * tokens
                  + 3 * cost["forward"]["flops"] * model.num_layers)
    mfu = step_flops / step_s / PEAK_FLOPS["bf16"]
    val, pred_loss, val2 = evaluate_and_predict(trainer, x_val, y_val,
                                                LLAMA_BATCH, LLAMA_SEQ,
                                                model.vocab_size)
    summary = {
        "model": "TinyLlama-1.1B bf16", "parameters": n_total,
        "batch": LLAMA_BATCH, "seq": LLAMA_SEQ, "steps": steps,
        "history": history, "peak_lr": LLAMA_LR,
        "next_token_entropy_given_current": entropy, "cycle_level": cycle,
        "loss_gate": gate, "fit_s": fit_s,
        "launches": launches, "one_step_check": check,
        "step_p50_s": step_s, "step_times_s": times,
        "tokens_per_s": tokens / step_s, "matmul_params": n_params,
        "step_flops": step_flops, "mfu": mfu,
        "device_busy_share": prof["device_busy_share"],
        "port_kernels_share_of_device": prof["matched_share_of_device"],
        "device_ms_per_step": prof["device_ms_per_step"],
        "kernels_per_step": prof["kernels_per_step"],
        "top_kernels": prof["top_kernels"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "evaluate": val, "predict_loss_2_seqs": pred_loss,
        "evaluate_loss_2_seqs": val2["loss"],
    }
    log("llama train: step p50 {:.2f} ms, {:.0f} tokens/s, MFU {:.4f}, "
        "device busy {}, device {:.1f} ms/step, the port's kernels {} of "
        "device time; evaluate {}".format(
            step_s * 1e3, tokens / step_s, mfu, prof["device_busy_share"],
            prof["device_ms_per_step"], prof["matched_share_of_device"],
            json.dumps(val)))
    log_top_kernels("llama", prof["top_kernels"])
    del trainer
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return launches, summary, model, data


# -- phase 8: TinyLlama-1.1B generate ----------------------------------------

GEN_BATCH, GEN_NEW = 8, 64
# Prompt lengths (tokens of phase 7's held-out chain sequences), left-padded
# to the longest: generate() buckets them to 512.
GEN_PROMPT_LENS = (96, 150, 205, 260, 315, 370, 425, 480)
# Share of the greedy continuation's tokens that must follow the chain rule
# of `training_data` (each token the image of the one two places before
# under the data's permutation): phase 7 ends its fit at a loss of a few
# hundredths of a nat, so its greedy tokens follow the rule nearly always.
GEN_CHAIN_RATE = 0.9
GEN_STEPS_TIMED = 20


def hf_state_of(model, cfg=None, model_type="llama"):
    """The port's `LlamaLM` state dict under HF names (the port's weights
    are HF's [out, in] already and both models' RoPE is rotate-half, so
    this is renames; a Qwen3-MoE router and experts are HF's [E, d]
    gate and per-expert [out, in] projections, transposed views), and
    the HF config dict of `cfg` (TINYLLAMA_1_1B by default; model_type
    "qwen3_moe" adds the MoE keys): what `import_hf_llama` reads from a
    checkpoint."""
    from cloud_tpu_torch.models import TINYLLAMA_1_1B

    cfg = cfg or TINYLLAMA_1_1B
    renames = {"norm_attn": "input_layernorm",
               "norm_mlp": "post_attention_layernorm",
               "attention.query": "self_attn.q_proj",
               "attention.key": "self_attn.k_proj",
               "attention.value": "self_attn.v_proj",
               "attention.out": "self_attn.o_proj",
               "attention.q_norm": "self_attn.q_norm",
               "attention.k_norm": "self_attn.k_norm",
               "mlp.gate": "mlp.gate_proj", "mlp.up": "mlp.up_proj",
               "mlp.down": "mlp.down_proj"}
    experts = {"expert_gate": "gate_proj", "expert_up": "up_proj",
               "expert_down": "down_proj"}
    state = {}
    for name, tensor in model.state_dict().items():
        if name == "embed.weight":
            state["model.embed_tokens.weight"] = tensor
        elif name == "norm_final.weight":
            state["model.norm.weight"] = tensor
        elif name == "lm_head.weight":
            state[name] = tensor
        else:
            _, layer, rest = name.split(".", 2)
            hf = "model.layers.{}.".format(layer)
            if rest == "moe.router":
                state[hf + "mlp.gate.weight"] = tensor.T
            elif rest.startswith("moe."):
                for e in range(tensor.shape[0]):
                    state[hf + "mlp.experts.{}.{}.weight".format(
                        e, experts[rest[4:]])] = tensor[e].T
            else:
                state[hf + renames[rest[:-len(".weight")]] + ".weight"] = \
                    tensor
    config = {"model_type": model_type, "vocab_size": cfg["vocab_size"],
              "hidden_size": cfg["d_model"],
              "intermediate_size": cfg["d_ff"],
              "num_hidden_layers": cfg["num_layers"],
              "num_attention_heads": cfg["num_heads"],
              "num_key_value_heads": cfg["num_kv_heads"],
              "max_position_embeddings": cfg["max_seq_len"],
              "rope_theta": cfg["rope_theta"],
              "rms_norm_eps": cfg["norm_eps"], "hidden_act": "silu",
              "tie_word_embeddings": False}
    if model_type == "qwen3_moe":
        config.update(head_dim=cfg["head_dim"], num_experts=cfg["moe_experts"],
                      num_experts_per_tok=cfg["moe_top_k"],
                      moe_intermediate_size=cfg["d_ff"],
                      norm_topk_prob=cfg["moe_norm_topk"],
                      decoder_sparse_step=1, mlp_only_layers=[])
    return state, config


def route_recorder(model):
    """Forward pre-hooks on each MoE block of `model` that record the
    experts every token of each call takes ([T, k], per layer, per
    call). Returns (the lists, by layer; the hooks)."""
    import torch

    routes = [[] for _ in model.blocks]

    def hook(i):
        def record(mod, args):
            with torch.no_grad():
                routes[i].append(mod.route(args[0])[1])
        return record

    return routes, [block.moe.register_forward_pre_hook(hook(i))
                    for i, block in enumerate(model.blocks)]


def chain_map(x, y):
    """{token: the token two places after it} read from the data (the
    permutation `training_data` draws its chains with)."""
    tokens = np.concatenate([x[:, :1], y], axis=1)
    return dict(zip(tokens[:, :-2].ravel().tolist(),
                    tokens[:, 2:].ravel().tolist()))


def expected_generate_launches(layers, new_tokens, mlp=True):
    """Launches of one generate() call: the model runs once per token
    (the prefill, then a step per further token); each run launches the
    norm with the residual once per layer and without it once per layer
    and once for the final norm, each MLP kernel once per layer (none
    with MoE blocks, `mlp=False`), and no attention kernel (decode
    attention is plain PyTorch)."""
    mlps = layers * new_tokens if mlp else 0
    return {"flash_attention_fwd": 0, "flash_attention_dq": 0,
            "flash_attention_dkdv": 0,
            "fused_mlp_gate_up": mlps,
            "fused_mlp_down": mlps,
            "fused_norm": layers * new_tokens,
            "fused_norm_noresidual": (layers + 1) * new_tokens,
            "paged_attention": 0, "paged_attention_int8": 0}


def decode_kernel_rows(model, device, rows=GEN_BATCH):
    """The norm and MLP kernels at a decode step's shape (rows = the
    batch, TinyLlama's widths, bf16), each against its plain version,
    timed by CUDA-graph replays beside its byte bound, the plain version
    and the library call (`norm_rows_at` for the norm; the F.linear
    calls of the plain MLP). The MLP kernels read every layer's weights
    in turn (22 calls per replay, 1.5 GB), as a decode step does, so
    they come from device memory, not from L2. Returns rows by kernel
    name."""
    import torch
    import torch.nn.functional as F
    from cloud_tpu_torch.ops import fused_mlp as tfm

    rng = np.random.default_rng(30)
    dt = torch.bfloat16
    d, f = model.d_model, model.d_ff

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            dtype=dt, device=device)

    out = norm_rows_at(device, rows, model.norm_eps)
    weights = [(b.mlp.gate.weight.detach().to(dt),
                b.mlp.up.weight.detach().to(dt),
                b.mlp.down.weight.detach().to(dt)) for b in model.blocks]
    xm = t(rows, d)
    a = tfm.launch_gate_up(xm, *weights[0][:2], "silu")
    want_a, _ = tfm.swiglu_rounded_reference(xm, *weights[0], "silu")
    err_a = compare(a, want_a, *MLP_TOL["bf16"]["a"])
    y = tfm.launch_down(a, weights[0][2])
    err_d = compare(y, a.float() @ weights[0][2].float().T,
                    *MLP_TOL["bf16"]["down"])
    if not (err_a["tol_ratio"] <= 1.0 and err_d["tol_ratio"] <= 1.0):
        raise AssertionError("fused mlp at rows {}: errors {:.3e} {:.3e} of "
                             "the bound".format(rows, err_a["tol_ratio"],
                                                err_d["tol_ratio"]))
    act = tfm._ACTIVATIONS["silu"]

    def cycling(fn):
        layer = [0]

        def call():
            w = weights[layer[0] % len(weights)]
            layer[0] += 1
            return fn(*w)
        return call

    n = len(weights)
    timing = {
        "fused_mlp_gate_up": (
            timed_ms(cycling(lambda wg, wu, wd: tfm.launch_gate_up(
                xm, wg, wu, "silu")), iters=n),
            timed_ms(cycling(lambda wg, wu, wd: act(F.linear(xm, wg))
                             * F.linear(xm, wu)), iters=n), err_a),
        "fused_mlp_down": (
            timed_ms(cycling(lambda wg, wu, wd: tfm.launch_down(a, wd)),
                     iters=n),
            timed_ms(cycling(lambda wg, wu, wd: F.linear(a, wd)), iters=n),
            err_d)}
    cost = tfm.fused_mlp_cost((rows, d), f, dt)
    for kernel, part in (("fused_mlp_gate_up", "gate_up"),
                         ("fused_mlp_down", "down")):
        ms, plain_ms, err = timing[kernel]
        row = out[kernel] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": plain_ms,
                             "max_abs_err": err["max_abs_err"],
                             "rows": rows}
        row["bound_ms"], row["bound_by"] = bound_of(cost[part])
    for kernel in ("fused_mlp_gate_up", "fused_mlp_down"):
        row = out[kernel]
        log("kernel {} at decode rows {} (D {}, d_ff {}, bf16): {:.4f} ms "
            "(bound {:.4f} ms by {}), plain {:.4f} ms, library {:.4f} ms; "
            "max abs err {:.3e}".format(
                kernel, rows, d, f, row["ms"], row["bound_ms"],
                row["bound_by"], row["plain_ms"], row["library_ms"],
                row["max_abs_err"]))
    del weights
    torch.cuda.empty_cache()
    return out


def generate_llama(model, data, device, cfg=None, model_type="llama",
                   label="llama", chain_taught=True):
    """Phase 8: TinyLlama-1.1B (phase 7's trained model; phase 9: another
    `cfg` and HF `model_type`) through `generate()`, and the same weights
    imported by `import_hf_llama` from an HF-named state dict. Checks (a)
    the imported model's greedy tokens equal the trained model's; (b)
    each greedy token lies within LOGIT_MARGIN of the row max of an f32
    teacher-forced training forward over prompt + continuation and is
    its argmax at MIN_EXACT of positions (with MoE blocks the margin holds
    where the predicting token took the same experts in every layer in
    the decode and in the f32 forward: where a router's top k is a near
    tie, bf16 and f32 may pick different experts, and the forward then
    computes another function; those positions are counted and their
    largest gap reported); (c) the continuation follows
    the chain rule at GEN_CHAIN_RATE (where the fit taught the chains,
    `chain_taught`; else the rate is reported); (d) one generate()
    call's launches (`expected_generate_launches`); (e) two sampled
    calls with one seed agree. Times the prefill, the decode step and
    one generate() call, and 20 steps under the profiler. Returns
    (launches of the trained model's greedy call, kernel rows at decode
    rows (None with MoE blocks, which run no MLP kernel), summary)."""
    import torch
    from cloud_tpu_torch.models import (TINYLLAMA_1_1B, LlamaLM, decoding,
                                        generate, import_hf_llama)

    cfg = cfg or TINYLLAMA_1_1B
    t_phase = time.monotonic()
    state, config = hf_state_of(model, cfg, model_type)
    t0 = time.monotonic()
    imported = import_hf_llama(state_dict=state, config=config,
                               compute_dtype=torch.bfloat16, device=device)
    import_s = time.monotonic() - t0
    del state
    same = all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), imported.state_dict().values()))
    if not same or list(model.state_dict()) != list(imported.state_dict()):
        raise AssertionError("import_hf_llama did not reproduce the weights")

    x_val = data["x_val"]
    width = max(GEN_PROMPT_LENS)
    prompt = np.zeros((GEN_BATCH, width), np.int64)
    mask = np.zeros((GEN_BATCH, width), bool)
    for row, n in enumerate(GEN_PROMPT_LENS):
        prompt[row, width - n:] = x_val[row, :n]
        mask[row, width - n:] = True

    moe = bool(model.moe_experts)
    decode_routes, hooks = route_recorder(model) if moe else (None, [])
    reset_all_launches()
    t0 = time.monotonic()
    greedy = generate(model, prompt, GEN_NEW, temperature=0.0,
                      prompt_mask=mask).numpy()
    generate_s = time.monotonic() - t0
    launches = all_launches()
    for hook in hooks:
        hook.remove()
    want = expected_generate_launches(model.num_layers, GEN_NEW,
                                      mlp=not model.moe_experts)
    if launches != want:
        raise AssertionError("generate launched {}; expected {}".format(
            launches, want))
    imported_tokens = generate(imported, prompt, GEN_NEW, temperature=0.0,
                               prompt_mask=mask).numpy()
    if not np.array_equal(imported_tokens, greedy):
        raise AssertionError("the imported model's greedy tokens differ "
                             "from the trained model's")
    sampled = [generate(model, prompt, GEN_NEW, seed=7, temperature=1.0,
                        top_p=0.9, prompt_mask=mask).numpy()
               for _ in range(2)]
    if not np.array_equal(*sampled):
        raise AssertionError("two sampled generate() calls with one seed "
                             "differ")
    del imported
    decoding.clear_cache_pool()
    torch.cuda.empty_cache()

    # (b) teacher-forced f32 forward over each row's real tokens.
    ref = LlamaLM(compute_dtype=torch.float32, device=device, seed=None,
                  **cfg)
    ref.load_state_dict(model.state_dict())
    ref_routes, hooks = route_recorder(ref) if moe else (None, [])
    gaps, exact, agree = [], [], []
    follows = []
    step2 = chain_map(data["x"], data["y"])
    prefill_len = decoding.bucket_length(width, model.max_seq_len - GEN_NEW)
    for row, n in enumerate(GEN_PROMPT_LENS):
        seq = np.concatenate([x_val[row, :n], greedy[row, width:]])
        with torch.no_grad():
            logits = ref(torch.as_tensor(seq[None], device=device))[0]
        pred = logits[n - 1:n - 1 + GEN_NEW]
        toks = torch.as_tensor(seq[n:], device=device)
        chosen = pred.gather(1, toks[:, None])[:, 0]
        gaps.append((pred.max(-1).values - chosen).cpu().numpy())
        exact.append((pred.argmax(-1) == toks).cpu().numpy())
        follows += [step2.get(int(seq[p - 2])) == int(seq[p])
                    for p in range(n, n + GEN_NEW)]
        if moe:
            # New token j was predicted by call j of generate() (0: the
            # prefill, whose row `row` ends at flat index (row + 1) *
            # prefill_len - 1; then one step of GEN_BATCH tokens per
            # call), by position n - 1 + j of the forward.
            agree.append(np.array([all(
                torch.equal(
                    calls[j][(row + 1) * prefill_len - 1 if j == 0
                             else row].sort().values,
                    forward[-1][n - 1 + j].sort().values)
                for calls, forward in zip(decode_routes, ref_routes))
                for j in range(GEN_NEW)]))
            for forward in ref_routes:
                forward.clear()
    for hook in hooks:
        hook.remove()
    del ref
    torch.cuda.empty_cache()
    gaps, exact = np.concatenate(gaps), np.concatenate(exact)
    agree = np.concatenate(agree) if moe else np.ones(gaps.shape, bool)
    chain_rate = float(np.mean(follows))
    log("{} generate: {} prompts of {}-{} tokens left-padded to {} "
        "(bucket 512), {} new tokens; imported model's tokens equal: yes; "
        "greedy tokens vs the f32 forward: max gap {:.4f} (limit {}) at the "
        "{} positions whose predicting token took the same experts in both "
        "(of {}; the max gap at the others {:.4f}), exact argmax {:.4f} (at "
        "least {}); chain rule followed {:.4f} ({}); sampled calls with one "
        "seed equal: yes".format(
            label, GEN_BATCH, min(GEN_PROMPT_LENS), width, width, GEN_NEW,
            gaps[agree].max(), LOGIT_MARGIN[""], int(agree.sum()),
            agree.size, gaps[~agree].max() if (~agree).any() else 0.0,
            exact.mean(), MIN_EXACT, chain_rate,
            "at least {}".format(GEN_CHAIN_RATE) if chain_taught
            else "not gated: the fit did not leave the cycle plateau"))
    if not (gaps[agree].max() <= LOGIT_MARGIN[""]
            and exact.mean() >= MIN_EXACT):
        raise AssertionError("greedy tokens disagree with the f32 forward")
    if chain_taught and not chain_rate >= GEN_CHAIN_RATE:
        raise AssertionError("the continuation follows the chain rule at "
                             "{:.4f} < {}".format(chain_rate,
                                                  GEN_CHAIN_RATE))

    # Timing: the prefill, then single-token steps over the dense cache,
    # each closed by a synchronize; then steps under the profiler.
    bucket = decoding.bucket_length(width, model.max_seq_len - GEN_NEW)
    tokens = np.pad(prompt, ((0, 0), (bucket - width, 0)))
    pmask = np.pad(mask, ((0, 0), (bucket - width, 0)))
    tokens = torch.as_tensor(tokens, device=device)
    pmask = torch.as_tensor(pmask, device=device)
    prefill_times = []
    for _ in range(2):
        cache = model.init_cache(GEN_BATCH)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits = model(tokens, pmask, cache)
        torch.cuda.synchronize()
        prefill_times.append(time.monotonic() - t0)
    cur = [logits[:, -1].argmax(-1)]

    def step(_):
        cur[0] = model(cur[0][:, None], None, cache)[:, 0].argmax(-1)

    step_times = []
    for i in range(GEN_STEPS_TIMED):
        t0 = time.monotonic()
        step(i)
        torch.cuda.synchronize()
        step_times.append(time.monotonic() - t0)
    prof = profile_steps(step, ("rmsnorm_kernel", "gemm_bf16"),
                         n=GEN_STEPS_TIMED)
    del cache, logits
    step_s = float(np.median(step_times))
    rows = None if model.moe_experts else decode_kernel_rows(model, device)
    summary = {
        "batch": GEN_BATCH, "new_tokens": GEN_NEW,
        "prompt_lens": list(GEN_PROMPT_LENS), "bucket": bucket,
        "import_s": import_s, "generate_s": generate_s,
        "generate_tokens_per_s": GEN_BATCH * GEN_NEW / generate_s,
        "launches": launches, "max_logit_gap": float(gaps.max()),
        "max_logit_gap_same_experts": float(gaps[agree].max()),
        "positions_same_experts": int(agree.sum()),
        "exact_argmax_share": float(exact.mean()),
        "chain_rule_rate": chain_rate, "chain_rule_gated": chain_taught,
        "prefill_ms": min(prefill_times) * 1e3,
        "prefill_times_s": prefill_times,
        "step_p50_ms": step_s * 1e3, "step_times_s": step_times,
        "step_tokens_per_s": GEN_BATCH / step_s,
        "device_busy_share": prof["device_busy_share"],
        "device_ms_per_step": prof["device_ms_per_step"],
        "kernels_per_step": prof["kernels_per_step"],
        "port_kernels_share_of_device": prof["matched_share_of_device"],
        "top_kernels": prof["top_kernels"], "kernel_rows": rows,
        "greedy_tokens": greedy[:, width:].tolist(),
        "phase_s": time.monotonic() - t_phase}
    log("{} generate: import {:.2f} s; generate() of {} x {} tokens "
        "{:.2f} s ({:.1f} tokens/s); prefill (8 x {}) {:.2f} ms; decode "
        "step p50 {:.2f} ms ({:.1f} tokens/s), device {:.2f} ms/step in "
        "{:.0f} kernels, busy {}, the port's kernels {} of device time; "
        "phase {:.1f} s".format(
            label, import_s, GEN_BATCH, GEN_NEW, generate_s,
            summary["generate_tokens_per_s"], bucket, summary["prefill_ms"],
            step_s * 1e3, GEN_BATCH / step_s, prof["device_ms_per_step"],
            prof["kernels_per_step"], prof["device_busy_share"],
            prof["matched_share_of_device"], summary["phase_s"]))
    log_top_kernels(label + " generate", prof["top_kernels"])
    return launches, rows, summary


# -- phase 9: Qwen3-30B-A3B (routed experts) training and generate ------------

# The public Qwen/Qwen3-30B-A3B at full width and with all 128 experts,
# its depth cut from 48 to 4 layers (AdamW's 16 bytes a parameter on
# 3.11 G parameters is 49.8 GB of the card's 80), sequences cut to 2048.
QWEN3_LAYERS = 4
QWEN3_BATCH, QWEN3_EPOCHS, QWEN3_STEPS = 2, 12, 20
# Capacity factor in training (the importer's checkpoints run drop-free)
# and the Trainer's weight on the aux losses (its default).
QWEN3_CAPACITY, QWEN3_AUX_WEIGHT = 2.0, 0.01
# AdamW's peak learning rate (warmup-cosine, as phase 7): on the card, 240
# steps at 1e-4 leave the cycle plateau and learn the chains, and at 3e-4
# they end short of that (PERF.md, Findings).
QWEN3_LR = 1e-4
QWEN3_SEED = 6
# A fit whose last epoch ends below this many nats has left the cycle
# plateau (`llama_loss_gate`) and learned the chains, so its greedy
# continuation is held to the chain rule.
CHAIN_TAUGHT_LOSS = 0.5


def qwen3_config(capacity_factor=QWEN3_CAPACITY):
    from cloud_tpu_torch.models import QWEN3_30B_A3B

    return dict(QWEN3_30B_A3B, num_layers=QWEN3_LAYERS, max_seq_len=LLAMA_SEQ,
                moe_capacity_factor=capacity_factor)


def seeded_on_card(model, seed):
    """`LlamaLM.reset_parameters`'s distributions (weights normal with
    std 0.02, norm scales 1, biases 0) drawn on the card from a seeded
    CUDA generator: the CPU draw of 3.1 G values would take half a
    minute."""
    import torch

    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)


def active_params(model):
    """Parameters a token's forward multiplies by: every Linear weight
    (attention, the head), and in each MoE block the router and the
    top_k of E experts' three matrices."""
    total = matmul_params(model)
    for block in model.blocks:
        moe = block.moe
        total += moe.router.numel() + moe.top_k * (
            moe.expert_gate[0].numel() + moe.expert_up[0].numel()
            + moe.expert_down[0].numel())
    return total


class MoeWatch:
    """Forward hooks on a MoE LlamaLM in training: the sum of the aux
    losses of each training forward (kept on the device), and at the
    forwards numbered in `load_at` (1 = the first) each layer's expert
    load: routes per expert before capacity and the share dropped."""

    def __init__(self, model, load_at):
        import torch
        from cloud_tpu_torch.models import moe as tmoe

        self.aux, self.load, self.calls = [], {}, 0
        self.load_at = set(load_at)

        def count(mod, args):
            if mod.training:
                self.calls += 1

        def aux(mod, args, out):
            if mod.training and mod.aux_losses:
                self.aux.append(sum(a.detach() for a in mod.aux_losses))

        def load(i):
            def hook(mod, args):
                if not (model.training and self.calls in self.load_at):
                    return
                with torch.no_grad():
                    _, top_idx, _ = mod.route(args[0])
                stats = tmoe.expert_load(top_idx, mod.num_experts,
                                         mod.capacity(top_idx.shape[0]))
                counts = stats["routes_per_expert"]
                self.load.setdefault(self.calls, []).append(
                    {"layer": i, "dropped_share": stats["dropped_share"],
                     "max_per_expert": max(counts),
                     "min_per_expert": min(counts)})
            return hook

        self.hooks = [model.register_forward_pre_hook(count),
                      model.register_forward_hook(aux)]
        self.hooks += [block.moe.register_forward_pre_hook(load(i))
                       for i, block in enumerate(model.blocks)]

    def remove(self):
        for hook in self.hooks:
            hook.remove()


def norm_rows_at(device, rows, eps=1e-6):
    """Both fused norm kernels at rows x LLAMA_D, bf16, each against its
    plain version (`compare`, NORM_TOL) and timed beside its bound, the
    plain version and F.rms_norm. Returns rows by kernel name."""
    import torch
    import torch.nn.functional as F
    from cloud_tpu_torch.ops import fused_norm as tfn

    rng = np.random.default_rng(22)
    dt = torch.bfloat16

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            dtype=dt, device=device)

    x, r = t(rows, LLAMA_D), t(rows, LLAMA_D)
    scale = torch.tensor(1.0 + 0.1 * rng.standard_normal(LLAMA_D),
                         dtype=torch.float32, device=device)
    out = {}
    for kernel, res in (("fused_norm", r), ("fused_norm_noresidual", None)):
        normed, _ = tfn._launch(x, res, scale, eps, dt)
        plain, _ = tfn.rmsnorm_residual_reference(x, scale, res, eps,
                                                  out_dtype=torch.float32)
        err = compare(normed, plain, *NORM_TOL["bf16"])
        if not err["tol_ratio"] <= 1.0:
            raise AssertionError("{} at rows {}: error {:.3e} of the bound"
                                 .format(kernel, rows, err["tol_ratio"]))

        def library(res=res):
            h = x if res is None else x + res
            return F.rms_norm(h, (LLAMA_D,), scale, eps), h

        cost = tfn.fused_norm_cost((rows, LLAMA_D), dt,
                                   with_residual=res is not None)
        row = out[kernel] = {
            "ms": timed_ms(lambda res=res: tfn._launch(x, res, scale, eps,
                                                       dt)),
            "plain_ms": timed_ms(lambda res=res:
                                 tfn.rmsnorm_residual_reference(
                                     x, scale, res, eps)),
            "library_ms": timed_ms(library),
            "max_abs_err": err["max_abs_err"], "rows": rows}
        row["bound_ms"], row["bound_by"] = bound_of(cost)
        log("kernel {} at rows {} (D {}, bf16): {:.4f} ms (bound {:.4f} ms "
            "by {}), plain {:.4f} ms, library {:.4f} ms; max abs err {:.3e}"
            .format(kernel, rows, LLAMA_D, row["ms"], row["bound_ms"],
                    row["bound_by"], row["plain_ms"], row["library_ms"],
                    row["max_abs_err"]))
    return out


def train_qwen3(device):
    """Phase 9: Qwen3-30B-A3B at full width, 4 layers, through
    `Trainer.fit` on phase 7's chain task (batch 2 x 2048, capacity factor
    2.0, aux_loss_weight 0.01): the one-step check against attention and
    norm by their plain versions (routes compared first), every step
    launching each flash kernel and the norm with the residual once per
    layer and the norm without it once per layer and once more, the loss
    gate; step time, tokens/s, MFU on the active parameters, busy share,
    top kernels, the aux loss per epoch and the expert load at the first
    and last step. Returns (launches in fit, summary, the trained model
    without optimizer state or gradients, its data)."""
    import torch
    from cloud_tpu_torch.models import LlamaLM
    from cloud_tpu_torch.ops import attention as tatt

    torch.cuda.empty_cache()
    t0 = time.monotonic()
    cfg = qwen3_config()
    model = LlamaLM(compute_dtype=torch.bfloat16, device=device, seed=None,
                    **cfg)
    seeded_on_card(model, 0)
    n_total = sum(p.numel() for p in model.parameters())
    n_active = active_params(model)
    log("qwen3moe: Qwen3-30B-A3B at {} layers ({:,} parameters, {:,} "
        "active per token) built in {:.1f} s".format(
            QWEN3_LAYERS, n_total, n_active, time.monotonic() - t0))
    data = llama_data(QWEN3_SEED, model.vocab_size, QWEN3_BATCH,
                      QWEN3_STEPS, n_val=GEN_BATCH)
    x, y = data["x"], data["y"]
    entropy, cycle, gate = data["entropy"], data["cycle"], data["gate"]
    check = llama_one_step_check(model,
                                 torch.as_tensor(x[:1], device=device),
                                 torch.as_tensor(y[:1], device=device))
    torch.cuda.empty_cache()

    total = QWEN3_EPOCHS * QWEN3_STEPS
    watch = MoeWatch(model, load_at=(1, total))
    trainer, history, launches, fit_s = llama_fit(
        model, x, y, batch=QWEN3_BATCH, epochs=QWEN3_EPOCHS,
        peak_lr=QWEN3_LR)
    watch.remove()
    steps = trainer.state.step
    aux = torch.stack(watch.aux).view(QWEN3_EPOCHS, -1).mean(1).tolist()
    # The history's loss is the training loss, the aux term included (as
    # in JAX); the gate reads the next-token loss alone.
    losses = [l - QWEN3_AUX_WEIGHT * a
              for l, a in zip(history["loss"], aux)]
    data["last_loss"] = losses[-1]
    log("qwen3moe fit: {} steps in {:.2f} s, history {}; aux loss per "
        "epoch (sum over layers) {}; next-token loss per epoch {}; entropy "
        "of the next token given the current one {:.4f} nats, cycle level "
        "{:.4f}, gate {:.4f}; peak memory {:.1f} GB".format(
            steps, fit_s, json.dumps(history), json.dumps(aux),
            json.dumps(losses), entropy, cycle, gate,
            torch.cuda.max_memory_allocated() / 1e9))
    for step, rows in sorted(watch.load.items()):
        log("qwen3moe expert load at step {}: {}".format(
            step, json.dumps(rows)))
    if not llama_gate_passes(losses, gate):
        raise AssertionError(
            "qwen3moe: the last epoch's next-token loss {} is not below "
            "the gate {:.4f}".format(losses[-1], gate))

    batches = [(x[i:i + QWEN3_BATCH], y[i:i + QWEN3_BATCH])
               for i in range(0, len(x), QWEN3_BATCH)]
    step_s, times = time_steps(trainer, batches)
    prof = profile_steps(train_step(trainer, batches),
                         ("flash_", "rmsnorm_kernel"))
    cost = tatt.flash_attention_cost(QWEN3_BATCH, LLAMA_SEQ, model.num_heads,
                                     model.num_kv_heads, model.head_dim,
                                     causal=True)
    tokens = QWEN3_BATCH * LLAMA_SEQ
    step_flops = (6.0 * n_active * tokens
                  + 3 * cost["forward"]["flops"] * model.num_layers)
    mfu = step_flops / step_s / PEAK_FLOPS["bf16"]
    summary = {
        "model": "Qwen3-30B-A3B bf16, {} of 48 layers".format(QWEN3_LAYERS),
        "parameters": n_total, "active_parameters": n_active,
        "batch": QWEN3_BATCH, "seq": LLAMA_SEQ, "steps": steps,
        "capacity_factor": QWEN3_CAPACITY,
        "aux_loss_weight": QWEN3_AUX_WEIGHT,
        "history": history, "aux_loss_per_epoch": aux,
        "next_token_loss_per_epoch": losses,
        "expert_load": watch.load, "peak_lr": QWEN3_LR,
        "next_token_entropy_given_current": entropy, "cycle_level": cycle,
        "loss_gate": gate, "fit_s": fit_s, "launches": launches,
        "one_step_check": check, "step_p50_s": step_s,
        "step_times_s": times, "tokens_per_s": tokens / step_s,
        "step_flops": step_flops, "mfu_active": mfu,
        "device_busy_share": prof["device_busy_share"],
        "port_kernels_share_of_device": prof["matched_share_of_device"],
        "device_ms_per_step": prof["device_ms_per_step"],
        "kernels_per_step": prof["kernels_per_step"],
        "top_kernels": prof["top_kernels"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    log("qwen3moe train: step p50 {:.2f} ms, {:.0f} tokens/s, MFU (active "
        "parameters) {:.4f}, device busy {}, device {:.1f} ms/step in {:.0f} "
        "kernels, the port's kernels {} of device time".format(
            step_s * 1e3, tokens / step_s, mfu, prof["device_busy_share"],
            prof["device_ms_per_step"], prof["kernels_per_step"],
            prof["matched_share_of_device"]))
    log_top_kernels("qwen3moe", prof["top_kernels"])
    del trainer
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return launches, summary, model, data


def generate_qwen3(model, data, device):
    """Phase 9's generate: the trained model set drop-free (as the
    importer makes a checkpoint) through `generate_llama`, with its copy
    imported as `qwen3_moe`."""
    cfg = qwen3_config(capacity_factor=None)
    model.moe_capacity_factor = None
    for block in model.blocks:
        block.moe.capacity_factor = None
    taught = data.get("last_loss", np.inf) < CHAIN_TAUGHT_LOSS
    return generate_llama(model, data, device, cfg=cfg,
                          model_type="qwen3_moe", label="qwen3moe",
                          chain_taught=taught)


# -- phase 10: lm_head_loss and the training loop -------------------------

# (name, N, D, V): Qwen3-30B-A3B's head (the public Qwen/Qwen3-30B-A3B
# config.json: hidden 2048, vocab 151936) at phase 9's batch 2 x 2048,
# and TinyLlama-1.1B's (hidden 2048, vocab 32000) at phase 7's 4 x 2048.
HEAD_CASES = (("qwen3_30b_a3b", 2 * 2048, 2048, 151936),
              ("tinyllama_1_1b", 4 * 2048, 2048, 32000))
# Share of labels set to -1 (ignored) in the head checks.
HEAD_IGNORED = 0.05
# lm_head_loss on bf16 inputs against lm_head_loss_reference on the same
# values in f32, element by element (`compare`): the loss is f32 in
# both, the same products summed in another order (1e-5 relative plus
# 1e-4 of the row, i.e. of the loss's rms); dh and dW are rounded to
# bf16 at the end (2^-8 relative: bf16's largest half step, at the
# bottom of a binade; plus 1e-3 rms(row) for the f32 sums in another
# order).
HEAD_TOL = {"loss": (1e-5, 1e-4), "grad": (2.0 ** -8, 1e-3)}
# The training loop on GPT-2 small: 3 epochs of 8 steps at phase 6's
# batch 8 x 1024; the resumed run is preempted before step 12 (epoch 1,
# batch 4).
LOOP_EPOCHS, LOOP_STEPS, LOOP_PREEMPT = 3, 8, 12
LOOP_EMA = 0.999
LOOP_TRAINABLE = r"lm_head|block_11"


def head_inputs(n, d, v, seed):
    """bf16 hidden [n, d] ~ N(0, 1), weights [d, v] ~ N(0, 0.02) and int64
    labels with HEAD_IGNORED of them -1, drawn on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
    w = (0.02 * torch.randn(d, v, generator=gen, device="cuda")).bfloat16()
    y = torch.randint(0, v, (n,), generator=gen, device="cuda")
    drop = torch.rand(n, generator=gen, device="cuda") < HEAD_IGNORED
    return h, w, torch.where(drop, -1, y)


def peak_extra_bytes(fn):
    """Bytes allocated at the peak of fn() beyond what was allocated
    before it (its results included while they live)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def event_ms(fn, iters=5):
    """Mean device time per call of fn() between CUDA events, after one
    call to warm up (the calls queue back to back, so the host's launches
    hide behind the device's work when it is the longer)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_lm_head_loss():
    """Phase 10a: lm_head_loss at Qwen3-30B-A3B's and TinyLlama's heads,
    against its plain version per element, with peak memory and times
    beside the materialised routes'."""
    import torch
    import torch.nn.functional as F
    from cloud_tpu_torch.ops import fused_ce

    results = {}
    for name, n, d, v in HEAD_CASES:
        h, w, y = head_inputs(n, d, v, seed=10)

        def chunked():
            hh, ww = h.detach().requires_grad_(), w.detach().requires_grad_()
            loss = fused_ce.lm_head_loss(hh, ww, y)
            return (loss,) + torch.autograd.grad(loss.sum(), (hh, ww))

        def reference():
            hh = h.detach().float().requires_grad_()
            ww = w.detach().float().requires_grad_()
            loss = fused_ce.lm_head_loss_reference(hh, ww, y)
            return (loss,) + torch.autograd.grad(loss.sum(), (hh, ww))

        def library():
            hh, ww = h.detach().requires_grad_(), w.detach().requires_grad_()
            loss = F.cross_entropy(F.linear(hh, ww.t()), y, ignore_index=-1,
                                   reduction="sum")
            return (loss,) + torch.autograd.grad(loss, (hh, ww))

        got = chunked()
        want = reference()
        checks = {"loss": compare(got[0][:, None], want[0][:, None],
                                  *HEAD_TOL["loss"]),
                  "dh": compare(got[1], want[1], *HEAD_TOL["grad"]),
                  "dW": compare(got[2], want[2], *HEAD_TOL["grad"])}
        ignored = y < 0
        zero_ignored = bool((got[0][ignored] == 0).all())
        del got, want
        torch.cuda.empty_cache()
        dw_bytes = d * v * 2
        row = {
            "N": n, "D": d, "V": v, "chunk": 8192,
            "ignored": int(ignored.sum()), "checks": checks,
            "ignored_loss_zero": zero_ignored,
            "peak_extra_bytes": peak_extra_bytes(chunked),
            "peak_extra_bytes_reference_f32": peak_extra_bytes(reference),
            "peak_extra_bytes_library_bf16": peak_extra_bytes(library),
            "dw_bytes": dw_bytes,
            "logits_and_grad_f32_bytes": 2 * n * v * 4,
            "ms": event_ms(chunked), "plain_ms": event_ms(reference),
            "library_ms": event_ms(library),
        }
        torch.cuda.empty_cache()
        results[name] = row
        log("lm_head_loss {} (N {}, D {}, V {}, {} ignored): loss tol ratio "
            "{:.3f}, dh {:.3f}, dW {:.3f}; peak extra {:.1f} MB (dW {:.1f} "
            "MB) against the f32 reference's {:.1f} MB and the bf16 "
            "library route's {:.1f} MB; fwd+bwd {:.2f} ms, plain {:.2f} ms, "
            "F.linear + F.cross_entropy {:.2f} ms".format(
                name, n, d, v, row["ignored"], checks["loss"]["tol_ratio"],
                checks["dh"]["tol_ratio"], checks["dW"]["tol_ratio"],
                row["peak_extra_bytes"] / 1e6, dw_bytes / 1e6,
                row["peak_extra_bytes_reference_f32"] / 1e6,
                row["peak_extra_bytes_library_bf16"] / 1e6, row["ms"],
                row["plain_ms"], row["library_ms"]))
        if not (all(c["tol_ratio"] <= 1.0 for c in checks.values())
                and zero_ignored):
            raise AssertionError("lm_head_loss disagrees with its plain "
                                 "version at {}: {}".format(name, checks))
        del h, w, y
    return results


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def max_param_diff(a, b):
    """Largest |a - b| over the two models' parameters, and whether every
    parameter is bit-equal."""
    import torch

    worst, equal = 0.0, True
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        if not torch.equal(p, q):
            equal = False
            worst = max(worst, (p.float() - q.float()).abs().max().item())
    return worst, equal


def optimizer_state_bytes(optimizer):
    return sum(t.numel() * t.element_size()
               for state in optimizer.state.values()
               for t in state.values() if hasattr(t, "numel"))


def training_loop(device, root):
    """Phase 10b: GPT-2 small through callbacks, checkpoints, a preempted
    and resumed fit, an EMA evaluation of a restored checkpoint and a
    fit with frozen parameters. Returns the summary (with the flash
    launches of U and of R, each counted from 0 around its fit)."""
    import shutil

    import torch
    from cloud_tpu_torch.analysis import chaos
    from cloud_tpu_torch.models import TransformerLM
    from cloud_tpu_torch.ops import attention as tatt
    from cloud_tpu_torch.training import (EarlyStopping, MetricsLogger,
                                          ModelCheckpoint, TerminateOnNaN,
                                          Trainer, checkpoint, make_optimizer,
                                          read_metrics_log, resilience)
    from cloud_tpu_torch.training.schedules import warmup_cosine

    work = os.path.join(root, "build", "chip_smoke_ckpt")
    shutil.rmtree(work, ignore_errors=True)
    n = LOOP_STEPS * TRAIN_BATCH
    x, y = training_data(5, n + 2 * TRAIN_BATCH, GPT2_SMALL["vocab_size"],
                         TRAIN_SEQ)
    x_val, y_val = x[n:], y[n:]
    x, y = x[:n], y[:n]
    total = LOOP_EPOCHS * LOOP_STEPS

    def trainer(**kw):
        model = TransformerLM(compute_dtype=torch.bfloat16, device=device,
                              seed=0, **GPT2_SMALL)
        return Trainer(model, optimizer=make_optimizer(
            "adamw", warmup_cosine(TRAIN_LR, total, total // 10)),
            metrics=("accuracy",), seed=0, **kw)

    def flash_launches():
        return {k: v for k, v in all_launches().items() if k in tatt.launches}

    layers = GPT2_SMALL["num_layers"]
    try:
        # (U) uninterrupted, with the callbacks and async logging.
        u = trainer(ema_decay=LOOP_EMA)
        reset_all_launches()
        t0 = time.monotonic()
        hist_u = u.fit(x, y, batch_size=TRAIN_BATCH, epochs=LOOP_EPOCHS,
                       verbose=False, callbacks=[
                           MetricsLogger(os.path.join(work, "metrics.jsonl")),
                           ModelCheckpoint(os.path.join(work, "u"),
                                           use_async=True),
                           TerminateOnNaN(),
                           EarlyStopping(monitor="loss", patience=10)])
        torch.cuda.synchronize()
        u_s = time.monotonic() - t0
        launches_u = flash_launches()
        records = read_metrics_log(os.path.join(work, "metrics.jsonl"))
        saved = sorted(int(s) for s in os.listdir(os.path.join(work, "u"))
                       if s.isdigit())
        want = {k: layers * total for k in launches_u}
        if (u.state.step != total or launches_u != want
                or [r["epoch"] for r in records] != list(range(LOOP_EPOCHS))
                or saved != [LOOP_STEPS * (e + 1)
                             for e in range(LOOP_EPOCHS)]):
            raise AssertionError(
                "U: step {}, launches {} (want {}), records {}, "
                "checkpoints {}".format(u.state.step, launches_u, want,
                                        records, saved))
        log("loop U: {} steps in {:.2f} s, losses {}; checkpoints {}".format(
            total, u_s, hist_u["loss"], saved))
        for step in saved[:-1]:      # keep the last for the restore below
            shutil.rmtree(os.path.join(work, "u", str(step)))

        # (R) preempted before step 12 and resumed under resume="auto".
        r = trainer(ema_decay=LOOP_EMA)
        resilience.reset_guard_stats()
        chaos.install("preempt@{}".format(LOOP_PREEMPT))
        reset_all_launches()
        t0 = time.monotonic()
        try:
            hist_r = r.fit(x, y, batch_size=TRAIN_BATCH, epochs=LOOP_EPOCHS,
                           verbose=False, resume="auto",
                           resume_from=os.path.join(work, "r"),
                           callbacks=[resilience.AutoCheckpoint(
                               os.path.join(work, "r"), use_async=True)])
        finally:
            chaos.uninstall()
        torch.cuda.synchronize()
        r_s = time.monotonic() - t0
        launches_r = flash_launches()
        guard = resilience.guard_stats()
        diff, bitwise = max_param_diff(u.model, r.model)
        ema_diff = max((u.ema_params[k].float() - r.ema_params[k].float())
                       .abs().max().item() for k in u.ema_params)
        loss_diff = abs(hist_r["loss"][-1] - hist_u["loss"][-1])
        want = {k: layers * total for k in launches_r}
        log("loop R: preempt@{} resumed to step {} in {:.2f} s; losses {}; "
            "last-epoch loss diff {:.3g}; params max diff {:.3g} (bitwise "
            "{}), EMA {:.3g}; guard {}".format(
                LOOP_PREEMPT, r.state.step, r_s, hist_r["loss"], loss_diff,
                diff, bitwise, ema_diff, guard))
        if not (r.state.step == total and launches_r == want
                and (guard["faults"], guard["retries"], guard["resumes"])
                == (1, 1, 1) and bitwise and loss_diff == 0.0
                and ema_diff == 0.0):
            raise AssertionError(
                "R: step {}, launches {} (want {}), guard {}, params "
                "bitwise {} (max diff {}), loss diff {}, EMA diff {}".format(
                    r.state.step, launches_r, want, guard, bitwise, diff,
                    loss_diff, ema_diff))
        del r
        shutil.rmtree(os.path.join(work, "r"))

        # A third Trainer restores U's last checkpoint and evaluates the
        # EMA shadow: the same numbers as U's.
        e = trainer(ema_decay=LOOP_EMA)
        ckpt_bytes = dir_bytes(os.path.join(work, "u", str(total)))
        t0 = time.monotonic()
        e.restore_checkpoint(os.path.join(work, "u"))
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        val_u = u.evaluate(x_val, y_val, batch_size=TRAIN_BATCH,
                           verbose=False, use_ema=True)
        val_e = e.evaluate(x_val, y_val, batch_size=TRAIN_BATCH,
                           verbose=False, use_ema=True)
        live = u.evaluate(x_val, y_val, batch_size=TRAIN_BATCH,
                          verbose=False)
        log("loop EMA: evaluate(use_ema=True) {} restored, {} in U; live "
            "weights {}".format(val_e, val_u, live))
        if val_e != val_u or e.state.step != total:
            raise AssertionError("the restored EMA evaluation {} differs "
                                 "from U's {}".format(val_e, val_u))

        # Save and restore times, on U's state.
        timing_dir = os.path.join(work, "timing")
        t0 = time.monotonic()
        u.save_checkpoint(timing_dir)
        sync_s = time.monotonic() - t0
        t0 = time.monotonic()
        u.save_checkpoint(os.path.join(timing_dir, "async"), use_async=True)
        async_return_s = time.monotonic() - t0
        checkpoint.wait_until_finished()
        async_done_s = time.monotonic() - t0
        log("loop checkpoint: {:.1f} MB; sync save {:.2f} s, async save "
            "returns in {:.2f} s and finishes in {:.2f} s, restore {:.2f} "
            "s".format(ckpt_bytes / 1e6, sync_s, async_return_s,
                       async_done_s, restore_s))
        state_bytes_u = optimizer_state_bytes(u.optimizer)
        del u, e
        shutil.rmtree(work)
        torch.cuda.empty_cache()

        # (T) one epoch with frozen parameters.
        t = trainer(trainable=LOOP_TRAINABLE)
        before = {k: p.detach().clone()
                  for k, p in t.model.named_parameters()}
        t.fit(x, y, batch_size=TRAIN_BATCH, epochs=1, verbose=False)
        frozen = [k for k, p in t.model.named_parameters()
                  if not p.requires_grad]
        moved = [k for k in frozen
                 if not torch.equal(before[k], dict(
                     t.model.named_parameters())[k])]
        trained = [k for k, p in t.model.named_parameters()
                   if p.requires_grad]
        state_bytes_t = optimizer_state_bytes(t.optimizer)
        with_state = len(t.optimizer.state)
        log("loop T: trainable={!r}: {} trained, {} frozen ({} moved); "
            "AdamW state {:.1f} MB over {} tensors, U's {:.1f} MB".format(
                LOOP_TRAINABLE, len(trained), len(frozen), len(moved),
                state_bytes_t / 1e6, with_state, state_bytes_u / 1e6))
        if moved or with_state != len(trained) or not frozen:
            raise AssertionError("T: frozen parameters moved {} or AdamW "
                                 "state for {} of {} trained".format(
                                     moved, with_state, len(trained)))
        del t, before
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = {
        "model": "GPT-2 small bf16", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "epochs": LOOP_EPOCHS, "steps_per_epoch": LOOP_STEPS,
        "ema_decay": LOOP_EMA, "history_u": hist_u, "history_r": hist_r,
        "fit_u_s": u_s, "fit_r_s": r_s, "guard_stats": guard,
        "resume_param_max_diff": diff, "resume_bitwise": bitwise,
        "resume_last_loss_diff": loss_diff, "resume_ema_max_diff": ema_diff,
        "ema_evaluate_restored": val_e, "ema_evaluate_u": val_u,
        "evaluate_live_u": live, "checkpoint_bytes": ckpt_bytes,
        "sync_save_s": sync_s, "async_save_return_s": async_return_s,
        "async_save_done_s": async_done_s, "restore_s": restore_s,
        "trainable": LOOP_TRAINABLE, "trained_params": len(trained),
        "frozen_params": len(frozen),
        "optimizer_state_bytes_trainable": state_bytes_t,
        "optimizer_state_bytes_u": state_bytes_u,
        "launches_u": launches_u, "launches_r": launches_r,
    }
    return summary


# -- phase 11: the image families (MNIST, ResNet-50, ViT-B/16) ------------

# Synthetic images whose class a model can recover: one random template
# per class (unit normal per pixel) under unit normal noise.
IMAGE_CLASSES = tuple(range(0, 1000, 100))   # K = 10 of the 1000 classes
IMAGE_SIZE = 224
IMAGE_TRAIN = 2560                           # 10 batches of 256
IMAGE_HELD_OUT = 512
# bench.py's operating point (`cloud_tpu`'s headline number): ResNet-50
# at batch 256, 224 x 224, SGD 0.1 with momentum 0.9, bf16 compute, the
# data resident on the device, steps_per_execution.
RESNET_BATCH = 256
RESNET_SPE = 5
RESNET_EPOCHS = 8
VIT_BATCH = 256
VIT_EPOCHS = 6
VIT_PEAK_LR = 1e-3
# Held-out accuracy gates (chance is 1/K): the templates are far apart
# under the noise, so a model that learned them scores near 1.
IMAGE_ACC_GATE = 0.9
MNIST_ACC_GATE = 0.9
MNIST_TRAIN, MNIST_HELD_OUT, MNIST_BATCH, MNIST_EPOCHS = 4096, 1024, 128, 2
MNIST_SPE = 16
OPTIMIZER_STEPS = 20
# The eight optimizers' 20 steps on an f32 MLP, card against CPU: the
# parameters' distance ||card - cpu|| within this share of their
# movement ||cpu - start|| (the same f32 arithmetic summed in other
# orders; adaptive optimizers divide by sqrt(v) and Lion takes signs,
# which can turn a rounding difference of a near-zero entry into a step).
OPTIMIZER_TOL = 1e-2
# One ResNet-50 step in bf16 against the same step with compute_dtype
# float32 (TF32 off in cuBLAS and cuDNN): the loss within 2e-2 relative
# and each parameter's gradient norm within 5e-2 relative plus 1e-3 of
# the largest norm (bf16 rounds every activation of 50 layers to 2^-9,
# and BatchNorm divides by batch statistics computed from them).
RESNET_LOSS_TOL = 2e-2
RESNET_GRAD_TOL = 5e-2
# One BatchNorm layer's running statistics after a step against flax's
# rule computed by hand in f32 from the layer's input: r <- 0.9 r + 0.1
# s, s the batch mean and the biased variance E[x^2] - E[x]^2; 1e-3
# relative plus 1e-6 (the kernels' sums in other orders, and the
# variance recovered from 1 / sqrt(var + eps)).
BN_STATS_TOL = 1e-3


def class_images(seed, n, size, classes, channels=3):
    """(x [n, size, size, channels] f32, or [n, size, size] without
    channels; labels in `classes`): each example its class's template
    plus noise, both unit normal; the classes in a shuffled cycle."""
    rng = np.random.default_rng(seed)
    k = len(classes)
    shape = (size, size, channels) if channels else (size, size)
    templates = rng.standard_normal((k,) + shape, dtype=np.float32)
    idx = np.arange(n) % k
    rng.shuffle(idx)
    x = rng.standard_normal((n,) + shape, dtype=np.float32)
    x += templates[idx]
    return x, np.asarray(classes, np.int32)[idx]


def step_counters():
    """The counters a warm start must leave unmoved on step 1: nvcc
    builds (and their seconds), graph captures, the guard counters."""
    from cloud_tpu_torch.ops import _build
    from cloud_tpu_torch.training import trainer as ttrainer
    from cloud_tpu_torch.training.resilience import guard_stats

    return {"builds": _build.build_count(),
            "build_seconds": dict(_build.build_seconds),
            "captures": ttrainer.graph_captures(), "guard": guard_stats()}


def step_clock():
    """A callback timing each epoch's steps: on_epoch_begin marks the
    host clock (after the fit's upload and warm start), on_epoch_end
    synchronizes the card and records the seconds, the clock at the
    start and the end (`begin`, `end`) and `step_counters` before and
    after. Returns (callback, rows)."""
    import torch
    from cloud_tpu_torch.training.callbacks import Callback

    rows = []

    class Clock(Callback):
        def on_epoch_begin(self, epoch, logs=None):
            self.t0 = time.monotonic()
            self.before = step_counters()

        def on_epoch_end(self, epoch, logs=None):
            torch.cuda.synchronize()
            end = time.monotonic()
            rows.append({"seconds": end - self.t0, "begin": self.t0,
                         "end": end,
                         "counters_before": self.before,
                         "counters_after": step_counters()})

    return Clock(), rows


def params_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def same_state(a, b):
    import torch

    return all(torch.equal(a[k], b[k].to(a[k].device)) for k in a)


def mnist_phase(device, smi):
    """Phase 11a: MNIST's MLP and ConvNet on class-template images."""
    import torch
    from cloud_tpu_torch.models import MLP, ConvNet
    from cloud_tpu_torch.parallel import runtime
    from cloud_tpu_torch.training import OPTIMIZERS, Trainer
    from cloud_tpu_torch.training import data as tdata

    out = {}
    x, y = class_images(21, MNIST_TRAIN + MNIST_HELD_OUT, 28,
                        tuple(range(10)), channels=0)
    x_tr, y_tr = x[:MNIST_TRAIN], y[:MNIST_TRAIN]
    x_te, y_te = x[MNIST_TRAIN:], y[MNIST_TRAIN:]

    def adam(params):
        # The example's optax.adam(1e-3), capturable so that the graph
        # route and the eager one run the same arithmetic.
        return torch.optim.Adam(params, lr=1e-3, capturable=True)

    def mlp_trainer(spe=1):
        return Trainer(MLP(hidden=512, num_classes=10, device=device,
                           seed=0), optimizer=adam, seed=0,
                       steps_per_execution=spe)

    fits = {}
    for spe in (1, MNIST_SPE):
        trainer = mlp_trainer(spe)
        h = trainer.fit(x_tr, y_tr, epochs=MNIST_EPOCHS,
                        batch_size=MNIST_BATCH, verbose=False)
        torch.cuda.synchronize()
        fits[spe] = (trainer, h, params_of(trainer.model))
    (t1, h1, p1), (t16, h16, p16) = fits[1], fits[MNIST_SPE]
    if t16._spe_route != "graph":
        raise AssertionError("MNIST spe fit did not take the graph route")
    if not (same_state(p1, p16) and h1["loss"] == h16["loss"]):
        raise AssertionError("MNIST fit at steps_per_execution {} is not "
                             "bit-equal to spe 1".format(MNIST_SPE))
    acc = t1.evaluate(x_te, y_te, batch_size=256,
                      verbose=False)["accuracy"]
    log("11a MLP(512): held-out accuracy {:.4f} (gate {}); spe 1 and {} "
        "bit-equal; steps/s (last epoch, host clock) spe 1 {:.1f}, spe {} "
        "{:.1f} [{}]".format(acc, MNIST_ACC_GATE, MNIST_SPE,
                             h1["steps_per_sec"][-1], MNIST_SPE,
                             h16["steps_per_sec"][-1], smi))
    if not acc >= MNIST_ACC_GATE:
        raise AssertionError("MNIST MLP held-out accuracy {} below {}"
                             .format(acc, MNIST_ACC_GATE))
    out["mlp"] = {"held_out_accuracy": acc, "loss": h1["loss"],
                  "steps_per_sec_spe1": h1["steps_per_sec"],
                  "steps_per_sec_spe16": h16["steps_per_sec"]}

    # cache="device" with input_cast="uint8" against the host-fed fit
    # under the same cast (both at spe 16: graph replays).
    host = mlp_trainer(MNIST_SPE)
    hh = host.fit(x_tr, y_tr, epochs=MNIST_EPOCHS, batch_size=MNIST_BATCH,
                  input_cast="uint8", verbose=False)
    res = mlp_trainer(MNIST_SPE)
    runtime.reset_transfer_stats()
    hr = res.fit(x_tr, y_tr, epochs=MNIST_EPOCHS, batch_size=MNIST_BATCH,
                 cache="device", input_cast="uint8", verbose=False)
    torch.cuda.synchronize()
    stats = runtime.transfer_stats()
    upload = MNIST_TRAIN * 28 * 28 + MNIST_TRAIN * 8
    if stats["h2d_bytes"] != upload or stats["h2d_transfers"] != 2:
        raise AssertionError("resident fit moved {} h2d bytes in {} "
                             "transfers; the upload is {}".format(
                                 stats["h2d_bytes"], stats["h2d_transfers"],
                                 upload))
    if hh["loss"] != hr["loss"] or not same_state(params_of(host.model),
                                                  params_of(res.model)):
        raise AssertionError("resident uint8 fit differs from host-fed")
    log("11a resident uint8 fit: h2d {} bytes in {} transfers (the upload "
        "alone: zero example bytes after it), d2h {} fetches; history and "
        "parameters bit-equal to the host-fed fit [{}]".format(
            stats["h2d_bytes"], stats["h2d_transfers"],
            stats["d2h_fetches"], smi))
    out["resident"] = {"transfer_stats": stats, "upload_bytes": upload}

    # The streaming datasets and prefetch_to_device over the same batches
    # (in order) against the array fit without shuffling.
    batches = [(x_tr[i:i + MNIST_BATCH], y_tr[i:i + MNIST_BATCH])
               for i in range(0, MNIST_TRAIN, MNIST_BATCH)]
    ref = mlp_trainer().fit(x_tr, y_tr, epochs=MNIST_EPOCHS,
                            batch_size=MNIST_BATCH, shuffle=False,
                            verbose=False)
    streams = {
        "GeneratorDataset": tdata.GeneratorDataset(lambda: iter(batches)),
        "ThreadedDataset": tdata.ThreadedDataset(
            tdata.GeneratorDataset(lambda: iter(batches)), buffer_size=4),
        "prefetch_to_device": list(tdata.prefetch_to_device(
            iter(batches), size=2, device=device))}
    for name, stream in streams.items():
        h = mlp_trainer().fit(stream, epochs=MNIST_EPOCHS, verbose=False)
        if h["loss"] != ref["loss"]:
            raise AssertionError("{} history {} differs from the array "
                                 "fit's {}".format(name, h["loss"],
                                                   ref["loss"]))
    log("11a GeneratorDataset, ThreadedDataset and prefetch_to_device: "
        "histories bit-equal to the array fit's")

    conv = Trainer(ConvNet(num_classes=10, device=device, seed=0),
                   optimizer="adam", seed=0)
    conv.fit(x_tr, y_tr, epochs=MNIST_EPOCHS, batch_size=MNIST_BATCH,
             verbose=False)
    conv_acc = conv.evaluate(x_te, y_te, batch_size=256,
                             verbose=False)["accuracy"]
    log("11a ConvNet: held-out accuracy {:.4f} (gate {}) [{}]".format(
        conv_acc, MNIST_ACC_GATE, smi))
    if not conv_acc >= MNIST_ACC_GATE:
        raise AssertionError("ConvNet held-out accuracy {} below {}"
                             .format(conv_acc, MNIST_ACC_GATE))
    out["convnet"] = {"held_out_accuracy": conv_acc}

    # Each optimizer, 20 steps in f32, on the card and on the CPU.
    opt_rows = {}
    for name in OPTIMIZERS:
        finals = {}
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            model = MLP(hidden=512, num_classes=10,
                        compute_dtype=torch.float32, device=dev, seed=0)
            start = {k: v.cpu() for k, v in params_of(model).items()}
            trainer = Trainer(model, optimizer=name, seed=0)
            trainer.fit(x_tr, y_tr, epochs=1, batch_size=MNIST_BATCH,
                        steps_per_epoch=OPTIMIZER_STEPS, shuffle=False,
                        verbose=False)
            finals[where] = {k: v.cpu() for k, v in
                             params_of(model).items()}
        diff = sum(float((finals["card"][k] - finals["cpu"][k]).square()
                         .sum()) for k in start) ** 0.5
        moved = sum(float((finals["cpu"][k] - start[k]).square().sum())
                    for k in start) ** 0.5
        rel = diff / max(moved, 1e-30)
        opt_rows[name] = {"rel_distance": rel, "moved": moved}
        if not rel <= OPTIMIZER_TOL:
            raise AssertionError("optimizer {}: card against CPU {:.3e} of "
                                 "the movement > {}".format(
                                     name, rel, OPTIMIZER_TOL))
    log("11a optimizers, {} f32 steps, ||card - cpu|| / ||cpu - start||: {} "
        "(tol {})".format(OPTIMIZER_STEPS, ", ".join(
            "{} {:.2e}".format(k, v["rel_distance"])
            for k, v in opt_rows.items()), OPTIMIZER_TOL))
    out["optimizers"] = opt_rows
    return out


def grads_and_loss(model, x, y):
    """One step's loss and each parameter's gradient norm (train mode)."""
    import torch.nn.functional as F

    model.zero_grad(set_to_none=True)
    logits = model(x, train=True)
    loss = F.cross_entropy(logits.float(), y.long())
    loss.backward()
    norms = {n: p.grad.float().norm().item()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), norms


def compare_norms(name, loss_a, norms_a, loss_b, norms_b, loss_tol,
                  grad_tol, floor=1e-3):
    """loss_a against loss_b (relative) and each gradient norm within
    grad_tol relative plus floor x the largest norm of b."""
    top = max(norms_b.values())
    worst, worst_name = 0.0, None
    for key, want in norms_b.items():
        err = abs(norms_a[key] - want) / (want + floor * top)
        if err > worst:
            worst, worst_name = err, key
    loss_rel = abs(loss_a - loss_b) / abs(loss_b)
    log("{}: loss {:.6f} against {:.6f} (rel {:.2e}, tol {}); worst "
        "grad-norm error {:.2e} at {} (tol {} relative + {} of the largest)"
        .format(name, loss_a, loss_b, loss_rel, loss_tol, worst, worst_name,
                grad_tol, floor))
    if not (np.isfinite(loss_a) and loss_rel <= loss_tol
            and worst <= grad_tol):
        raise AssertionError(name + " disagrees")
    return {"loss": loss_a, "reference_loss": loss_b,
            "loss_rel_diff": loss_rel, "worst_grad_norm_err": worst,
            "worst_grad_norm_param": worst_name}


def graph_of(trainer):
    return next(iter(trainer._graphs.values()))


def resnet_phase(device, smi, x, y):
    """Phase 11b: ResNet-50 at full width at bench.py's operating point."""
    import torch
    from cloud_tpu_torch.models import ResNet50
    from cloud_tpu_torch.models.resnet import resnet_train_flops
    from cloud_tpu_torch.parallel import runtime
    from cloud_tpu_torch.training import Trainer, make_optimizer

    torch.backends.cudnn.benchmark = True
    x_tr, y_tr = x[:IMAGE_TRAIN], y[:IMAGE_TRAIN]
    x_te, y_te = x[IMAGE_TRAIN:], y[IMAGE_TRAIN:]
    fit_kw = dict(batch_size=RESNET_BATCH, cache="device",
                  input_cast="bfloat16", verbose=False)

    def trainer_of(model, spe=RESNET_SPE, remat=False):
        return Trainer(model, optimizer=make_optimizer("sgd", 0.1), seed=0,
                       metrics=("accuracy",), train_kwargs={"train": True},
                       eval_kwargs={"train": False},
                       steps_per_execution=spe, remat=remat)

    out = {}
    # The first step's latency. With fit(warm_start=True), on a Trainer of
    # its own: the warm-up, from fit()'s call to its epoch's start (the
    # upload, cuDNN's algorithm search at these shapes, the warm step, the
    # capture), then step 1 alone, which must move no counter. It runs
    # first in the process, so that its warm-up pays cuDNN's search as a
    # fresh job's does. Then without a warm start, on the Trainer that
    # goes on to the fit: from fit()'s call to step 1's end. cuDNN's
    # search is not in it (its cache is the process's, filled by the warm
    # case): a lower bound of a fresh job's cold first step.
    warm_cb, warm_rows = step_clock()
    cold_cb, cold_rows = step_clock()
    warm = trainer_of(ResNet50(num_classes=1000, device=device, seed=0))
    t_warm = time.monotonic()
    warm.fit(x_tr, y_tr, epochs=1, steps_per_epoch=1, warm_start=True,
             callbacks=[warm_cb], **fit_kw)
    first = warm_rows[0]
    warm_up_s = first["begin"] - t_warm
    moved = {k: (first["counters_before"][k], first["counters_after"][k])
             for k in first["counters_before"]
             if first["counters_before"][k] != first["counters_after"][k]}
    del warm
    torch.cuda.empty_cache()
    model = ResNet50(num_classes=1000, device=device, seed=0)
    trainer = trainer_of(model)
    before_cold = step_counters()
    t_cold = time.monotonic()
    trainer.fit(x_tr, y_tr, epochs=1, steps_per_epoch=1,
                callbacks=[cold_cb], **fit_kw)
    cold_s = cold_rows[0]["end"] - t_cold
    cold_captures = cold_rows[0]["counters_after"]["captures"] \
        - before_cold["captures"]
    log("11b ResNet-50 first step: fit(warm_start=True) warms up for "
        "{:.3f} s (the upload, cuDNN's search, the warm step, the capture), "
        "then step 1 takes {:.3f} s (counters moved on step 1: {}); without "
        "a warm start, from fit() to step 1's end {:.3f} s ({} capture(s) in "
        "it; cuDNN's search already paid by the warm case, so a lower bound "
        "of a fresh job's) [{}]".format(
            warm_up_s, first["seconds"], moved or "none", cold_s,
            cold_captures, smi))
    if moved:
        raise AssertionError("warm start: step 1 moved {}".format(moved))
    out["first_step_s"] = {"warm_up": warm_up_s,
                           "warm_step_1": first["seconds"],
                           "cold_without_cudnn_search": cold_s}

    # The fit uploads anew (as every fit does) and its warm start hands
    # the upload to the graph the cold fit captured: no capture, and no
    # h2d byte beyond the upload.
    runtime.reset_transfer_stats()
    torch.cuda.reset_peak_memory_stats()
    captures = step_counters()["captures"]
    t_fit = time.monotonic()
    history = trainer.fit(x_tr, y_tr, epochs=RESNET_EPOCHS, warm_start=True,
                          **fit_kw)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t_fit
    # Reserved, not allocated: a graph replay allocates nothing, its
    # step's memory is the graph's pool.
    peak_fit = torch.cuda.max_memory_reserved()
    stats = runtime.transfer_stats()
    upload = IMAGE_TRAIN * (IMAGE_SIZE * IMAGE_SIZE * 3 * 2 + 8)
    if stats["h2d_bytes"] != upload or stats["h2d_transfers"] != 2:
        raise AssertionError("resident ResNet fit moved {} h2d bytes in {} "
                             "transfers; the upload is {}".format(
                                 stats["h2d_bytes"], stats["h2d_transfers"],
                                 upload))
    if trainer._spe_route != "graph":
        raise AssertionError("ResNet fit did not take the graph route")
    if step_counters()["captures"] != captures:
        raise AssertionError("the ResNet fit captured its step again")
    resident = graph_of(trainer).resident
    log("11b ResNet-50 fit: {} epochs x {} steps (spe {}, graph, taken "
        "over by the new upload), loss {} accuracy {}; {:.1f} s; h2d {} "
        "bytes, the upload alone; peak reserved memory {:.2f} GB [{}]"
        .format(RESNET_EPOCHS, IMAGE_TRAIN // RESNET_BATCH, RESNET_SPE,
                [round(v, 4) for v in history["loss"]],
                [round(v, 4) for v in history["accuracy"]], fit_s,
                stats["h2d_bytes"], peak_fit / 1e9, smi))
    val = trainer.evaluate(x_te, y_te, batch_size=RESNET_BATCH,
                           verbose=False)
    pred = trainer.predict(x_te, batch_size=RESNET_BATCH)
    pred_acc = float((pred.argmax(-1) == y_te).mean())
    if pred.shape != (IMAGE_HELD_OUT, 1000) or not np.isfinite(pred).all():
        raise AssertionError("predict gave {}".format(pred.shape))
    if abs(pred_acc - val["accuracy"]) > 1e-6:
        raise AssertionError("predict accuracy {} != evaluate's {}".format(
            pred_acc, val["accuracy"]))
    log("11b ResNet-50 held-out (train=False): loss {:.4f} accuracy {:.4f} "
        "(gate {}), predict's argmax accuracy {:.4f}".format(
            val["loss"], val["accuracy"], IMAGE_ACC_GATE, pred_acc))
    if not val["accuracy"] >= IMAGE_ACC_GATE:
        raise AssertionError("ResNet-50 held-out accuracy {} below {}"
                             .format(val["accuracy"], IMAGE_ACC_GATE))

    graph = graph_of(trainer)
    graph.start_epoch(resident.epoch_order(0), 0)
    times = []
    for _ in range(10):
        t1 = time.monotonic()
        graph.run()
        torch.cuda.synchronize()
        times.append(time.monotonic() - t1)
    p50 = float(np.median(times))
    flops = resnet_train_flops(model, RESNET_BATCH, IMAGE_SIZE)
    mfu = flops / p50 / PEAK_FLOPS["bf16"]
    graph.start_epoch(resident.epoch_order(0), 0)
    prof = profile_steps(lambda i: graph.run(), ("conv",), n=3)
    idx = torch.arange(RESNET_BATCH, device=device)
    bx, by = resident.gather(idx)
    eager_times = []
    for _ in range(5):
        t1 = time.monotonic()
        trainer._step(bx, by, None)
        torch.cuda.synchronize()
        eager_times.append(time.monotonic() - t1)
    eager_prof = profile_steps(lambda i: trainer._step(bx, by, None),
                               ("conv",), n=3)
    log("11b ResNet-50 step (graph replay): p50 {:.2f} ms, {:.0f} images/s, "
        "MFU {:.1%} ({:.3f} TFLOP a step from the conv and dense shapes); "
        "busy {} over replays, {} kernels a step under the profiler; eager "
        "step p50 {:.2f} ms, busy {}, {:.0f} kernels a step, device {:.2f} "
        "ms [{}]".format(
            p50 * 1e3, RESNET_BATCH / p50, mfu, flops / 1e12,
            prof["device_busy_share"], prof["kernels_per_step"],
            float(np.median(eager_times)) * 1e3,
            eager_prof["device_busy_share"], eager_prof["kernels_per_step"],
            eager_prof["device_ms_per_step"], smi))
    log_top_kernels("11b resnet50 eager", eager_prof["top_kernels"][:5])
    out.update({
        "history": history, "fit_s": fit_s, "peak_fit_bytes": peak_fit,
        "held_out": val, "step_p50_s": p50, "step_s": times,
        "images_per_s": RESNET_BATCH / p50, "mfu": mfu,
        "train_flops_per_step": flops, "profile_graph": prof,
        "eager_step_p50_s": float(np.median(eager_times)),
        "profile_eager": eager_prof})

    # One step in bf16 against the same step in f32 from the initial
    # weights (the trained model's loss is ~1e-3, its gradients rounding
    # noise); the first BatchNorm's running statistics against flax's rule
    # by hand.
    state = params_of(model)
    xb = torch.tensor(x_te[:64], device=device)
    yb = torch.tensor(y_te[:64], device=device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lo = ResNet50(num_classes=1000, device=device, seed=0)
        hi = ResNet50(num_classes=1000, compute_dtype=torch.float32,
                      device=device, seed=0)
        seen = {}

        def keep_input(module, args):
            seen.setdefault("x", args[0].detach())

        hook = lo.bn_init.register_forward_pre_hook(keep_input)
        old_mean = lo.bn_init.running_mean.clone()
        old_var = lo.bn_init.running_var.clone()
        loss_lo, norms_lo = grads_and_loss(lo, xb, yb)
        hook.remove()
        loss_hi, norms_hi = grads_and_loss(hi, xb, yb)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out["one_step"] = compare_norms(
        "11b ResNet-50 one step bf16 against f32", loss_lo, norms_lo,
        loss_hi, norms_hi, RESNET_LOSS_TOL, RESNET_GRAD_TOL)
    xf = seen["x"].float()
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
    want_mean = 0.9 * old_mean + 0.1 * mean
    want_var = 0.9 * old_var + 0.1 * var
    bn_err = max(
        ((lo.bn_init.running_mean - want_mean).abs()
         / (want_mean.abs() * BN_STATS_TOL + 1e-6)).max().item(),
        ((lo.bn_init.running_var - want_var).abs()
         / (want_var.abs() * BN_STATS_TOL + 1e-6)).max().item())
    log("11b bn_init running statistics against flax's rule by hand: "
        "{:.3f} of the tolerance ({} relative + 1e-6)".format(
            bn_err, BN_STATS_TOL))
    if not bn_err <= 1.0:
        raise AssertionError("BatchNorm running statistics off flax's rule")
    out["bn_stats_tol_ratio"] = bn_err
    del lo, hi, seen, xf

    # remat: the same step's gradients with and without recompute, cuDNN
    # deterministic (its deterministic algorithms, chosen by heuristics:
    # benchmark's choice by timing can take another algorithm for the
    # recompute than for the forward, and then the last bits differ);
    # the running statistics moved once (equal to the plain step's);
    # peak memory of each.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    remat_rows, grads, buffers = {}, {}, {}
    try:
        for remat in (False, True):
            m = ResNet50(num_classes=1000, device=device, seed=None)
            m.load_state_dict(state)
            t = trainer_of(m, spe=1, remat=remat)
            t.build()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outputs = t._forward(bx, 0, False)
            loss = torch.nn.functional.cross_entropy(outputs, by.long())
            loss.backward()
            torch.cuda.synchronize()
            remat_rows["peak_bytes_remat" if remat else "peak_bytes_plain"] \
                = torch.cuda.max_memory_allocated() - base
            grads[remat] = {n: p.grad.clone()
                            for n, p in m.named_parameters()}
            buffers[remat] = {n: b.clone() for n, b in m.named_buffers()}
            del m, t, outputs, loss
    finally:
        torch.backends.cudnn.deterministic = False
    equal = all(torch.equal(grads[False][n], grads[True][n])
                for n in grads[False])
    once = all(torch.equal(buffers[False][n], buffers[True][n])
               for n in buffers[False])
    log("11b ResNet-50 remat at batch {}: gradients bit-equal to the plain "
        "step's {}, running statistics moved once {}; peak step memory "
        "plain {:.2f} GB, remat {:.2f} GB [{}]".format(
            RESNET_BATCH, equal, once,
            remat_rows["peak_bytes_plain"] / 1e9,
            remat_rows["peak_bytes_remat"] / 1e9, smi))
    if not (equal and once):
        raise AssertionError("remat step differs from the plain step")
    out["remat"] = remat_rows
    del trainer, model, graph, grads, buffers, resident, bx, by, state
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    return out


def vit_one_step_check(model, x, y):
    """ViT-B/16's loss and gradient norms of one step with attention by
    the flash kernels and by mha_reference (the model's attention call
    swapped for the second run only)."""
    from cloud_tpu_torch.models import vit as tvit
    from cloud_tpu_torch.ops import attention as tatt

    tatt.reset_launches()
    loss_k, norms_k = grads_and_loss(model, x, y)
    launched = dict(tatt.launches)
    kernel_attention = tvit.attention_ops.attention

    def plain(q, k, v, causal=True, **kw):
        return tatt.mha_reference(q, k, v, causal=causal, **kw)

    tvit.attention_ops.attention = plain
    try:
        loss_p, norms_p = grads_and_loss(model, x, y)
    finally:
        tvit.attention_ops.attention = kernel_attention
    if any(v != model.num_layers for v in launched.values()):
        raise AssertionError("ViT one-step check launched {}".format(
            launched))
    return compare_norms("11c ViT-B/16 one step, flash against "
                         "mha_reference", loss_k, norms_k, loss_p, norms_p,
                         STEP_LOSS_TOL, STEP_GRAD_TOL)


def vit_phase(device, smi, x, y):
    """Phase 11c: ViT-B/16 at full width; returns (flash launches of its
    fit, details)."""
    import torch
    from cloud_tpu_torch.models import ViT_B16
    from cloud_tpu_torch.models.vit import vit_train_flops
    from cloud_tpu_torch.ops import attention as tatt
    from cloud_tpu_torch.training import Trainer, make_optimizer, schedules

    x_tr, y_tr = x[:IMAGE_TRAIN], y[:IMAGE_TRAIN]
    x_te, y_te = x[IMAGE_TRAIN:], y[IMAGE_TRAIN:]
    model = ViT_B16(num_classes=1000, device=device, seed=0)
    out = {"one_step": vit_one_step_check(
        model, torch.tensor(x_te[:32], device=device),
        torch.tensor(y_te[:32], device=device))}
    steps = VIT_EPOCHS * (IMAGE_TRAIN // VIT_BATCH)
    trainer = Trainer(model, optimizer=make_optimizer(
        "adamw", schedules.warmup_cosine(VIT_PEAK_LR, steps,
                                         warmup_steps=steps // 10)),
        seed=0, train_kwargs={"train": True})
    torch.cuda.reset_peak_memory_stats()
    tatt.reset_launches()
    t_fit = time.monotonic()
    history = trainer.fit(x_tr, y_tr, epochs=VIT_EPOCHS,
                          batch_size=VIT_BATCH, cache="device",
                          input_cast="bfloat16", verbose=False)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t_fit
    launches = dict(tatt.launches)
    peak = torch.cuda.max_memory_allocated()
    want = model.num_layers * steps
    if any(v != want for v in launches.values()):
        raise AssertionError("ViT fit launched {}, want {} each".format(
            launches, want))
    val = trainer.evaluate(x_te, y_te, batch_size=VIT_BATCH, verbose=False)
    log("11c ViT-B/16 fit: {} steps of {} (AdamW, bf16), loss {} accuracy "
        "{}; {:.1f} s; flash launches {} ({} a step each: one per layer); "
        "held-out loss {:.4f} accuracy {:.4f} (gate {}); peak memory {:.2f} "
        "GB [{}]".format(steps, VIT_BATCH,
                         [round(v, 4) for v in history["loss"]],
                         [round(v, 4) for v in history["accuracy"]], fit_s,
                         launches, model.num_layers, val["loss"],
                         val["accuracy"], IMAGE_ACC_GATE, peak / 1e9, smi))
    if not val["accuracy"] >= IMAGE_ACC_GATE:
        raise AssertionError("ViT-B/16 held-out accuracy {} below {}"
                             .format(val["accuracy"], IMAGE_ACC_GATE))
    # One batch as the fit's resident copy holds it: bf16 features
    # (round to nearest even, as the input cast narrows), int64 labels.
    bx = torch.tensor(x_tr[:VIT_BATCH], device=device).to(torch.bfloat16)
    by = torch.tensor(y_tr[:VIT_BATCH], device=device).long()
    times = []
    for _ in range(10):
        t1 = time.monotonic()
        trainer._step(bx, by, None)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t1)
    p50 = float(np.median(times))
    flops = vit_train_flops(model, VIT_BATCH)
    prof = profile_steps(lambda i: trainer._step(bx, by, None),
                         ("flash",), n=3)
    log("11c ViT-B/16 step: p50 {:.2f} ms, {:.0f} images/s, MFU {:.1%} "
        "({:.3f} TFLOP a step from the shapes); busy {:.1%}, {:.0f} kernels "
        "a step, device {:.2f} ms a step, flash kernels {:.1%} of it [{}]"
        .format(p50 * 1e3, VIT_BATCH / p50, flops / p50 / PEAK_FLOPS["bf16"],
                flops / 1e12, prof["device_busy_share"] or 0.0,
                prof["kernels_per_step"], prof["device_ms_per_step"],
                prof["matched_share_of_device"] or 0.0, smi))
    log_top_kernels("11c vit_b16", prof["top_kernels"][:5])
    out.update({"history": history, "fit_s": fit_s, "launches": launches,
                "held_out": val, "peak_fit_bytes": peak, "step_p50_s": p50,
                "step_s": times, "images_per_s": VIT_BATCH / p50,
                "mfu": flops / p50 / PEAK_FLOPS["bf16"],
                "train_flops_per_step": flops, "profile": prof})
    del trainer, model, bx, by
    torch.cuda.empty_cache()
    return launches, out


def image_phase(device, smi):
    """Phase 11: MNIST, ResNet-50 and ViT-B/16 through Trainer.fit.
    Returns (ViT's flash launches, details). The ViT shape's flash
    timing runs with the other shapes' (`time_flash_kernels`)."""
    import torch

    t_phase = time.monotonic()
    details = {"mnist": mnist_phase(device, smi)}
    t_data = time.monotonic()
    x, y = class_images(31, IMAGE_TRAIN + IMAGE_HELD_OUT, IMAGE_SIZE,
                        IMAGE_CLASSES)
    details["image_data_s"] = time.monotonic() - t_data
    details["resnet50"] = resnet_phase(device, smi, x, y)
    vit_launches, details["vit_b16"] = vit_phase(device, smi, x, y)
    del x, y
    torch.cuda.empty_cache()
    details["phase11_s"] = time.monotonic() - t_phase
    log("phase 11 took {:.1f} s (image data {:.1f} s) [{}]".format(
        details["phase11_s"], details["image_data_s"], smi))
    return vit_launches, details


# -- phase 12: serving's fixed-shape path ------------------------------

# The decode block's kernels (`ops/decode_block.py`) at GPT-2 small's
# serving shapes: add_layer_norm over the tick's 8 rows and a 1024-row
# window; window_attention over windows of (rows, first position): a hit's
# 4-token suffix after 1008 cached positions, a miss's 16-token window, a
# chunk at 512; int8_page_write of one position of 8 slots (slot 3 dead).
DECODE_NORM_ROWS = (SLOTS, 1024)
DECODE_WINDOWS = ((4, 1008), (16, 0), (16, 512))


def check_decode_kernels(device):
    """The decode block's four kernels through their wrappers (launch
    counted) against their plain versions on the same inputs:
    add_layer_norm's y within NORM_TOL["bf16"] of the plain f32 y and h
    bit-equal to x + r; window_attention within FLASH_TOL["bf16"] of the
    plain bf16 output; int8_page_write's pages and scales and
    page_gather's cache bit-equal. Then each timed at its main shape (the
    tick's rows, a 16-token chunk at 512, the tick's 8 slots, a hit's
    1008 positions) beside its bound, its plain version and a library
    call (F.layer_norm of x + r, SDPA with the mask; none for the page
    write and the gather). Returns rows by kernel name."""
    import torch
    import torch.nn.functional as F
    from cloud_tpu_torch.ops import decode_block as db

    rng = np.random.default_rng(40)
    d_model = HEADS * HEAD_DIM
    rows_out = {}

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape,
                                                        dtype=np.float32),
                            dtype=dtype, device=device)

    # add_layer_norm
    w = randn(d_model, scale=0.1) + 1.0
    b = randn(d_model, scale=0.1)
    err = 0.0
    for rows in DECODE_NORM_ROWS:
        x = randn(rows, d_model, scale=3.0)
        r = randn(rows, d_model, dtype=torch.bfloat16)
        before = db.launches["add_layer_norm"]
        y, h = db.add_layer_norm(x, r, w, b, 1e-5, torch.bfloat16)
        torch.cuda.synchronize()
        if db.launches["add_layer_norm"] != before + 1:
            raise AssertionError("add_layer_norm did not launch")
        plain, plain_h = db.add_layer_norm_reference(x, r, w, b, 1e-5,
                                                     torch.float32)
        row = compare(y, plain, *NORM_TOL["bf16"])
        log("add_layer_norm (rows {}, D {}, f32 + bf16 -> bf16): of the "
            "bound (rtol {} + atol {} x row rms) {:.3f}; max abs err {:.3e}; "
            "h bit-equal {}".format(rows, d_model, *NORM_TOL["bf16"],
                                    row["tol_ratio"], row["max_abs_err"],
                                    torch.equal(h, plain_h)))
        if (not torch.equal(h, plain_h) or y.dtype != torch.bfloat16
                or not row["tol_ratio"] <= 1.0):
            raise AssertionError("add_layer_norm disagrees with its plain "
                                 "version: {}".format(row))
        err = max(err, row["max_abs_err"])
    x = randn(SLOTS, d_model, scale=3.0)
    r = randn(SLOTS, d_model, dtype=torch.bfloat16)
    cost = db.add_layer_norm_cost(SLOTS, d_model)
    row = rows_out["add_layer_norm"] = {
        "max_abs_err": err,
        "ms": timed_ms(lambda: db.add_layer_norm(x, r, w, b, 1e-5,
                                                 torch.bfloat16)),
        "plain_ms": timed_ms(lambda: db.add_layer_norm_reference(
            x, r, w, b, 1e-5, torch.bfloat16)),
        "library_ms": timed_ms(lambda: F.layer_norm(x + r, (d_model,), w, b,
                                                    1e-5))}
    row["bound_ms"], row["bound_by"] = bound_of(cost)

    # window_attention
    length = PAGES_PER_SLOT * PAGE
    cache = randn(2, length, HEADS, HEAD_DIM, dtype=torch.bfloat16)
    scale = 1.0 / HEAD_DIM ** 0.5
    tol = FLASH_TOL["bf16"]
    err = 0.0
    inputs = {}
    for rows, start in DECODE_WINDOWS:
        qkv = randn(rows, 3, HEADS, HEAD_DIM, dtype=torch.bfloat16)
        q = qkv[:, 0]
        keys = torch.arange(length, device=device)
        last = start + torch.arange(rows, device=device)
        bias = torch.where(keys[None, :] <= last[:, None], 0.0, -1e30)
        before = db.launches["window_attention"]
        out = db.window_attention(q, cache[0], cache[1], bias, scale)
        torch.cuda.synchronize()
        if db.launches["window_attention"] != before + 1:
            raise AssertionError("window_attention did not launch")
        plain = db.window_attention_reference(q, cache[0], cache[1], bias,
                                              scale)
        row = compare(out, plain, tol["rtol"], tol["atol"])
        log("window_attention (rows {} from {}, L {}, H {}, D {}, bf16): of "
            "the bound (rtol {} + atol {} x row rms) {:.3f}; max abs err "
            "{:.3e}".format(rows, start, length, HEADS, HEAD_DIM, tol["rtol"],
                            tol["atol"], row["tol_ratio"],
                            row["max_abs_err"]))
        if not torch.isfinite(out).all() or not row["tol_ratio"] <= 1.0:
            raise AssertionError("window_attention disagrees with its "
                                 "plain version: {}".format(row))
        err = max(err, row["max_abs_err"])
        inputs[(rows, start)] = (q, bias)
    q, bias = inputs[(16, 512)]
    qh, kh, vh = (q.transpose(0, 1)[None], cache[0].transpose(0, 1)[None],
                  cache[1].transpose(0, 1)[None])
    cost = db.window_attention_cost(16, length, HEADS, HEAD_DIM)
    row = rows_out["window_attention"] = {
        "max_abs_err": err,
        "ms": timed_ms(lambda: db.window_attention(q, cache[0], cache[1],
                                                   bias, scale)),
        "plain_ms": timed_ms(lambda: db.window_attention_reference(
            q, cache[0], cache[1], bias, scale)),
        "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias.to(torch.bfloat16), scale=scale))}
    row["bound_ms"], row["bound_by"] = bound_of(cost)

    # int8_page_write
    num_pages = SLOTS * PAGES_PER_SLOT + 1
    pages = torch.tensor(rng.integers(-127, 128, size=(
        2, num_pages, PAGE, HEADS, HEAD_DIM)), dtype=torch.int8, device=device)
    scales = torch.tensor(rng.uniform(0.0, 0.02, size=(2, num_pages, HEADS)),
                          dtype=torch.float32, device=device)
    scales[:, 5] = 0.0
    kv = randn(2, SLOTS, 1, HEADS, HEAD_DIM, dtype=torch.bfloat16,
               scale=2.0)
    phys = torch.tensor(1 + 9 * np.arange(SLOTS)[:, None], device=device)
    phys[2, 0] = 5
    off = torch.tensor(rng.integers(0, PAGE, size=(SLOTS, 1)), device=device)
    valid = torch.ones((SLOTS, 1), dtype=torch.bool, device=device)
    valid[3] = False
    got = (pages.clone(), scales.clone())
    want = (pages.clone(), scales.clone())
    before = db.launches["int8_page_write"]
    db.int8_page_write(*got, kv, phys, off, valid)
    torch.cuda.synchronize()
    if db.launches["int8_page_write"] != before + 1:
        raise AssertionError("int8_page_write did not launch")
    db.int8_page_write_reference(*want, kv, phys, off, valid)
    grown = int((got[1] != scales).sum())
    log("int8_page_write ({} slots, H {}, D {}, page {}): pages bit-equal "
        "{}, scales bit-equal {}; {} of {} page blocks rescaled".format(
            SLOTS, HEADS, HEAD_DIM, PAGE, torch.equal(got[0], want[0]),
            torch.equal(got[1], want[1]), grown, 2 * SLOTS * HEADS))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("int8_page_write differs from its plain "
                             "version")
    # Timed on the written pages: a repeat grows no scale, so the bound
    # counts no rescaled block.
    cost = db.int8_page_write_cost(SLOTS, HEADS, HEAD_DIM, PAGE)
    row = rows_out["int8_page_write"] = {
        "max_abs_err": 0.0,
        "ms": timed_ms(lambda: db.int8_page_write(*got, kv, phys, off,
                                                  valid)),
        "plain_ms": timed_ms(lambda: db.int8_page_write_reference(
            *want, kv, phys, off, valid)),
        "library_ms": None}
    row["bound_ms"], row["bound_by"] = bound_of(cost)
    # page_gather: a hit's 1008 positions (63 pages), fp and int8 pages.
    layers = GPT2_SMALL["num_layers"]
    gvec = torch.tensor(1 + rng.permutation(num_pages - 1)[:PAGES_PER_SLOT],
                        device=device)
    plen = torch.tensor(1008, device=device)
    out = torch.empty((layers, 2, 1, length, HEADS, HEAD_DIM),
                      dtype=torch.bfloat16, device=device)
    want = torch.empty_like(out)
    fp = randn(layers, 2, 64, PAGE, HEADS, HEAD_DIM, dtype=torch.bfloat16)
    q8 = torch.tensor(rng.integers(-127, 128, size=(
        layers, 2, 64, PAGE, HEADS, HEAD_DIM)), dtype=torch.int8,
        device=device)
    s8 = torch.tensor(rng.uniform(0.0, 0.02, size=(layers, 2, 64, HEADS)),
                      dtype=torch.float32, device=device)
    gvec = gvec % 64
    for label, pages, scales in (("bf16", fp, None), ("int8", q8, s8)):
        before = db.launches["page_gather"]
        db.page_gather(pages, scales, gvec, plen, out)
        torch.cuda.synchronize()
        if db.launches["page_gather"] != before + 1:
            raise AssertionError("page_gather did not launch")
        db.page_gather_reference(pages, scales, gvec, plen, want)
        log("page_gather ({} pages, {} layers, 1008 of {} positions): "
            "bit-equal {}".format(label, layers, length,
                                  torch.equal(out, want)))
        if not torch.equal(out, want):
            raise AssertionError("page_gather differs from its plain "
                                 "version ({} pages)".format(label))
    cost = db.page_gather_cost(layers, length, HEADS, HEAD_DIM, plen=1008)
    row = rows_out["page_gather"] = {
        "max_abs_err": 0.0,
        "ms": timed_ms(lambda: db.page_gather(fp, None, gvec, plen, out)),
        "plain_ms": timed_ms(lambda: db.page_gather_reference(
            fp, None, gvec, plen, want)),
        "library_ms": None}
    row["bound_ms"], row["bound_by"] = bound_of(cost)
    del fp, q8, out, want

    for name, row in rows_out.items():
        log("kernel {}: {:.4f} ms (bound {:.5f} ms by {}), plain {:.4f} ms, "
            "library {} ms; max abs err {:.3e}".format(
                name, row["ms"], row["bound_ms"], row["bound_by"],
                row["plain_ms"], row["library_ms"], row["max_abs_err"]))
    return rows_out



# Phase 12's replay check: ticks driven, and a request enters or leaves
# every REPLAY_EVERY ticks.
REPLAY_TICKS, REPLAY_EVERY = 30, 3


def replay_check(model, kv_dtype):
    """A replayed tick against an eager one, bit for bit: two engines on
    one model, one replaying CUDA graphs and one eager (graphs=False),
    driven through the same prefills (miss and prefix hit, greedy and
    sampled; the dense caches compared whole), inserts, ticks (the
    tokens and the [S, V] f32 logits compared) and evicts. Also counts
    the replayed engine's paged launches (layers x ticks) and holds its
    retrace sentinel after `warm`."""
    import torch
    from cloud_tpu_torch.ops.paged_attention import launches
    from cloud_tpu_torch.serving.engine import DecodeEngine

    name = "paged_attention_int8" if kv_dtype else "paged_attention"
    engines = [DecodeEngine(model, SLOTS, PAGE, SLOTS * PAGES_PER_SLOT + 1,
                            page_dtype=kv_dtype, graphs=graphs)
               for graphs in (None, False)]
    t0 = time.monotonic()
    captures = engines[0].warm(widths=[2 ** i for i in range(9)])
    capture_s = time.monotonic() - t0
    engines[0].mark_warm()
    rng = np.random.default_rng(12)
    root = rng.integers(0, model.vocab_size, size=100).tolist()
    greedy = dict(temperature=0.0, top_k=None, top_p=None, eos_token=None)
    sampled = dict(greedy, temperature=0.8, top_k=40)
    mism = {"prefill": 0, "tick": 0}
    launched = ticks = entered = 0
    resident = {}

    def enter(slot):
        nonlocal entered
        hit = entered % 3 == 2 and entered > 0
        if hit:
            prompt = root[:70] + rng.integers(
                0, model.vocab_size, size=int(rng.integers(5, 60))).tolist()
        else:
            prompt = (root if entered == 0 else rng.integers(
                0, model.vocab_size, size=int(rng.integers(16, 200)))
                .tolist())
        sampling = sampled if entered % 2 else greedy
        vec = 1 + slot * PAGES_PER_SLOT + np.arange(PAGES_PER_SLOT)
        kw = {}
        if hit:
            # The root's first four pages, resident in slot 0's table.
            shared = 1 + np.arange(4)
            kw = dict(prefix_len=64, gather_vec=shared)
            vec = np.concatenate([shared, vec[4:]])
        outs = [eng.prefill(prompt, 40, 100 + entered, sampling, **kw)
                for eng in engines]
        same = outs[0].first_token == outs[1].first_token and all(
            torch.equal(outs[0].pcache["store"][k], outs[1].pcache["store"][k])
            for k in outs[0].pcache["store"])
        mism["prefill"] += not same
        scatter = vec.copy()
        if hit:
            scatter[:4] = 0
        for eng, out in zip(engines, outs):
            eng.insert(slot, out, vec, scatter, sampling)
        resident[slot] = entered
        entered += 1

    for slot in range(SLOTS - 2):
        enter(slot)
    for t in range(REPLAY_TICKS):
        before = launches[name]
        got = engines[0].tick()
        launched += launches[name] - before
        ticks += 1
        want = engines[1].tick()
        same = np.array_equal(got, want) and torch.equal(
            engines[0]._tk["logits"], engines[1]._tk["logits"])
        mism["tick"] += not same
        done = [s for s in range(SLOTS) if got[1][s]]
        if t % REPLAY_EVERY == REPLAY_EVERY - 1:
            # A slot (not slot 0, whose pages the hits share) leaves,
            # and a request enters a free slot.
            live = [s for s in resident if s != 0]
            if live and not done:
                done = [live[t % len(live)]]
        if done:
            mask = np.zeros(SLOTS, bool)
            mask[done] = True
            for eng in engines:
                eng.evict(mask)
            for s in done:
                resident.pop(s, None)
        free = [s for s in range(1, SLOTS) if s not in resident]
        if t % REPLAY_EVERY == REPLAY_EVERY - 1 and free:
            enter(free[0])
    engines[0].check_no_retrace()
    out = {"kv_dtype": kv_dtype or "bf16", "ticks": ticks,
           "requests": entered, "launches": launched,
           "captures": captures, "capture_s": capture_s,
           "mismatched_ticks": mism["tick"],
           "mismatched_prefills": mism["prefill"]}
    log("replay check kv_dtype={!r}: {}".format(kv_dtype, json.dumps(out)))
    if mism["tick"] or mism["prefill"]:
        raise AssertionError(
            "replayed ticks/prefills differ from eager ones: {}".format(
                mism))
    if launched != model.num_layers * ticks:
        raise AssertionError(
            "{} launches {} over {} replayed ticks; expected {}".format(
                name, launched, ticks, model.num_layers * ticks))
    return out


def prefill_breakdown(model):
    """Where a prefill's time goes, on one engine (bf16, GPT-2 small): a
    1012-token miss (window 1024), a hit over 1008 cached positions
    (window 4), a 12-token miss (window 16), a 400-token miss (window
    512) and one intermediate 16-token chunk: the host wall of each
    call (median of 10) and, under torch.profiler, its device time and
    kernels."""
    import torch
    from cloud_tpu_torch.serving.engine import DecodeEngine

    engine = DecodeEngine(model, SLOTS, PAGE, SLOTS * PAGES_PER_SLOT + 1)
    greedy = dict(temperature=0.0, top_k=None, top_p=None, eos_token=None)
    engine.warm(widths=[4, 16, 512, 1024], chunk_sizes=[16])
    rng = np.random.default_rng(21)
    root = rng.integers(0, model.vocab_size, size=1008).tolist()
    vec = 1 + np.arange(PAGES_PER_SLOT)
    engine.insert(0, engine.prefill(root + [7, 8, 9, 10], 4, 0, greedy),
                  vec, vec, greedy)
    long = rng.integers(0, model.vocab_size, size=1012).tolist()
    calls = {
        "miss_1024": lambda: engine.prefill(long, 2, 0, greedy),
        "hit_4": lambda: engine.prefill(root + [1, 2, 3], 2, 0, greedy,
                                        prefix_len=1008,
                                        gather_vec=vec[:63]),
        "miss_16": lambda: engine.prefill(long[:12], 2, 0, greedy),
        "miss_512": lambda: engine.prefill(long[:400], 2, 0, greedy),
    }
    chunked = engine.prefill_chunks(long[:400], 2, 0, greedy, 16)
    chunked.step()
    calls["chunk_16"] = chunked.step
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, call in calls.items():
        host = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            result = call()
            torch.cuda.synchronize()
            host.append(time.monotonic() - t0)
            if result is not None:
                engine.release_prefill(result)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                result = call()
                if result is not None:
                    engine.release_prefill(result)
            torch.cuda.synchronize()
        kernels = [evt for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA]
        log("prefill kernels {} (per call: count, us): {}".format(
            name, kernel_table(prof, 3)))
        out[name] = {"host_ms": statistics.median(host) * 1e3,
                     "device_ms": sum(e.time_range.elapsed_us()
                                      for e in kernels) / 3e3,
                     "kernels": len(kernels) / 3}
    chunked.abandon()
    # Replayed windows against eager ones at the widths past the replay
    # check's (512, 1024): the last row's logits, bit for bit or not.
    eager = DecodeEngine(model, SLOTS, PAGE, SLOTS * PAGES_PER_SLOT + 1,
                         graphs=False)
    for name, prompt in (("miss_512", long[:400]), ("miss_1024", long)):
        rows = []
        for eng in (engine, eager):
            eng.release_prefill(eng.prefill(prompt, 2, 0, greedy))
            rows.append(eng._pf["row"].clone())
        out[name]["replay_row_max_abs_diff"] = float(
            (rows[0] - rows[1]).abs().max())
    log("prefill breakdown: {}".format(json.dumps(out)))
    return out


def window_judge(model, ref_model, kv_dtype):
    """Phase 12's bit-identity gate, measured: where served requests
    differ from their solo `generate()` (a hit's or a chunk's window has
    another shape than the solo prefill's, so cuBLAS may sum a row in
    another order), each of them must be greedy, and the leg's greedy
    tokens must pass phase 5's teacher-forced f32 gate (LOGIT_MARGIN,
    MIN_EXACT over all of them). Reports the count and, at the first
    differing step, |delta logit| between the served and the solo token
    in the f32 forward."""
    import torch

    def judge(label, requests, results, oracle):
        bad = [i for i, (res, ref) in enumerate(zip(results, oracle))
               if not np.array_equal(res.tokens, ref)]
        details = {"mismatched": bad}
        if not bad:
            return [], details
        failures = []
        exact = total = 0
        worst = first_delta = 0.0
        for i, (req, res) in enumerate(zip(requests, results)):
            if req.temperature:
                if i in bad:
                    failures.append("{}: sampled request {} differs from "
                                    "solo generate()".format(label, i))
                continue
            p = len(req.prompt)
            tokens = torch.as_tensor(res.tokens, device=model.device)[None]
            with torch.no_grad():
                logits = ref_model(tokens, None, ref_model.init_cache(1))[0]
            rows = logits[p - 1:p - 1 + req.max_new_tokens]
            served = tokens[0, p:]
            chosen = rows.gather(1, served[:, None])[:, 0]
            worst = max(worst, float((rows.max(dim=1).values
                                      - chosen).max()))
            exact += int((rows.argmax(dim=1) == served).sum())
            total += req.max_new_tokens
            if i in bad:
                k = int(np.flatnonzero(res.tokens[p:] != oracle[i][p:])[0])
                first_delta = max(first_delta, abs(float(
                    rows[k, int(res.tokens[p + k])]
                    - rows[k, int(oracle[i][p + k])])))
        share = exact / total if total else 1.0
        if worst > LOGIT_MARGIN[kv_dtype] or share < MIN_EXACT:
            failures.append(
                "{}: requests {} differ from solo generate() and the "
                "served tokens fail the teacher-forced gate (worst gap "
                "{:.4f}, margin {}; exact share {:.4f}, need {})".format(
                    label, bad, worst, LOGIT_MARGIN[kv_dtype], share,
                    MIN_EXACT))
        details.update(worst_gap=worst, exact_share=share,
                       first_step_delta_logit=first_delta)
        log("{} kv_dtype={!r}: {} of {} requests differ from solo "
            "generate(); teacher-forced over the leg's greedy requests: "
            "{}".format(label, kv_dtype, len(bad), len(requests), details))
        return failures, details
    return judge


def serving_scenarios(device):
    """Phase 12's scenarios: `serving/smoke.py`'s base, prefix and
    chunked for both page dtypes at GPT-2 small's full width (random
    weights, seed 0), judged by `window_judge`. Returns (the launches of
    the paged and decode-block kernels over the scenarios, the summaries
    by name, the failures)."""
    import torch
    from cloud_tpu_torch.models import TransformerLM
    from cloud_tpu_torch.ops import decode_block, paged_attention  # noqa
    from cloud_tpu_torch.serving import smoke

    pa = sys.modules["cloud_tpu_torch.ops.paged_attention"]
    model = TransformerLM(compute_dtype=torch.bfloat16, device=device,
                          seed=0, **GPT2_SMALL)
    ref_model = TransformerLM(compute_dtype=torch.float32, device=device,
                              seed=0, **GPT2_SMALL)
    ref_model.load_state_dict(model.state_dict())
    scenarios, failures = {}, []
    pa.reset_launches()
    decode_block.reset_launches()
    for kv in ("", "int8"):
        judge = window_judge(model, ref_model, kv)
        for name, run in (("base", smoke.run_base),
                          ("prefix", smoke.run_prefix),
                          ("chunked", smoke.run_chunked)):
            t1 = time.monotonic()
            summary = run(model, kv_dtype=kv, judge=judge)
            log("phase 12 {} {}: {}".format(name, kv or "bf16", json.dumps(
                {k: v for k, v in summary.items()
                 if not isinstance(v, (dict, list))})))
            summary["seconds"] = time.monotonic() - t1
            scenarios["{}_{}".format(name, kv or "bf16")] = summary
            failures += ["{} {}: {}".format(name, kv or "bf16", f)
                         for f in summary["failures"]]
            for warning in summary["warnings"]:
                log("phase 12 {} {}: WARN {}".format(name, kv or "bf16",
                                                      warning))
    return dict(pa.launches, **decode_block.launches), scenarios, failures


def scenarios_in_child(root):
    """`serving_scenarios` in a process of its own (`python3
    chip_smoke.py --phase12-scenarios PATH`), as a server runs: nothing
    of the earlier phases (the profiler's hooks, the allocator's cache,
    the heap) weighs on the scenarios' same-rig ratios, which read host
    latencies of a millisecond or so. Relays its log; returns its JSON."""
    path = os.path.join(root, "build", "chip_smoke_scenarios.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase12-scenarios",
         path], cwd=root, capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        log("  " + line)
    if proc.returncode != 0 or not os.path.exists(path):
        raise AssertionError(
            "phase 12's scenarios failed in their own process (exit {}):"
            "\n{}".format(proc.returncode, proc.stderr[-4000:]))
    with open(path) as f:
        return json.load(f)


def serving_phase(device, smi, root):
    """Phase 12: serving's fixed-shape path at GPT-2 small's full width
    (random weights, seed 0): the replay check for both page dtypes, the
    tick eager and replayed, a prefill breakdown, then (in a process of
    their own, `scenarios_in_child`) `serving/smoke.py`'s base, prefix
    and chunked scenarios for both page dtypes. Returns (the kernels'
    launches over the scenarios, summary); the summary's "failures" fail
    the phase (`raise_if_failed`)."""
    import torch
    from cloud_tpu_torch.models import TransformerLM

    t0 = time.monotonic()
    model = TransformerLM(compute_dtype=torch.bfloat16, device=device,
                          seed=0, **GPT2_SMALL)
    out = {"nvidia_smi": smi,
           "replay": [replay_check(model, kv) for kv in ("", "int8")],
           "tick": tick_breakdowns(model),
           "tick_int8": tick_breakdown(model, kv_dtype="int8"),
           "prefill": prefill_breakdown(model)}
    del model
    torch.cuda.empty_cache()
    child = scenarios_in_child(root)
    out["scenarios"] = child["scenarios"]
    failures = child["failures"]
    out["seconds"] = time.monotonic() - t0
    for kv in ("bf16", "int8"):
        base = out["scenarios"]["base_" + kv]
        prefix = out["scenarios"]["prefix_" + kv]
        chunked = out["scenarios"]["chunked_" + kv]
        log("phase 12 ({}; {}): base {:.1f} tokens/s against "
            "batch-synchronous {:.1f} ({:.2f}x); TTFT p50/p99 hit "
            "{:.4f}/{:.4f} s, off {:.4f}/{:.4f} s ({:.2f}x); decode-gap "
            "p99 chunked {:.4f} s, unchunked {:.4f} s ({:.2f}x); warm-up "
            "captures {} in {:.2f} s (base)".format(
                kv, smi, base["serve_tokens_per_sec"],
                base["baseline_tokens_per_sec"], base["speedup"],
                prefix["ttft_hit_p50_s"], prefix["ttft_hit_p99_s"],
                prefix["ttft_off_p50_s"], prefix["ttft_off_p99_s"],
                prefix["ttft_ratio"], chunked["decode_gap_p99_chunked_s"],
                chunked["decode_gap_p99_unchunked_s"],
                chunked["decode_gap_ratio"], base["captures"],
                base["capture_seconds"]))
    tick = out["tick"]
    log("phase 12 ({}): tick p50 eager {:.3f} ms, replayed {:.3f} ms; "
        "{:.1f} / {:.1f} tokens/s, busy under the profiler {} / {}; "
        "{:.1f} s".format(
            smi, tick["eager"]["tick_p50_ms"],
            tick["replayed"]["tick_p50_ms"], tick["eager"]["tokens_per_s"],
            tick["replayed"]["tokens_per_s"],
            tick["eager"]["device_busy_share"],
            tick["replayed"]["device_busy_share"], out["seconds"]))
    out["launches"] = child["launches"]
    out["failures"] = failures
    return child["launches"], out


def raise_if_failed(serving):
    """Phase 12 fails on any of its scenarios' failures (raised after
    the run's details are written)."""
    if serving["failures"]:
        raise AssertionError("phase 12 failed: {}".format(
            "; ".join(serving["failures"])))


def llama_gate_seeds(seeds, out_path):
    """Phase 7's fit alone (`llama_data`, `llama_fit`; no other check),
    once per data seed, on the `cloud_tpu_torch` that is first on
    sys.path: per seed the loss of every epoch, the entropy of the next
    token given the current one, the cycle level, the gate, and the
    first epoch whose loss lies half a nat below the cycle level (the
    plateau left). Writes them as JSON to `out_path`."""
    import torch
    from cloud_tpu_torch.models import TINYLLAMA_1_1B, LlamaLM
    from cloud_tpu_torch.ops import _build

    _build.build(_build.sources())
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    for seed in seeds:
        torch.cuda.empty_cache()
        model = LlamaLM(compute_dtype=torch.bfloat16,
                        device=torch.device("cuda"), seed=0,
                        **TINYLLAMA_1_1B)
        data = llama_data(seed, model.vocab_size)
        trainer, history, _, fit_s = llama_fit(model, data["x"], data["y"])
        losses, cycle = history["loss"], data["cycle"]
        left = [i + 1 for i, v in enumerate(losses) if v < cycle - 0.5]
        run = {"seed": seed, "losses": losses, "entropy": data["entropy"],
               "cycle_level": cycle, "gate": data["gate"],
               "passes": llama_gate_passes(losses, data["gate"]),
               "plateau_left_epoch": left[0] if left else None,
               "fit_s": fit_s}
        log("llama gate seed {}: {}".format(seed, json.dumps(run)))
        runs.append(run)
        del trainer, model
    with open(out_path, "w") as f:
        json.dump({"nvidia_smi": nvidia_smi_line(), "runs": runs}, f,
                  indent=1)
    return 0


FLASH_TIMES_SHAPES = {"gpt2": (8, 1024, 12, 12, 64),
                      "tinyllama": (LLAMA_BATCH, LLAMA_SEQ, 32, 4, 64),
                      "gemma2": GEMMA2_ATTENTION}


def flash_times(out_path):
    """The three flash kernels alone (CUDA-graph replays, bf16, causal)
    at GPT-2's, TinyLlama's and Gemma-2's shapes, on the port that is
    first on sys.path; written as JSON to `out_path`."""
    import torch
    from cloud_tpu_torch.ops import _build
    from cloud_tpu_torch.ops import attention as tatt

    _build.build(["flash_attention"])
    device = torch.device("cuda")
    rng = np.random.default_rng(11)
    out = {"nvidia_smi": nvidia_smi_line()}
    for name, shape in FLASH_TIMES_SHAPES.items():
        q, k, v, dout, _ = flash_inputs(rng, "bf16", shape, None, device)
        config = (True, 1.0 / np.sqrt(shape[-1]), 0, 0.0)
        o, lse = tatt._launch_forward(q, k, v, None, config)
        delta = tatt._delta(dout, o)
        out[name] = {
            "flash_attention_fwd": timed_ms(lambda: tatt._launch_forward(
                q, k, v, None, config)),
            "flash_attention_dq": timed_ms(lambda: tatt._launch_dq(
                q, k, v, None, dout, lse, delta, config)),
            "flash_attention_dkdv": timed_ms(lambda: tatt._launch_dkdv(
                q, k, v, None, dout, lse, delta, config))}
        log("flash times {} {}: {}".format(name, shape, json.dumps(
            out[name])))
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    return 0


def main():
    t_start = time.monotonic()
    import torch

    if "--flash-times" in sys.argv:
        # python3 chip_smoke.py --flash-times TREE OUT: the flash kernels'
        # times on the port in TREE (e.g. an earlier commit unpacked by
        # `git archive`), for comparing two trees on one card.
        tree, out_path = sys.argv[sys.argv.index("--flash-times") + 1:][:2]
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device available", file=sys.stderr)
            return 2
        sys.path.insert(0, os.path.abspath(tree))
        return flash_times(out_path)

    if "--llama-gate" in sys.argv:
        # python3 chip_smoke.py --llama-gate TREE SEEDS OUT: phase 7's fit
        # on the port in TREE (a checkout, e.g. an earlier commit unpacked
        # by `git archive`) over the comma-separated data seeds.
        tree, seeds, out_path = sys.argv[sys.argv.index("--llama-gate")
                                         + 1:][:3]
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device available", file=sys.stderr)
            return 2
        sys.path.insert(0, os.path.abspath(tree))
        return llama_gate_seeds([int(s) for s in seeds.split(",")],
                                out_path)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "cloud_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(cloud_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from cloud_tpu_torch.models import TransformerLM
    from cloud_tpu_torch.ops import _build

    t_build = time.monotonic()
    _build.build(_build.sources())
    build_s = time.monotonic() - t_build
    log("built {} in {:.1f} s ({})".format(
        _build.sources(), build_s, ", ".join(
            "{} {:.1f} s".format(n, t)
            for n, t in sorted(_build.build_seconds.items()))))
    for name, report in _build.build_logs.items():
        for line in report.splitlines():
            if ("registers" in line or "spill" in line
                    or "warning" in line.lower()):
                log("ptxas {}: {}".format(name, line.strip()))

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device: {} x{}".format(torch.cuda.get_device_name(0),
                                torch.cuda.device_count()))
    log("nvidia-smi: {}".format(smi))
    # f32 products in full f32 (TF32 off) for the whole run: the plain
    # versions the kernels are held against, and the f32 MLP backward that
    # the training phases time, as the JAX code computes it.
    torch.backends.cuda.matmul.allow_tf32 = False

    if "--phase11" in sys.argv:
        # python3 chip_smoke.py --phase11: the build, the ViT flash check
        # and phase 11 alone (no contract line).
        _, vit_check = check_flash_kernels(device, names=("vit_b16_bf16",))
        vit_rows = time_flash_kernels(device, VIT_ATTENTION, causal=False)
        vit_launches, images = image_phase(device, smi)
        os.makedirs(os.path.join(root, "build"), exist_ok=True)
        with open(os.path.join(root, "build", "chip_smoke_phase11.json"),
                  "w") as f:
            json.dump({"nvidia_smi": smi, "flash_check": vit_check,
                       "vit_launches": vit_launches, "images": images,
                       "flash_timing_vit_b16": vit_rows,
                       "run_s": time.monotonic() - t_start}, f, indent=1,
                      default=str)
        log("phase 11 alone: whole run {:.1f} s".format(
            time.monotonic() - t_start))
        return 0

    if "--phase12-scenarios" in sys.argv:
        # The scenarios alone, for serving_phase (no contract line).
        path = sys.argv[sys.argv.index("--phase12-scenarios") + 1]
        launches, scenarios, failures = serving_scenarios(device)
        with open(path, "w") as f:
            json.dump({"launches": launches, "scenarios": scenarios,
                       "failures": failures}, f, indent=1, default=str)
        return 0

    if "--phase12" in sys.argv:
        # python3 chip_smoke.py --phase12: the build, the paged and
        # decode-block kernels' checks and phase 12 alone (no contract
        # line).
        rows = check_kernels(device)
        rows.update(check_decode_kernels(device))
        _, serving = serving_phase(device, smi, root)
        os.makedirs(os.path.join(root, "build"), exist_ok=True)
        with open(os.path.join(root, "build", "chip_smoke_phase12.json"),
                  "w") as f:
            json.dump({"nvidia_smi": smi, "kernels": rows,
                       "serving": serving,
                       "run_s": time.monotonic() - t_start}, f, indent=1,
                      default=str)
        log("phase 12 alone: whole run {:.1f} s".format(
            time.monotonic() - t_start))
        raise_if_failed(serving)
        return 0

    rows = check_kernels(device)
    rows.update(check_decode_kernels(device))
    flash_err, flash_details = check_flash_kernels(device)
    flash_rows = time_flash_kernels(device)
    flash_rows_llama = time_flash_kernels(device, (LLAMA_BATCH, LLAMA_SEQ,
                                                   32, 4, 64))
    flash_rows_gemma = time_flash_kernels(device, GEMMA2_ATTENTION)
    flash_rows_phi3 = time_flash_kernels(device, PHI3_ATTENTION)
    flash_rows_phi2 = time_flash_kernels(device, PHI2_ATTENTION)
    flash_rows_qwen3 = time_flash_kernels(device, QWEN3_ATTENTION)
    flash_rows_deepseek = time_flash_kernels(device, DEEPSEEK_V4_ATTENTION)
    flash_rows_vit = time_flash_kernels(device, VIT_ATTENTION, causal=False)
    norm_rows, norm_details = check_norm_kernels(device)
    mlp_rows, mlp_details = check_mlp_kernels(device)

    model = TransformerLM(compute_dtype=torch.bfloat16, device=device,
                          seed=0, **GPT2_SMALL)
    ref_model = TransformerLM(compute_dtype=torch.float32, device=device,
                              seed=0, **GPT2_SMALL)
    ref_model.load_state_dict(model.state_dict())
    launches_fp, serve_fp = serve(model, ref_model, 16, 4, "", seed=1)
    launches_q, serve_q = serve(model, ref_model, 8, 2, "int8", seed=2)
    breakdown = tick_breakdowns(model)
    del model, ref_model
    torch.cuda.empty_cache()
    flash_launches, training = train(device)
    llama_launches, llama_training, llama, llama_data_ = train_llama(device)
    gen_launches, gen_rows, generation = generate_llama(llama, llama_data_,
                                                        device)
    del llama
    torch.cuda.empty_cache()
    qwen3_norm_rows = norm_rows_at(device, QWEN3_BATCH * LLAMA_SEQ)
    qwen3_launches, qwen3_training, qwen3, qwen3_data = train_qwen3(device)
    qwen3_gen_launches, _, qwen3_generation = generate_qwen3(
        qwen3, qwen3_data, device)
    del qwen3
    torch.cuda.empty_cache()
    t_phase10 = time.monotonic()
    head_loss = check_lm_head_loss()
    loop = training_loop(device, root)
    loop["phase10_s"] = time.monotonic() - t_phase10
    log("phase 10 took {:.1f} s".format(loop["phase10_s"]))
    vit_launches, images = image_phase(device, smi)
    t_phase12 = time.monotonic()
    graph_launches, serving = serving_phase(device, smi, root)
    log("phase 12 took {:.1f} s".format(time.monotonic() - t_phase12))

    # One row per kernel and path that launches it: the launches counted
    # from 0 around that path's run, the times and errors at its shape.
    # The flash kernels run on both training paths, so they have a row
    # for each.
    entries = [
        ("paged_attention", "paged_attention.cu", "paged_attention.py:164",
         "serve_fp", launches_fp["paged_attention"],
         rows["paged_attention"]),
        ("paged_attention_int8", "paged_attention.cu",
         "paged_attention.py:207", "serve_int8",
         launches_q["paged_attention_int8"], rows["paged_attention_int8"]),
        # Phase 12: inside the replayed ticks of the serving scenarios.
        ("paged_attention", "paged_attention.cu", "paged_attention.py:164",
         "serve_graph", graph_launches["paged_attention"],
         rows["paged_attention"]),
        ("paged_attention_int8", "paged_attention.cu",
         "paged_attention.py:207", "serve_graph",
         graph_launches["paged_attention_int8"],
         rows["paged_attention_int8"])]
    # The decode block's kernels replace no Pallas kernel: XLA fuses
    # these steps of JAX's decode forward (the LayerNorms with the
    # residual adds, `_decode_attention`, the int8 page write).
    decode_kernels = (
        ("add_layer_norm", "models/transformer.py:307",
         ("serve_fp", launches_fp), ("serve_int8", launches_q),
         ("serve_graph", graph_launches)),
        ("window_attention", "models/transformer.py:86",
         ("serve_graph", graph_launches)),
        ("int8_page_write", "models/transformer.py:246",
         ("serve_int8", launches_q), ("serve_graph", graph_launches)),
        ("page_gather", "serving/engine.py:852",
         ("serve_fp", launches_fp), ("serve_int8", launches_q),
         ("serve_graph", graph_launches)))
    for name, replaces, *paths in decode_kernels:
        for path, launched in paths:
            entries.append((name, "decode_block.cu", replaces, path,
                            launched[name], rows[name]))
    loop_launches = {k: loop["launches_u"][k] + loop["launches_r"][k]
                     for k in loop["launches_u"]}
    for path, times, launched in (
            ("gpt2_train", flash_rows, flash_launches),
            ("gpt2_loop", flash_rows, loop_launches),
            ("tinyllama_train", flash_rows_llama, llama_launches),
            ("qwen3moe_train", flash_rows_qwen3, qwen3_launches),
            ("vit_train", flash_rows_vit, vit_launches)):
        for name, line in (("flash_attention_fwd", "179"),
                           ("flash_attention_dq", "345"),
                           ("flash_attention_dkdv", "383")):
            entries.append((name, "flash_attention.cu", "attention.py:" + line,
                            path, launched[name],
                            dict(times[name],
                                 max_abs_err=flash_err[
                                     "gpt2_train" if path == "gpt2_loop"
                                     else path][name])))
    for name, source, replaces, table in (
            ("fused_norm", "fused_norm.cu", "fused_norm.py:70", norm_rows),
            ("fused_norm_noresidual", "fused_norm.cu", "fused_norm.py:70",
             norm_rows),
            ("fused_mlp_gate_up", "fused_mlp.cu", "fused_mlp.py:96",
             mlp_rows),
            ("fused_mlp_down", "fused_mlp.cu", "fused_mlp.py:96", mlp_rows)):
        entries.append((name, source, replaces, "tinyllama_train",
                        llama_launches[name], table[name]))
        entries.append((name, source, replaces, "tinyllama_generate",
                        gen_launches[name], gen_rows[name]))
    # The MoE path runs the norm kernels alone (its experts are plain
    # products): training at rows 2 x 2048, generate at decode rows 8 x
    # D 2048, the shape phase 8 timed.
    for name in ("fused_norm", "fused_norm_noresidual"):
        entries.append((name, "fused_norm.cu", "fused_norm.py:70",
                        "qwen3moe_train", qwen3_launches[name],
                        qwen3_norm_rows[name]))
        entries.append((name, "fused_norm.cu", "fused_norm.py:70",
                        "qwen3moe_generate", qwen3_gen_launches[name],
                        gen_rows[name]))
    kernels = [{
        "name": name, "route": "cuda",
        "source": "cloud_tpu_torch/ops/csrc/" + source,
        "replaces": ("cloud_tpu/" if replaces.startswith(("models/",
                                                           "serving/"))
                     else "cloud_tpu/ops/") + replaces, "path": path,
        "launches": launches, "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"]}
        for name, source, replaces, path, launches, row in entries]
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()}
    run_s = time.monotonic() - t_start
    log("whole run {:.1f} s, build {:.1f} s of it".format(run_s, build_s))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with open(os.path.join(root, "build", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "device": device_info,
                   "run_s": run_s, "build_s": build_s,
                   "kernels": kernels, "serve": [serve_fp, serve_q],
                   "tick_breakdown": breakdown,
                   "flash_checks": flash_details,
                   "flash_timing": flash_rows,
                   "flash_timing_tinyllama": flash_rows_llama,
                   "flash_timing_gemma2": flash_rows_gemma,
                   "flash_timing_phi3": flash_rows_phi3,
                   "flash_timing_phi2": flash_rows_phi2,
                   "flash_timing_qwen3moe": flash_rows_qwen3,
                   "flash_timing_deepseek_v4_d512": flash_rows_deepseek,
                   "flash_timing_vit_b16": flash_rows_vit,
                   "norm_checks": norm_details, "mlp_checks": mlp_details,
                   "training": training, "llama_training": llama_training,
                   "llama_generate": generation,
                   "qwen3moe_training": qwen3_training,
                   "qwen3moe_generate": qwen3_generation,
                   "qwen3moe_norm_rows": qwen3_norm_rows,
                   "lm_head_loss": head_loss, "training_loop": loop,
                   "images": images, "serving_graphs": serving,
                   "build_logs": _build.build_logs}, f,
                  indent=1, default=str)
    raise_if_failed(serving)
    idle = ["{} on {}".format(k["name"], k["path"]) for k in kernels
            if not k["launches"]]
    if idle:
        raise AssertionError("kernels launched no time on their path: "
                             "{}".format(", ".join(idle)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
