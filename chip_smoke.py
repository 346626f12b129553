#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one CUDA card.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

It builds the port's CUDA kernels from `cloud_tpu_torch/ops/csrc/`
(nvcc, sm_90a, into the gitignored `build/`), then:

1. prints the card (torch's name, and nvidia-smi's name and power
   limit);
2. holds each kernel against its plain PyTorch version on the card at
   the served shapes (slots 8, H 12, D 64, page 16, 64 pages per slot,
   bf16; seq 1 and 4; shared pages, an evicted slot, garbage in the
   scratch page; int8 pages with a zero-scale page), requires exact
   zeros on masked rows, and times kernel, plain version, bound and
   the library yardstick (gathered view + scaled_dot_product_attention,
   which the port never calls);
3. serves 16 requests through `Scheduler` on GPT-2 small (random
   weights from a seed), with fp pages; checks that every tick went
   through the kernel, that sampled requests equal solo `generate()`
   and that greedy tokens agree with an f32 teacher-forced forward;
4. does the same with int8 pages and 8 requests, then times 20 ticks
   of a full engine under torch.profiler (device busy share);
5. prints the kernel table as one JSON line, the card line, and the
   contract line `{"ok": true, "device": {...}}` last.

Any failure raises and exits non-zero. Without a CUDA card, or without
the rest of the repository beside it, it exits non-zero before
printing any result. Details go to build/chip_smoke.json.
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


# -- phases 3 and 4: serving -----------------------------------------

def serve(model, ref_model, n_requests, n_sampled, kv_dtype, seed):
    import torch
    from cloud_tpu_torch.models import generate
    from cloud_tpu_torch.ops import paged_attention as _  # noqa: F401
    from cloud_tpu_torch.serving import Scheduler, ServeRequest

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
        t0 = time.monotonic()
        futures = [sched.submit(r) for r in requests]
        results = [f.result(timeout=600) for f in futures]
        wall = time.monotonic() - t0
        launches = dict(pa.launches)
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
    log("serve kv_dtype={!r}: {} requests, {} ticks, {} launches, "
        "{:.1f} tokens/s, TTFT p50 {:.4f} s p99 {:.4f} s".format(
            kv_dtype, n_requests, ticks, launches[name],
            summary["tokens_per_s"], summary["ttft_p50_s"],
            summary["ttft_p99_s"]))
    return launches[name], summary


def tick_breakdown(model):
    """One engine with all 8 slots decoding (128-token prompts): the
    host wall time of 20 ticks, and under torch.profiler the device time
    of all kernels and of the paged-attention kernel. Returns a dict;
    device figures are None when the profiler reports no device time."""
    import torch
    from cloud_tpu_torch.serving.engine import DecodeEngine

    engine = DecodeEngine(model, SLOTS, PAGE, SLOTS * PAGES_PER_SLOT + 1)
    greedy = dict(temperature=0.0, top_k=None, top_p=None, eos_token=None)
    rng = np.random.default_rng(3)
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
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / ticks
    device_us = attn_us = 0.0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = evt.time_range.elapsed_us()
        device_us += dev
        if "paged_attention_kernel" in evt.name:
            attn_us += dev
    out = {"tick_ms": wall_ms, "device_ms_per_tick": None,
           "attention_ms_per_tick": None, "device_busy_share": None}
    if device_us > 0:
        out.update(device_ms_per_tick=device_us / 1e3 / ticks,
                   attention_ms_per_tick=attn_us / 1e3 / ticks,
                   device_busy_share=device_us / 1e3 / ticks / wall_ms)
    log("tick breakdown (8 slots, depth 128-192, under the profiler): "
        "{}".format(json.dumps(out)))
    return out


def main():
    import torch

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
    log("built {} in {:.1f} s".format(_build.sources(),
                                      time.monotonic() - t_build))
    for name, report in _build.build_logs.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas {}: {}".format(name, line.strip()))

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device: {} x{}".format(torch.cuda.get_device_name(0),
                                torch.cuda.device_count()))
    log("nvidia-smi: {}".format(smi))

    rows = check_kernels(device)

    model = TransformerLM(compute_dtype=torch.bfloat16, device=device,
                          seed=0, **GPT2_SMALL)
    ref_model = TransformerLM(compute_dtype=torch.float32, device=device,
                              seed=0, **GPT2_SMALL)
    ref_model.load_state_dict(model.state_dict())
    launches_fp, serve_fp = serve(model, ref_model, 16, 4, "", seed=1)
    launches_q, serve_q = serve(model, ref_model, 8, 2, "int8", seed=2)
    breakdown = tick_breakdown(model)

    source = "cloud_tpu_torch/ops/csrc/paged_attention.cu"
    kernels = []
    for name, replaces, launches in (
            ("paged_attention", "cloud_tpu/ops/paged_attention.py:164",
             launches_fp),
            ("paged_attention_int8",
             "cloud_tpu/ops/paged_attention.py:207", launches_q)):
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()}
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with open(os.path.join(root, "build", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "device": device_info,
                   "kernels": kernels, "serve": [serve_fp, serve_q],
                   "tick_breakdown": breakdown}, f,
                  indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
