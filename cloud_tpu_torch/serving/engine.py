"""Serving decode engine: a slot-indexed continuous decode tick over a
paged KV pool; the port of `cloud_tpu/serving/engine.py`'s
`DecodeEngine`, `ChunkedPrefill` and `chunk_plan`.

A tick advances every active slot by one token: one decode-mode forward
of the model over the paged cache (each layer's attention is
`ops.paged_attention`, the CUDA kernel on the card), one sampler pass,
one counted device->host fetch of the sampled tokens. Requests enter
mid-flight: a dense canonical right-pad prefill is scattered into a free
slot's pages by `insert`, and leave mid-flight: `evict` zeros the
finished slots' page-table and validity rows.

Fixed shapes, as JAX's executables: on a card the tick is ONE CUDA
graph (the engine's geometry: its slot count and page dtype), and the
prefills are graphs of fixed width that read and write static buffers:

- "gather": seeds the static dense cache from pool pages (`prefix_len`
  positions of `gather_vec`, int8 pages dequantized by their scales;
  a miss gathers 0 positions, which zeroes the cache);
- ("window", W): a W-token window through that cache, keeping the f32
  logits of the last real position alone (found by a device index) and
  their argmax: a whole prefill, or the tail of a chunked one;
- ("chunk", C): a C-token window that only advances the cache (the
  intermediate chunks of a chunked prefill).

Every state update on these paths happens in place (the caches'
pointers are device tensors, `decoding.dense_slot_update` /
`paged_slot_update`), so a replay runs at whatever depth its inputs
hold: one window graph serves a miss and a prefix-hit suffix that starts
mid-cache. Each graph is captured once (after one warm run that builds
the kernels, makes cuBLAS's handles and fills the weight-cast memo;
`warm()` captures them all before traffic); `mark_warm()` then arms
the retrace sentinel: a later capture or kernel build is a
`RetraceError` under `check_no_retrace()`. On the card a path that
cannot be captured raises; elsewhere the same bodies run eagerly.
`graphs=False` runs them eagerly on the card too (the yardstick a
replay is held to).

The sampler stays out of the graphs: greedy rows read the captured
argmax, and rows with temperature > 0 are drawn after the replay by
`decoding.sample_one` / `sample_slots`, the draws `generate()` makes,
so a request decoded through the engine produces the tokens
`models.transformer.generate()` produces for it solo with the same
seed. The kernels' wrappers count their launches in Python, which a
replay does not run: the engine records the launches a capture saw and
adds them once per replay.

Prefills of the two threads share the static buffers under one lock; a
prefill's dense cache is copied out of them into a cache of
`decoding.acquire_cache` that its `PrefillResult` owns until `insert`
scatters it. On the card prefills run on a stream of their own, which
first waits for the inserts queued so far: a hit's gather reads shared
pages, each written once, by the insert of the request that registered
it. A whole prefill then holds the tick back until it is done (as one
executable holds a TPU); a chunk step runs beside the next tick (`tick`
is `tick_launch`, then `tick_collect`), the two graphs captured on
separate streams so that they hold separate cuBLAS workspaces. A chunked prefill's state stays in the
static cache between its chunks, and is copied out and back when
another prefill runs in between. The host sides of the steps' inputs
are pinned, so staging them queues a copy without waiting for the
device.

Speculation, ladder resize, fault requeue (`key_override`) and the host
page tier are not ported: their arguments and methods raise
NotImplementedError, naming their ROADMAP item.
"""

import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from cloud_tpu_torch.models import decoding
from cloud_tpu_torch.monitoring import spans
from cloud_tpu_torch.ops import decode_block
from cloud_tpu_torch.parallel import runtime

_captures = [0]


def _launch_counters():
    """The launch counters of the kernels a step can reach (each
    wrapper counts in Python, which a replay does not run)."""
    from cloud_tpu_torch.ops.decode_block import launches as block
    from cloud_tpu_torch.ops.paged_attention import launches as paged

    return (paged, block)


def retrace_count():
    """{"captures", "builds"}: this process's serving graph captures and
    kernel builds, the counts the retrace sentinel watches."""
    from cloud_tpu_torch.ops import _build

    return {"captures": _captures[0], "builds": _build.build_count()}


class RetraceError(RuntimeError):
    """The warm engine captured a graph or built a kernel after
    `mark_warm()`: a shape the warm-up did not cover reached the
    serving path (the retrace sentinel)."""


@dataclasses.dataclass
class PrefillResult:
    """A prefilled request waiting for slot insertion."""
    first_token: int        # drawn from the prompt's last position
    pcache: object          # dense [1, L] decode cache it owns (device)
    step_seeds: np.ndarray  # [max_new_cap] int64; entry i seeds step i
    bucket: int             # pow2 SUFFIX bucket the prefill ran at
    n_steps: int            # max_new_tokens for this request
    prompt_len: int         # full prompt length (prefix + suffix)
    t_first: float = 0.0    # time.monotonic() when first_token reached the host
    ready: object = None    # on the card: an event after pcache's copy


def chunk_plan(n_suffix, chunk_size, max_seq_len):
    """Chunk layout for an `n_suffix`-token prefill at fixed chunk
    width `chunk_size`: `(n_full, tail, tail_bucket)`: `n_full` full
    chunks of `chunk_size` real tokens, then one tail chunk of `tail`
    in [1, chunk_size] real tokens run at the pow2 `tail_bucket` width
    (the window graph a whole prefill of a short suffix runs). With
    `chunk_size` a power of two the written extent `n_full *
    chunk_size + tail_bucket` never exceeds `bucket_length(n_suffix)`,
    so the whole prefill's in-cache check also bounds the chunked
    writes."""
    n_full = (n_suffix - 1) // chunk_size
    tail = n_suffix - n_full * chunk_size
    return n_full, tail, decoding.bucket_length(tail, max_seq_len)


def _check_prefix(prompt_len, prefix_len, max_seq_len):
    if not 0 <= prefix_len < prompt_len:
        raise ValueError(
            "prefix_len must be in [0, prompt_len); got {} for a "
            "{}-token prompt.".format(prefix_len, prompt_len))
    bucket = decoding.bucket_length(prompt_len - prefix_len, max_seq_len)
    if prefix_len + bucket > max_seq_len:
        raise ValueError(
            "prefix ({}) + suffix bucket ({}) exceeds max_seq_len {}; the "
            "scheduler trims the match to keep the padded suffix "
            "in-cache.".format(prefix_len, bucket, max_seq_len))
    return bucket


def _no_key_override(key_override):
    if key_override is not None:
        raise NotImplementedError(
            "key_override: fault requeue is not ported (ROADMAP §1, "
            "item 5c).")


class ChunkedPrefill:
    """An in-flight chunked prefill: one request's suffix split into
    fixed-width windows that the scheduler interleaves with decode
    ticks (`step()` runs ONE chunk; the final chunk returns the
    `PrefillResult` a whole prefill would have).

    The dense decode attention computes over the whole [1, L] cache
    with per-position validity masks, and positions come from the
    running real-token count, so a window written in chunks holds the
    values the whole window writes, and the tail chunk's last real
    position gives the first token (drawn with the whole prefill's
    seed). Construction is host-side only; the first `step()` runs the
    prefix gather, so every device dispatch happens on the stepping
    thread (the tick thread, in the scheduler)."""

    def __init__(self, engine, prompt, max_new_tokens, seed, sampling,
                 chunk_size, prefix_len=0, gather_vec=None):
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        self.prompt_len = int(prompt.shape[0])
        self.prefix_len = int(prefix_len)
        _check_prefix(self.prompt_len, self.prefix_len, engine.max_seq_len)
        self.engine = engine
        self.chunk_size = int(chunk_size)
        self.max_new_tokens = int(max_new_tokens)
        self._suffix = prompt[self.prefix_len:]
        self._sampling = dict(sampling)
        self._gather_vec = gather_vec
        n_full, tail, tail_bucket = chunk_plan(
            self.prompt_len - self.prefix_len, self.chunk_size,
            engine.max_seq_len)
        self.n_chunks = n_full + 1
        self.chunks_done = 0
        self._tail = tail
        self._tail_bucket = tail_bucket
        self._seeds = decoding.sample_seeds(seed, 1, max_new_tokens)[0]
        self._saved = None     # its cache while another prefill runs
        self._first = None     # the tail's first token, on its way
        self._closed = False

    def chunk_tokens(self, i):
        """Real tokens chunk `i` carries (chunk_size, or the tail)."""
        return self.chunk_size if i < self.n_chunks - 1 else self._tail

    @property
    def tail_next(self):
        """Whether the next step is the tail chunk (which draws)."""
        return self.chunks_done == self.n_chunks - 1 and self._first is None

    @property
    def tail_started(self):
        """Whether the tail ran and its first token is on its way."""
        return self._first is not None

    def step(self):
        """Runs the next chunk. Intermediate chunks return None (cache
        advanced, nothing drawn); the final chunk draws the first token
        and returns the `PrefillResult`, blocking until the token is on
        the host (the TTFT point), as `prefill()` does
        (`start_tail()`, then `finish()`)."""
        if self._closed:
            raise RuntimeError(
                "ChunkedPrefill already consumed or abandoned.")
        if self.tail_next or self.tail_started:
            if not self.tail_started:
                self.start_tail()
            return self.finish()
        engine = self.engine
        t0_ns = time.monotonic_ns()
        i = self.chunks_done
        C = self.chunk_size
        with engine._prefill_section(beside_tick=True):
            engine._claim(self)
            engine._stage(self._suffix[i * C:(i + 1) * C], np.ones(C, bool))
            engine._run(("chunk", C), engine._chunk_body(C),
                        engine._prefill_state())
        self.chunks_done = i + 1
        spans.complete("serve_prefill_chunk", t0_ns,
                       time.monotonic_ns() - t0_ns)
        return None

    def start_tail(self):
        """Runs the tail chunk and queues its first token's copy to the
        host, without waiting for it (`finish` collects it)."""
        if self._closed or not self.tail_next:
            raise RuntimeError("start_tail() comes once, after the other "
                               "chunks.")
        engine = self.engine
        t0_ns = time.monotonic_ns()
        i = self.chunks_done
        with engine._prefill_section(beside_tick=True):
            engine._claim(self)
            tokens = np.zeros((self._tail_bucket,), np.int64)
            tokens[:self._tail] = self._suffix[i * self.chunk_size:]
            mask = np.arange(self._tail_bucket) < self._tail
            engine._stage(tokens, mask, last=self._tail - 1)
            self._first = engine._launch_first(
                ("window", self._tail_bucket),
                engine._window_body(self._tail_bucket), self._seeds[0],
                self._sampling)
        self.chunks_done = i + 1
        spans.complete("serve_prefill_chunk", t0_ns,
                       time.monotonic_ns() - t0_ns)

    def finish(self, block=True):
        """The `PrefillResult` once the tail's first token is on the host
        (blocking for it, or None while it is not when `block` is
        False); the dense cache is then copied out for the insert."""
        if self._closed or not self.tail_started:
            raise RuntimeError("finish() follows start_tail().")
        engine = self.engine
        first = engine._collect_first(self._first, block)
        if first is None:
            return None
        first_host, t_first = first
        with engine._prefill_section(beside_tick=True):
            if engine._owner is self:
                pcache = engine._take_cache()
                engine._owner = None
            else:
                # Another prefill moved this one's cache out meanwhile.
                pcache, self._saved = self._saved, None
            ready = engine._ready_event()
        self._closed = True
        self._first = None
        return PrefillResult(
            first_token=first_host, pcache=pcache,
            step_seeds=engine._step_seeds(self._seeds),
            bucket=self._tail_bucket, n_steps=self.max_new_tokens,
            prompt_len=self.prompt_len, t_first=t_first, ready=ready)

    def abandon(self):
        """Drops this prefill's state (the drain/fail path; a consumed
        prefill's cache belongs to its PrefillResult)."""
        engine = self.engine
        self._closed = True
        with engine._device_lock:
            if engine._owner is self:
                engine._owner = None
            if self._saved is not None:
                decoding.release_cache(engine.model, 1, self._saved)
                self._saved = None


class _Graph:
    __slots__ = ("graph", "launches")

    def __init__(self, graph, launches):
        self.graph = graph
        self.launches = launches


class DecodeEngine:
    """Continuous-batching decode over `slots` slots of a paged pool.

    Single-owner slots: one thread calls `insert`/`tick`/`evict` and
    steps chunked prefills (the scheduler's tick thread); whole prefills,
    misses and prefix hits, may run concurrently on an admission
    thread.

    graphs: None replays CUDA graphs on a card and runs eagerly
    elsewhere; False runs eagerly on the card too (the yardstick a
    replay is held to, never a fallback).
    """

    def __init__(self, model, slots, page_size, num_pages,
                 max_new_cap=None, draft_model=None, draft_params=None,
                 spec_k=0, page_dtype="", ladder=None, graphs=None):
        from cloud_tpu_torch.models.transformer import (
            MOE_DECODE_NOT_PORTED, TransformerLM)

        if not isinstance(model, TransformerLM):
            raise NotImplementedError(
                "the engine serves TransformerLM; got {}.".format(
                    type(model).__name__))
        if model.moe_experts:
            raise NotImplementedError(MOE_DECODE_NOT_PORTED)
        for name, value in (("draft_model", draft_model),
                            ("draft_params", draft_params),
                            ("spec_k", spec_k or None)):
            if value is not None:
                raise NotImplementedError(
                    "{}: speculative decoding is not ported (ROADMAP §1, "
                    "item 5b).".format(name))
        if ladder is not None and tuple(ladder) != (int(slots),):
            raise NotImplementedError(
                "ladder: resize is not ported (ROADMAP §1, item 5c).")
        if model.max_seq_len % page_size:
            raise ValueError(
                "max_seq_len ({}) must be a multiple of page_size "
                "({}).".format(model.max_seq_len, page_size))
        if page_dtype not in ("", "int8"):
            raise ValueError(
                "page_dtype must be '' or 'int8'; got {!r}.".format(
                    page_dtype))
        if graphs not in (None, False):
            raise ValueError("graphs must be None or False; got "
                             "{!r}.".format(graphs))
        self.model = model
        self.device = model.device
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.pages_per_slot = model.max_seq_len // page_size
        self.max_seq_len = model.max_seq_len
        self.max_new_cap = int(max_new_cap or model.max_seq_len)
        if self.max_new_cap < 2:
            raise ValueError("max_new_cap must be >= 2.")
        self.page_dtype = str(page_dtype)
        self.cache = model.init_cache(self.slots, page_size=self.page_size,
                                      num_pages=self.num_pages,
                                      page_dtype=self.page_dtype)
        s = self.slots
        self.ctl = {
            "active": np.zeros((s,), bool),
            "done": np.zeros((s,), bool),
            "cur_tok": np.zeros((s,), np.int64),
            "steps_done": np.zeros((s,), np.int64),
            "max_steps": np.zeros((s,), np.int64),
            "temperature": np.zeros((s,), np.float64),
            "top_k": [None] * s,
            "top_p": [None] * s,
            "eos": np.zeros((s,), np.int64),
            "has_eos": np.zeros((s,), bool),
            "step_seeds": np.zeros((s, self.max_new_cap), np.int64),
        }
        self._kernel_costs = {}
        dev = self.device
        L, V = self.max_seq_len, model.vocab_size
        # Static buffers: the graphs' inputs and outputs (on any device,
        # so the CPU runs the card's steps eagerly). A step's inputs are
        # one int64 vector, staged on the host and copied in one piece:
        # the tick's [tokens S | mask S]; a prefill's [tokens L | mask L
        # | last | gather pages ppn | prefix length].
        ppn = self.pages_per_slot
        self._tk = {"in": torch.zeros((2 * s,), dtype=torch.int64,
                                      device=dev),
                    "logits": torch.zeros((s, V), device=dev),
                    "arg": torch.zeros((s,), dtype=torch.int64, device=dev)}
        # The host sides of the uploads: pinned on the card, so that a
        # copy is queued on the stream without blocking the host (a
        # pageable copy waits for the stream to drain first). Each is
        # rewritten only once its last copy ran (`_host`).
        self._pinned = {}
        self._uploaded = {}
        self._pin("tick", 2 * s)
        # A slot op's vectors: [page_vec ppn | scatter_vec ppn | mask S].
        self._slot_in = torch.zeros((2 * ppn + s,), dtype=torch.int64,
                                    device=dev)
        self._pin("slot", 2 * ppn + s)
        self._pin("prefill", 2 * L + ppn + 2)
        pf_in = torch.zeros((2 * L + ppn + 2,), dtype=torch.int64,
                            device=dev)
        self._pf = {"cache": model.init_cache(1), "in": pf_in,
                    "tokens": pf_in[:L].view(1, L), "mask": pf_in[L:2 * L],
                    "last": pf_in[2 * L:2 * L + 1],
                    "gvec": pf_in[2 * L + 1:2 * L + 1 + ppn],
                    "plen": pf_in[2 * L + 1 + ppn],
                    "row": torch.zeros((1, V), device=dev),
                    "arg": torch.zeros((1,), dtype=torch.int64,
                                       device=dev)}
        # One lock for every replay: a tick and a prefill never run
        # together on the card (their graphs' library workspaces are
        # not theirs alone), and the prefills share the static buffers.
        self._device_lock = threading.Lock()
        self._owner = None      # the ChunkedPrefill in the static cache
        self.graphs = (dev.type == "cuda") if graphs is None else False
        self._graphs = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self._warm_mark = None
        if self.graphs:
            self._tick_pool = torch.cuda.graph_pool_handle()
            self._pf_pool = torch.cuda.graph_pool_handle()
            # Prefill work runs on its own stream; a chunk step runs
            # there beside a tick. Each family of graphs is captured on
            # a stream of its own, so that a tick and a prefill graph
            # hold separate cuBLAS workspaces (one workspace per stream).
            self._pf_stream = torch.cuda.Stream(dev)
            self._capture_streams = {"tick": torch.cuda.Stream(dev),
                                     "prefill": torch.cuda.Stream(dev)}
            self._inserted = torch.cuda.Event()
            self._tk_out = torch.zeros((s,), dtype=torch.int64,
                                       pin_memory=True)
            self._tk_fetched = torch.cuda.Event()
            self._whole_done = torch.cuda.Event()

    # -- uploads ------------------------------------------------------

    def _pin(self, name, n):
        """A host staging vector of n int64 (pinned on the card)."""
        pinned = self.device.type == "cuda"
        tensor = torch.zeros((n,), dtype=torch.int64, pin_memory=pinned)
        self._pinned[name] = (tensor, tensor.numpy())
        self._uploaded[name] = torch.cuda.Event() if pinned else None

    def _host(self, name):
        """The staging vector `name` as numpy, once its last upload has
        run."""
        done = self._uploaded[name]
        if done is not None:
            done.synchronize()
        return self._pinned[name][1]

    def _upload(self, name, dst):
        """Queues the copy of staging vector `name` (its first
        len(dst) entries) into device `dst` on the current stream."""
        src = self._pinned[name][0]
        if dst.shape[0] != src.shape[0]:
            src = src[:dst.shape[0]]
        done = self._uploaded[name]
        if done is None:
            dst.copy_(src)
            return
        dst.copy_(src, non_blocking=True)
        done.record()

    # -- graphs -------------------------------------------------------

    def _run(self, key, body, keep=(), quiet=()):
        """Runs `body` (a step over the static buffers): eagerly, or as
        the replay of its CUDA graph, captured on first use. `keep`: the
        tensors of live state the capture's warm run must leave as they
        were; `quiet`: those zeroed for the warm run (the tick's mask,
        so that the warm tick moves no slot)."""
        if not self.graphs:
            body()
            return
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(key, body, keep, quiet)
        g.graph.replay()
        for counts, launched in zip(_launch_counters(), g.launches):
            for name, n in launched.items():
                counts[name] += n

    def _capture(self, key, body, keep, quiet):
        t0 = time.monotonic()
        saved = [t.clone() for t in keep]
        for t in quiet:
            t.zero_()
        stream = torch.cuda.current_stream(self.device)
        side = self._capture_streams["tick" if key == ("tick",)
                                     else "prefill"]
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            body()
        stream.wait_stream(side)
        for t, v in zip(keep, saved):
            t.copy_(v)
        counters = _launch_counters()
        before = [dict(counts) for counts in counters]
        graph = torch.cuda.CUDAGraph()
        pool = self._tick_pool if key == ("tick",) else self._pf_pool
        try:
            # thread_local: the other serving thread keeps launching
            # work on its own stream while this one captures.
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                body()
        except Exception as e:
            raise RuntimeError(
                "the serving engine's {} step cannot be captured as a "
                "CUDA graph ({}: {}).".format(key, type(e).__name__,
                                              e)) from e
        # The capture recorded the kernels; it launched none of them.
        launches = []
        for counts, was in zip(counters, before):
            launches.append({k: counts[k] - was[k] for k in was
                             if counts[k] > was[k]})
            counts.update(was)
        g = self._graphs[key] = _Graph(graph, launches)
        _captures[0] += 1
        self.captures += 1
        self.capture_seconds += time.monotonic() - t0
        return g

    def warm(self, widths=(), chunk_sizes=(), tails=()):
        """Captures, before traffic, the tick, a whole-prefill graph
        (gather + window) for each of `widths`, and for chunked
        prefills the gather, a chunk graph for each of `chunk_sizes`
        and a tail window for each of `tails` (a no-op off the card).
        Returns the captures made."""
        if not self.graphs:
            return 0
        n = self.captures
        with self._device_lock:
            if ("tick",) not in self._graphs:
                mask = self._tk["in"][self.slots:]
                self._capture(("tick",), self._tick_body, [mask], [mask])
        with self._device_lock:
            self._evict_owner()
            state = self._prefill_state()
            keys = [(("prefill", int(w)), self._prefill_body(int(w)))
                    for w in sorted(set(widths))]
            if chunk_sizes:
                keys.append((("gather",), self._gather_body))
                keys += [(("chunk", int(c)), self._chunk_body(int(c)))
                         for c in sorted(set(chunk_sizes))]
                keys += [(("window", int(t)), self._window_body(int(t)))
                         for t in sorted(set(tails))]
            for key, body in keys:
                if key not in self._graphs:
                    self._capture(key, body, state, ())
        return self.captures - n

    # -- retrace sentinel ---------------------------------------------

    def mark_warm(self):
        """Snapshots the process's graph captures and kernel builds;
        `check_no_retrace()` raises on any growth after this point."""
        self._warm_mark = retrace_count()

    def check_no_retrace(self):
        if self._warm_mark is None:
            return
        now = retrace_count()
        grew = {k: now[k] - self._warm_mark[k] for k in now
                if now[k] > self._warm_mark[k]}
        if grew:
            raise RetraceError(
                "serving path captured or built after warm-up: {} (a "
                "shape the warm-up did not cover).".format(grew))

    # -- prefill ------------------------------------------------------

    @contextlib.contextmanager
    def _prefill_section(self, beside_tick=False):
        """The device lock and, on the card, the stream order of a
        prefill. A whole prefill runs on the calling thread's stream
        (the default stream, the tick's) after the chunk steps queued so
        far: the tick stalls behind it, as behind one executable on the
        TPU. A chunk step (`beside_tick`) runs on the prefill stream
        beside the next tick, after the inserts queued so far (a hit's
        gather reads pages an insert wrote; a parked cache is read by
        the insert that scatters it) and the last whole prefill; an
        insert waits for its result's event."""
        with self._device_lock:
            if not self.graphs:
                yield
                return
            caller = torch.cuda.current_stream(self.device)
            if not beside_tick:
                caller.wait_stream(self._pf_stream)
                yield
                self._whole_done.record(caller)
                return
            self._pf_stream.wait_event(self._inserted)
            self._pf_stream.wait_event(self._whole_done)
            with torch.cuda.stream(self._pf_stream):
                yield

    def _prefill_state(self):
        """The static dense cache's tensors (a capture's warm run puts
        them back)."""
        cache = self._pf["cache"]
        return list(cache["store"].values()) + [cache["pos_count"]]

    def _gather_body(self):
        """Seeds the static dense cache with the first `plen` positions
        of the pool pages `gvec`, every layer's K and V in one gather
        (int8 pages dequantized with their per-page per-head scales;
        never-written pages carry scale 0 -> exact zeros); the rest is
        zeroed, so the cache is the one a right-pad prefill of those
        tokens leaves, and a miss (plen 0) starts from zeros
        (`decode_block.page_gather`, a kernel on the card). JAX's
        `_gather_impl`."""
        pf = self._pf
        cache, gvec, plen = pf["cache"], pf["gvec"], pf["plen"]
        span = torch.arange(self.max_seq_len, device=self.device)
        valid = span < plen
        with torch.no_grad():
            decode_block.page_gather(self.cache["pages"],
                                     self.cache.get("scales"), gvec, plen,
                                     cache["store"]["kv"])
            book = cache["layers"][0]
            book["slot_valid"].copy_(valid[None])
            book["slot_pos"].copy_(torch.where(valid, span, 0)[None])
            book["token_count"].copy_(plen.expand(1))
            book["cache_index"].copy_(plen)
            cache["pos_count"].copy_(plen.expand(1))

    def _window_body(self, width):
        """A `width`-token window through the static cache, keeping the
        logits of window position `last` and their argmax."""
        pf = self._pf

        def body():
            mask = (pf["mask"][:width] != 0).view(1, width)
            row = decoding.prefill_window(
                self.model, pf["cache"], pf["tokens"][:, :width], mask,
                pf["last"])
            pf["row"].copy_(row)
            pf["arg"].copy_(torch.argmax(row, dim=-1))
        return body

    def _prefill_body(self, width):
        """A whole prefill: the gather, then the `width` window."""
        window = self._window_body(width)

        def body():
            self._gather_body()
            window()
        return body

    def _chunk_body(self, width):
        """A `width`-token window that only advances the static cache."""
        pf = self._pf

        def body():
            mask = (pf["mask"][:width] != 0).view(1, width)
            with torch.no_grad():
                self.model.decode_hidden(pf["tokens"][:, :width], mask,
                                         pf["cache"])
        return body

    def _stage(self, tokens=(), mask=(), last=0, prefix_len=0,
               gather_vec=None):
        """Copies a prefill step's inputs into the static input vector,
        in one piece: the window's tokens and real-token mask, the
        window position whose logits are kept, and the gather's pages
        and prefix length (the first `prefix_len` positions of the pool
        pages `gather_vec`, or none)."""
        L, ppn = self.max_seq_len, self.pages_per_slot
        host = self._host("prefill")
        width = len(tokens)
        host[:width] = tokens
        host[L:L + width] = mask
        host[2 * L] = last
        vec = host[2 * L + 1:2 * L + 1 + ppn]
        vec[:] = 0
        if prefix_len:
            need = -(-prefix_len // self.page_size)
            given = np.asarray([] if gather_vec is None else gather_vec,
                               np.int64).reshape(-1)
            if given.shape[0] < need or given.shape[0] > vec.shape[0]:
                raise ValueError(
                    "gather_vec must list the {} pages holding the first "
                    "{} positions (at most {}); got {}.".format(
                        need, prefix_len, vec.shape[0], given.shape[0]))
            vec[:given.shape[0]] = given
        host[2 * L + 1 + ppn] = prefix_len
        self._upload("prefill", self._pf["in"])

    def _take_cache(self):
        """A copy of the static dense cache that the caller owns."""
        out = decoding.acquire_cache(self.model, 1, zero=False)
        return decoding.copy_cache(out, self._pf["cache"])

    def _evict_owner(self):
        """Moves a resident chunked prefill's state into its own cache,
        so that another prefill may use the static one."""
        owner, self._owner = self._owner, None
        if owner is not None:
            owner._saved = self._take_cache()

    def _claim(self, chunked):
        """Makes the static cache hold `chunked`'s state: its saved copy
        back, or (first chunk) the prefix gather."""
        if self._owner is chunked:
            return
        self._evict_owner()
        if chunked._saved is not None:
            decoding.copy_cache(self._pf["cache"], chunked._saved)
            decoding.release_cache(self.model, 1, chunked._saved)
            chunked._saved = None
        else:
            self._stage(prefix_len=chunked.prefix_len,
                        gather_vec=chunked._gather_vec)
            self._run(("gather",), self._gather_body, self._prefill_state())
        self._owner = chunked

    def _launch_first(self, key, body, seed, sampling):
        """The sampling step `body` (graph `key`; inputs staged) and the
        first token's copy to the host, queued. Returns the handle
        `_collect_first` takes."""
        pf = self._pf
        self._run(key, body, self._prefill_state())
        if sampling["temperature"]:
            first = decoding.sample_one(pf["row"][0], seed,
                                        sampling["temperature"],
                                        sampling["top_k"],
                                        sampling["top_p"])
        else:
            first = pf["arg"][0]
        if not self.graphs:
            return first, None
        runtime.record_d2h(first)
        host = torch.empty((1,), dtype=torch.int64, pin_memory=True)
        host.copy_(first.reshape(1), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _collect_first(self, handle, block=True):
        """(the first token, the time it reached the host) of a
        `_launch_first` handle; None when `block` is False and it is not
        there yet."""
        first, done = handle
        if done is None:
            return int(runtime.device_fetch(first)), time.monotonic()
        if not block and not done.query():
            return None
        done.synchronize()
        return int(first[0]), time.monotonic()

    def _ready_event(self):
        """An event after the work queued so far on the current stream
        (an insert waits for a result's cache copy); None off the
        card."""
        if not self.graphs:
            return None
        ready = torch.cuda.Event()
        ready.record()
        return ready

    def _finish_prefill(self, key, body, seed, sampling):
        """The sampling step `body` (graph `key`; inputs staged), then
        the first token on the host, the time it got there, an owned
        copy of the dense cache and its event."""
        first, t_first = self._collect_first(
            self._launch_first(key, body, seed, sampling))
        # The copy after the first token: TTFT does not wait for it.
        pcache = self._take_cache()
        return first, t_first, pcache, self._ready_event()

    def _step_seeds(self, seeds):
        out = np.zeros((self.max_new_cap,), np.int64)
        out[:seeds.shape[0]] = seeds
        return out

    def prefill(self, prompt, max_new_tokens, seed, sampling,
                prefix_len=0, gather_vec=None, key_override=None):
        """Canonical right-pad prefill for one request (`sampling`: the
        normalized dict of temperature, top_k, top_p, eos_token).

        prefix_len > 0 is a prefix-cache HIT: `gather_vec` (a
        `pool.page_vec` covering the matched pages) seeds the dense
        cache with the first `prefix_len` cached positions, and the
        model runs over the suffix only (the gather reads shared pages,
        after every insert before it). The draws are unchanged.
        Returns a `PrefillResult`; blocks until the first token is on
        the host (the TTFT point)."""
        _no_key_override(key_override)
        t0_ns = time.monotonic_ns()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        prompt_len = int(prompt.shape[0])
        prefix_len = int(prefix_len)
        bucket = _check_prefix(prompt_len, prefix_len, self.max_seq_len)
        n_suffix = prompt_len - prefix_len
        tokens = np.zeros((bucket,), np.int64)
        tokens[:n_suffix] = prompt[prefix_len:]
        # A greedy first token needs no seed: the schedule is drawn after
        # it, off the TTFT path.
        seeds = (decoding.sample_seeds(seed, 1, max_new_tokens)[0]
                 if sampling["temperature"] else None)
        with self._prefill_section():
            self._evict_owner()
            self._stage(tokens, np.arange(bucket) < n_suffix,
                        last=n_suffix - 1, prefix_len=prefix_len,
                        gather_vec=gather_vec)
            first_host, t_first, pcache, ready = self._finish_prefill(
                ("prefill", bucket), self._prefill_body(bucket),
                0 if seeds is None else seeds[0], sampling)
        if seeds is None:
            seeds = decoding.sample_seeds(seed, 1, max_new_tokens)[0]
        spans.complete("serve_prefill", t0_ns, time.monotonic_ns() - t0_ns)
        return PrefillResult(first_token=first_host, pcache=pcache,
                             step_seeds=self._step_seeds(seeds),
                             bucket=bucket, n_steps=int(max_new_tokens),
                             prompt_len=prompt_len, t_first=t_first,
                             ready=ready)

    def prefill_chunks(self, prompt, max_new_tokens, seed, sampling,
                       chunk_size, prefix_len=0, gather_vec=None,
                       key_override=None):
        """Chunked-prefill continuation for one request: the suffix runs
        as `chunk_plan()` windows, fixed `chunk_size` chunks through the
        chunk graph, then a pow2-bucketed tail through the window graph a
        whole prefill of that suffix would use. `prefix_len` /
        `gather_vec` seed the first chunk's start (a prefix-cache hit),
        as in `prefill()`. Returns a `ChunkedPrefill`; no device work
        happens until its first `step()`."""
        _no_key_override(key_override)
        chunk_size = int(chunk_size)
        if chunk_size < 1 or chunk_size & (chunk_size - 1):
            raise ValueError(
                "chunk_size must be a power of two >= 1 (the pow2 bound "
                "keeps chunked writes inside the whole-prefill bucket); "
                "got {}.".format(chunk_size))
        if chunk_size > self.max_seq_len:
            raise ValueError(
                "chunk_size ({}) exceeds max_seq_len ({}).".format(
                    chunk_size, self.max_seq_len))
        return ChunkedPrefill(self, prompt, max_new_tokens, seed, sampling,
                              chunk_size, prefix_len=prefix_len,
                              gather_vec=gather_vec)

    def release_prefill(self, result):
        """Parks a consumed (or abandoned) prefill's dense cache back in
        the decode-cache reuse pool."""
        decoding.release_cache(self.model, 1, result.pcache)
        result.pcache = None

    # -- slot ops (tick thread) ---------------------------------------

    def insert(self, slot, result, page_vec, scatter_vec, sampling):
        """Writes a prefilled request into free slot `slot`. `page_vec`
        is the slot's page table row (shared prefix pages included);
        `scatter_vec` routes chunk i of the dense cache to page_vec[i]
        where the slot owns the page (fresh pages, including the
        copy-on-write page a mid-page divergence rebuilds) and to the
        scratch page 0 where the content is already resident and
        shared (`decoding.scatter_prefill`)."""
        ppn = self.pages_per_slot
        host = self._host("slot")
        host[:ppn] = page_vec
        host[ppn:2 * ppn] = scatter_vec
        self._upload("slot", self._slot_in[:2 * ppn])
        stream = torch.cuda.current_stream(self.device) if self.graphs \
            else None
        if result.ready is not None:
            stream.wait_event(result.ready)
        decoding.scatter_prefill(self.cache, result.pcache, slot,
                                 self._slot_in[:ppn],
                                 self._slot_in[ppn:2 * ppn])
        if stream is not None:
            # Prefill work waits for this: the scatter wrote the pages a
            # later gather may read, and read the cache parked next.
            self._inserted.record(stream)
        ctl = self.ctl
        eos = sampling["eos_token"]
        ctl["active"][slot] = True
        ctl["has_eos"][slot] = eos is not None
        ctl["eos"][slot] = 0 if eos is None else eos
        ctl["done"][slot] = eos is not None and result.first_token == eos
        ctl["cur_tok"][slot] = result.first_token
        ctl["steps_done"][slot] = 1
        ctl["max_steps"][slot] = result.n_steps
        ctl["temperature"][slot] = sampling["temperature"]
        ctl["top_k"][slot] = sampling["top_k"]
        ctl["top_p"][slot] = sampling["top_p"]
        ctl["step_seeds"][slot] = result.step_seeds
        self.release_prefill(result)

    def _tick_body(self):
        tk = self._tk
        s = self.slots
        with torch.no_grad():
            logits = self.model(tk["in"][:s, None],
                                (tk["in"][s:] != 0)[:, None],
                                self.cache)[:, 0]
        tk["logits"].copy_(logits)
        tk["arg"].copy_(torch.argmax(logits, dim=-1))

    def tick(self):
        """Advances every active slot by one token. Returns the host
        array `[2, S]`: row 0 the sampled token (-1 on inactive slots),
        row 1 the finished flag."""
        return self.tick_collect(self.tick_launch())

    def tick_launch(self):
        """The tick's device work, queued: the replay and the draws.
        Returns the handle `tick_collect` takes; a chunk step may run in
        between, beside the tick, on the prefill stream."""
        ctl = self.ctl
        active = ctl["active"].copy()
        tk = self._tk
        s = self.slots
        host = self._host("tick")
        host[:s] = ctl["cur_tok"]
        host[s:] = active
        rows = np.arange(s)
        key_idx = np.clip(ctl["steps_done"], 0, self.max_new_cap - 1)
        seeds = ctl["step_seeds"][rows, key_idx]
        live_temp = np.where(active, ctl["temperature"], 0.0)
        with self._device_lock:
            self._upload("tick", tk["in"])
            self._run(("tick",), self._tick_body, keep=[tk["in"][s:]],
                      quiet=[tk["in"][s:]])
            nxt = decoding.sample_slots(tk["logits"], seeds, live_temp,
                                        ctl["top_k"], ctl["top_p"],
                                        greedy=tk["arg"])
            if self.graphs:
                # The tokens' copy to the host is queued now, so that the
                # fetch waits for the tick alone, not for the inserts
                # queued after it.
                runtime.record_d2h(nxt)
                self._tk_out.copy_(nxt, non_blocking=True)
                self._tk_fetched.record()
                nxt = None
        return active, nxt

    def tick_collect(self, launched):
        """The tick's tokens on the host (the loop's one fetch), and the
        control rows moved: as `tick()` returns."""
        active, nxt = launched
        ctl = self.ctl
        if nxt is None:
            self._tk_fetched.synchronize()
            nxt = self._tk_out.numpy().copy()
        else:
            nxt = runtime.device_fetch(nxt)
        latched = ctl["has_eos"] & ctl["done"]
        nxt = np.where(latched, ctl["eos"], nxt)
        done = ctl["done"] | (ctl["has_eos"] & (nxt == ctl["eos"]))
        steps = ctl["steps_done"] + active
        finished = active & (done | (steps >= ctl["max_steps"]))
        ctl["cur_tok"] = np.where(active, nxt, ctl["cur_tok"])
        ctl["done"] = np.where(active, done, ctl["done"])
        ctl["steps_done"] = steps
        return np.stack([np.where(active, nxt, -1),
                         finished.astype(np.int64)])

    def evict(self, evict_mask):
        """Frees every slot where `evict_mask` is True: page-table and
        validity rows go back to scratch/zero (one set of tensors for
        every layer), the control row disarms. The page ids go back to
        the host pool separately."""
        evict_mask = np.asarray(evict_mask, bool)
        ppn = self.pages_per_slot
        self._host("slot")[2 * ppn:] = evict_mask
        self._upload("slot", self._slot_in)
        gone = self._slot_in[2 * ppn:] != 0
        att = self.cache["layers"][0]
        att["page_table"].masked_fill_(gone[:, None], 0)
        att["slot_steps"].masked_fill_(gone, 0)
        att["slot_valid"].masked_fill_(gone[:, None], False)
        self.cache["pos_count"].masked_fill_(gone, 0)
        ctl = self.ctl
        keep = ~evict_mask
        ctl["active"] &= keep
        ctl["done"] &= keep
        for name in ("steps_done", "cur_tok", "max_steps"):
            ctl[name] = np.where(keep, ctl[name], 0)

    def resize(self, new_slots, perm):
        raise NotImplementedError(
            "ladder resize is not ported (ROADMAP §1, item 5c).")

    def snapshot_pages(self, page_ids):
        raise NotImplementedError(
            "the host page tier is not ported (ROADMAP §1, item 5c).")

    def promote_pages(self, host_tree, page_ids, n_skip=0):
        raise NotImplementedError(
            "the host page tier is not ported (ROADMAP §1, item 5c).")

    # -- accounting ---------------------------------------------------

    def kernel_costs(self, slots=None):
        """Per-TICK paged-attention flops / bytes-moved (all layers),
        counted analytically with every page live."""
        from cloud_tpu_torch.ops.paged_attention import paged_attention_cost

        slots = int(self.slots if slots is None else slots)
        if slots not in self._kernel_costs:
            model = self.model
            cost = paged_attention_cost(
                slots, 1, model.num_heads, model.head_dim, self.page_size,
                self.pages_per_slot, dtype=model.compute_dtype,
                kv_dtype=(torch.int8 if self.page_dtype == "int8"
                          else None))
            self._kernel_costs[slots] = {
                "paged_attention": {
                    "flops": cost["flops"] * model.num_layers,
                    "bytes_moved": cost["bytes_moved"] * model.num_layers,
                },
            }
        return self._kernel_costs[slots]

    def page_hbm_bytes(self):
        """Device bytes ONE physical page costs summed over every
        attention layer (K + V, plus the f32 scales of int8 pages)."""
        m = self.model
        item = (1 if self.page_dtype == "int8"
                else torch.empty((), dtype=m.compute_dtype).element_size())
        per_layer = 2 * self.page_size * m.num_heads * m.head_dim * item
        if self.page_dtype == "int8":
            per_layer += 2 * m.num_heads * 4
        return int(per_layer * m.num_layers)


__all__ = ["ChunkedPrefill", "DecodeEngine", "PrefillResult",
           "RetraceError", "chunk_plan", "retrace_count"]
