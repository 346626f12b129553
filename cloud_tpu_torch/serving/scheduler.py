"""Serving request scheduler: admission, batching, backpressure, the
prefix cache and chunked prefill; the port of
`cloud_tpu/serving/scheduler.py`.

Two threads around a `DecodeEngine`:

- the ADMISSION thread pops submitted requests from a bounded queue in
  FCFS windows, orders each window longest-radix-match-first (then
  longest prefill first), matches prefix-cache HITS in the trie and
  reserves KV pages (a miss's whole prompt, a hit's unshared tail;
  BLOCKING when the pool is exhausted: backpressure, never an
  out-of-memory error; a blocked reservation applies LRU eviction
  pressure to the prefix cache) and runs whole prefills, misses and
  hits, off the tick's critical path;
- the TICK thread owns the slots: it launches the tick that advances
  all active slots one token, steps at most one chunk of a chunked
  prefill beside it and inserts ready prefills into free slots while it
  runs (they join the next tick), fetches the tick output (the loop's
  single counted d2h round trip), evicts finished slots, returns their
  pages and completes them.

A hit's gather reads only shared pages, which nobody writes while they
are referenced, on a stream that waits for the inserts that wrote them
(`engine.DecodeEngine`): so, unlike JAX's scheduler, whose tick owns the
pool arrays it donates, a hit needs no hand-over to the tick thread.

Prefix sharing: every inserted prompt's full pages are registered in a
radix trie (`serving/prefixcache.py`). A later request whose prompt
shares a prefix maps those pages into its own page table (refcounted,
copy-on-write on divergence) and prefills only its suffix. With
`prefill_chunk=` (or `CLOUD_TPU_SERVE_PREFILL_CHUNK`) a pow2 width,
prefills run as `engine.ChunkedPrefill` continuations interleaved with
the ticks, so a long arrival costs each resident slot one chunk of
extra commit-to-commit gap (the `decode_gap` histogram) instead of the
whole prefill.

`warmup()` captures every graph the traffic will replay and drives
every bucket, the prefix path and the chunk surface; with
`strict_no_retrace=True` the tick loop then checks the engine's
sentinel every tick, so a capture or kernel build after warm-up fails
the loop with `RetraceError`.

Phase labels: the tick thread runs under `runtime.set_phase
("serve_tick")`, the admission thread under "serve_prefill".

Not ported (each argument raises NotImplementedError, naming its
ROADMAP item): speculation (5b); SLO shedding, the host page tier,
ladder resize, the admission model, chaos requeue and request tracing
(5c).
"""

import collections
import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from cloud_tpu_torch.models import decoding
from cloud_tpu_torch.monitoring import spans
from cloud_tpu_torch.monitoring.telemetry import Histogram
from cloud_tpu_torch.parallel import runtime
from cloud_tpu_torch.serving.engine import DecodeEngine
from cloud_tpu_torch.serving.kvpool import PagePool
from cloud_tpu_torch.serving.prefixcache import PrefixCache

_OFF_VALUES = ("", "0", "off", "false", "none")


def _histogram(name):
    """The scheduler's latency histograms: JAX's exponential buckets over
    the same range (1 us .. ~72 min), at 2^(1/8) steps instead of 2, so
    that a percentile is within 9 % (JAX's: 2x): the same-rig ratio
    gates read their p50 and p99, and a card's TTFTs and gaps of a few
    milliseconds all fall in one 2x bucket."""
    return Histogram(name, factor=2.0 ** 0.125, buckets=256)


@dataclasses.dataclass
class ServeRequest:
    """One decode request. Its output equals `generate(model,
    [prompt], max_new_tokens, seed=rng_seed, ...)`."""
    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token: Optional[int] = None
    rng_seed: int = 0


@dataclasses.dataclass
class ServeResult:
    """A completed request: `tokens` is prompt + continuation, the
    `generate()` row contract; `prefix_len` the prompt tokens served
    from the prefix cache."""
    tokens: np.ndarray
    ttft_s: float
    latency_s: float
    prefix_len: int = 0


class _Slot:
    __slots__ = ("request", "pages", "emitted", "future", "t_submit",
                 "ttft_s", "prefix_len")

    def __init__(self, request, pages, future, t_submit, ttft_s,
                 prefix_len=0):
        self.request = request
        self.pages = pages
        self.emitted = []
        self.future = future
        self.t_submit = t_submit
        self.ttft_s = ttft_s
        self.prefix_len = prefix_len


class _Admitted:
    """An admitted request on its way to a slot, with the pages its insert
    needs: a miss's reservation (`pages`), or a hit's shared and fresh
    pages and the copy-on-write source page of a mid-page divergence;
    and its prefill: `result` once it ran, `chunked` while it runs in
    chunks on the tick thread (`_step_chunks`)."""
    __slots__ = ("kind", "request", "prompt", "future", "t_submit", "pages",
                 "shared", "fresh", "partial_page", "partial_len",
                 "prefix_len", "chunked", "result", "ttft_s", "t_prefill0",
                 "hold_released")

    def __init__(self, kind, request, prompt, future, t_submit, pages=(),
                 shared=(), fresh=(), partial_page=None, partial_len=0,
                 prefix_len=0):
        self.kind = kind
        self.request = request
        self.prompt = prompt     # int64 array
        self.future = future
        self.t_submit = t_submit
        self.pages = list(pages)
        self.shared = list(shared)
        self.fresh = list(fresh)
        self.partial_page = partial_page
        self.partial_len = partial_len
        self.prefix_len = prefix_len
        self.chunked = None      # ChunkedPrefill while it runs in chunks
        self.result = None       # PrefillResult once the prefill ran
        self.ttft_s = 0.0
        self.t_prefill0 = None   # first chunk dispatch
        self.hold_released = True

    def pages_held(self):
        """Pages the eventual _Slot owns (the CoW partial page is freed
        at insert)."""
        if self.kind == "hit":
            return self.shared + self.fresh
        return list(self.pages)

    def all_pages(self):
        """Every page to free if the item dies before insert."""
        held = self.pages_held()
        if self.kind == "hit" and self.partial_len:
            held = held + [self.partial_page]
        return held


#: Constructor arguments of `cloud_tpu`'s Scheduler whose features are
#: not ported: the values accepted here, and the ROADMAP §1 item.
_UNPORTED = {
    "draft_model": ((None,), "5b"), "draft_params": ((None,), "5b"),
    "spec_k": ((0,), "5b"), "slo_ttft": ((None,), "5c"),
    "shed_policy": ((None,), "5c"), "host_tier": ((None, False), "5c"),
    "host_tier_pages": ((None,), "5c"), "ladder": ((None,), "5c"),
    "slots_min": ((None,), "5c"), "slots_max": ((None,), "5c"),
    "resize_quiet_ticks": ((None, 32), "5c"),
    "admission_model": ((None,), "5c"),
}


class Scheduler:
    """Continuous-batching front door. `submit()` from any thread;
    results come back as futures resolving to `ServeResult`.

    prefix_cache: share prompt pages across requests (the radix trie);
    prefix_cache_pages its page budget (None: half the pool).
    prefill_chunk: pow2 chunk width of interleaved prefills (None: the
    `CLOUD_TPU_SERVE_PREFILL_CHUNK` environment variable; 0 or unset:
    whole prefills). strict_no_retrace: after `warmup()`, a graph
    capture or kernel build on the serving path fails the tick loop
    (`engine.RetraceError`). kv_dtype: "" (pages in the compute dtype)
    or "int8" (None: `CLOUD_TPU_SERVE_KV_DTYPE`)."""

    def __init__(self, model, slots=4, page_size=16, num_pages=None,
                 max_new_cap=None, max_queue=64, admission_window=8,
                 strict_no_retrace=False, prefix_cache=True,
                 prefix_cache_pages=None, prefill_chunk=None,
                 kv_dtype=None, **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError("unexpected argument {!r}".format(name))
            accepted, item = _UNPORTED[name]
            if value not in accepted:
                raise NotImplementedError(
                    "{}={!r} is not ported (ROADMAP §1, item {}).".format(
                        name, value, item))
        if kv_dtype is None:
            kv_dtype = os.environ.get("CLOUD_TPU_SERVE_KV_DTYPE",
                                      "").strip().lower()
        if kv_dtype in _OFF_VALUES:
            kv_dtype = ""
        if kv_dtype not in ("", "int8"):
            raise ValueError(
                "kv_dtype must be '' or 'int8'; got {!r}.".format(
                    kv_dtype))
        if prefill_chunk is None:
            env = os.environ.get("CLOUD_TPU_SERVE_PREFILL_CHUNK",
                                 "").strip().lower()
            prefill_chunk = 0 if env in _OFF_VALUES else int(env)
        prefill_chunk = int(prefill_chunk)
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = off); got "
                             "{}.".format(prefill_chunk))
        if prefill_chunk:
            if prefill_chunk & (prefill_chunk - 1):
                raise ValueError(
                    "prefill_chunk must be a power of two (the tail "
                    "bucket family only telescopes then); got "
                    "{}.".format(prefill_chunk))
            if prefill_chunk > model.max_seq_len:
                raise ValueError(
                    "prefill_chunk ({}) exceeds max_seq_len ({}).".format(
                        prefill_chunk, model.max_seq_len))
        if num_pages is None:
            # Every slot can hold a full-length sequence, plus scratch.
            num_pages = slots * (model.max_seq_len // page_size) + 1
        self.kv_dtype = kv_dtype
        self.engine = DecodeEngine(model, slots, page_size, num_pages,
                                   max_new_cap=max_new_cap,
                                   page_dtype=kv_dtype)
        self.pool = PagePool(num_pages, page_size,
                             self.engine.pages_per_slot,
                             page_dtype=kv_dtype,
                             page_bytes=self.engine.page_hbm_bytes())
        self.trie = (PrefixCache(self.pool, max_pages=prefix_cache_pages)
                     if prefix_cache else None)
        self.strict_no_retrace = bool(strict_no_retrace)
        self._prefill_chunk = prefill_chunk or None
        self._admission_window = int(admission_window)
        self._admit_q = queue.Queue(maxsize=max_queue)
        self._ready = collections.deque()
        self._chunks = collections.deque()
        self._ready_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._failure = None
        self._slots = [None] * self.engine.slots
        self._free_slots = list(range(self.engine.slots))
        self._started = False
        self._t_start = None
        # Requests admitted but not yet slot-resident. While > 0 and
        # slots are free, the tick loop briefly yields so inserts land
        # before the next tick (a tick over 2 of 8 slots costs the
        # device as much as a full one). `_chunk_accounted` of them are
        # chunk items only the tick loop advances: excluded from that
        # yield.
        self._lock = threading.Lock()
        self._pending_inserts = 0
        self._chunk_accounted = 0
        self.warm_stats = None
        self._reset_stats()

    def _reset_stats(self):
        self._completed = 0
        self._tokens_out = 0
        self._ticks = 0
        self._hits = 0
        self._misses = 0
        self._prefix_tokens_served = 0
        self._chunks_dispatched = 0
        self._t_last_commit = None
        self._ttft_hist = _histogram("ttft")
        self._ttft_hit_hist = _histogram("ttft_hit")
        self._ttft_miss_hist = _histogram("ttft_miss")
        self._token_hist = _histogram("token_latency")
        self._queue_wait_hist = _histogram("queue_wait")
        self._reserve_wait_hist = _histogram("reserve_wait")
        self._prefill_hist = _histogram("prefill")
        self._prefill_chunk_hist = _histogram("prefill_chunk")
        self._decode_gap_hist = _histogram("decode_gap")
        self._t_start = time.monotonic()

    def _add_pending(self, n, chunk=False):
        with self._lock:
            self._pending_inserts += n
            if chunk:
                self._chunk_accounted += n

    # -- lifecycle ----------------------------------------------------

    def start(self):
        if self._started:
            return self
        self._started = True
        self._t_start = time.monotonic()
        self._prefill_thread = threading.Thread(
            target=self._prefill_loop, name="serve-prefill", daemon=True)
        self._tick_thread = threading.Thread(
            target=self._tick_loop, name="serve-tick", daemon=True)
        self._prefill_thread.start()
        self._tick_thread.start()
        return self

    def close(self):
        """Stops both threads; pending/queued requests fail with a
        RuntimeError (or the loop's own error, if one fired)."""
        if not self._started:
            return
        self._stop.set()
        self.pool.close()
        self._wake.set()
        self._prefill_thread.join(timeout=30)
        self._tick_thread.join(timeout=30)
        self._fail_pending(self._failure or RuntimeError("scheduler closed"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- submission ---------------------------------------------------

    def submit(self, request, timeout=None):
        """Admits one request; returns a Future[ServeResult]. Blocks
        (then raises queue.Full) when the bounded admission queue is
        full: backpressure reaches the caller."""
        if self._failure is not None:
            raise self._failure
        self._validate(request)
        # The prompt as the int64 array the trie and the engine read,
        # made on the caller's thread as part of the validation.
        prompt = np.asarray(request.prompt, np.int64).reshape(-1)
        future = Future()
        t_submit = time.monotonic()
        if request.max_new_tokens == 0:
            future.set_result(ServeResult(tokens=prompt, ttft_s=0.0,
                                          latency_s=0.0))
            return future
        if request.max_new_tokens > 1:
            self._add_pending(1)
        try:
            self._admit_q.put((request, prompt, future, t_submit),
                              timeout=timeout)
        except queue.Full:
            if request.max_new_tokens > 1:
                self._add_pending(-1)
            raise
        return future

    def _validate(self, request):
        model = self.engine.model
        prompt_len = len(request.prompt)
        if prompt_len < 1:
            raise ValueError("prompt must be non-empty.")
        if request.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0.")
        if prompt_len + request.max_new_tokens > model.max_seq_len:
            raise ValueError(
                "prompt ({}) + max_new_tokens ({}) exceeds max_seq_len "
                "{}.".format(prompt_len, request.max_new_tokens,
                             model.max_seq_len))
        if request.max_new_tokens > self.engine.max_new_cap:
            raise ValueError(
                "max_new_tokens ({}) exceeds the engine's max_new_cap "
                "({}).".format(request.max_new_tokens,
                               self.engine.max_new_cap))
        if request.top_k is not None and not (
                1 <= request.top_k <= model.vocab_size):
            raise ValueError("top_k must be in [1, vocab_size={}]; got "
                             "{}.".format(model.vocab_size, request.top_k))
        if request.top_p is not None and not (
                0.0 < request.top_p <= 1.0):
            raise ValueError("top_p must be in (0, 1]; got {}.".format(
                request.top_p))
        if request.max_new_tokens > 1:
            need = self.pool.pages_needed(prompt_len,
                                          request.max_new_tokens)
            if need > self.pool.capacity:
                raise ValueError(
                    "request needs {} pages; the pool has {} "
                    "allocatable.".format(need, self.pool.capacity))

    def _bucket(self, request):
        return decoding.bucket_length(len(request.prompt),
                                      self.engine.max_seq_len)

    def _probe(self, request, prompt):
        if self.trie is None or request.max_new_tokens <= 1:
            return 0
        return self.trie.probe(prompt)

    @staticmethod
    def _sampling(request):
        return {
            "temperature": float(request.temperature),
            "top_k": None if request.top_k is None else int(request.top_k),
            "top_p": None if request.top_p is None
            else float(request.top_p),
            "eos_token": None if request.eos_token is None
            else int(request.eos_token),
        }

    # -- admission/prefill thread -------------------------------------

    def _prefill_loop(self):
        runtime.set_phase("serve_prefill")
        while not self._stop.is_set():
            window = self._next_window()
            # A window of one needs no order: its match is taken at once.
            matched = [None] * len(window)
            if len(window) > 1:
                # Longest radix match first, then longest prefill first
                # (stable: ties stay FCFS): hits admit cheapest and
                # re-touch their prefix before LRU pressure can evict it;
                # big prefills hold their slot longest, so starting them
                # first shortens the tail.
                matched = [self._probe(item[0], item[1]) for item in window]
                order = sorted(range(len(window)), key=lambda i: (
                    -matched[i], -self._bucket(window[i][0])))
                window = [window[i] for i in order]
                matched = [matched[i] for i in order]
            for (request, prompt, future, t_submit), hit in zip(window,
                                                                matched):
                if self._stop.is_set():
                    return
                try:
                    self._admit_one(request, future, t_submit, prompt, hit)
                except Exception as exc:  # noqa: BLE001
                    # Boundary of the admission thread: the failure goes
                    # to the request's caller, the thread keeps serving.
                    if request.max_new_tokens > 1:
                        self._add_pending(-1)
                    future.set_exception(exc)

    def _next_window(self):
        window = []
        try:
            window.append(self._admit_q.get(timeout=0.05))
        except queue.Empty:
            return window
        while len(window) < self._admission_window:
            try:
                window.append(self._admit_q.get_nowait())
            except queue.Empty:
                break
        now = time.monotonic()
        for _, _, _, t_submit in window:
            self._queue_wait_hist.observe(max(now - t_submit, 0.0))
        return window

    def _reserve_with_pressure(self, need, timeout):
        """One blocking-reserve round; a failed round applies LRU
        eviction pressure to the prefix cache (pages only the trie holds
        are reclaimable) before the caller retries."""
        pages = self.pool.reserve(need, timeout=timeout)
        if pages is None and self.trie is not None:
            self.trie.evict(need)
        return pages

    def _reserve_pages(self, need):
        """Blocks (with trie pressure) until `need` pages come; returns
        them, or None at shutdown."""
        if need <= 0:
            return []
        t_reserve0 = time.monotonic()
        while not self._stop.is_set():
            pages = self._reserve_with_pressure(need, timeout=0.2)
            if pages is not None:
                self._reserve_wait_hist.observe(time.monotonic()
                                                - t_reserve0)
                return pages
        return None

    def _admit_one(self, request, future, t_submit, prompt, matched):
        """Admits one request of a window; `matched` is its probed
        prefix-cache match (tokens; None: not probed). A hit maps the
        matched pages and prefills its suffix; a miss (or a hit evicted
        since the probe) reserves pages for the whole prompt. Either
        prefill runs here, or, with chunking, in chunks on the tick
        thread."""
        if (request.max_new_tokens > 1 and self.trie is not None
                and matched != 0):
            hit = self._match(prompt)
            if hit is not None:
                self._admit_hit(request, future, t_submit, prompt, *hit)
                return
        pages = self._reserve_pages(
            self.pool.pages_needed(len(prompt), request.max_new_tokens)
            if request.max_new_tokens > 1 else 0)
        if pages is None:  # shutdown while blocked on the pool
            self._add_pending(-1)
            future.set_exception(RuntimeError("scheduler closed"))
            return
        item = _Admitted("miss", request, prompt, future, t_submit,
                         pages=pages)
        if self._prefill_chunk is not None:
            item.chunked = self._prefill_chunks(item)
            self._enqueue_chunk_item(item)
            return
        self._prefill_whole(item)

    def _match(self, prompt):
        """The trie's match for a probed hit (pool refs taken), trimmed
        until prefix + pow2(suffix) fits max_seq_len: the partial page
        first, then whole pages, each dropped ref going back. Returns
        (shared, partial_page, partial_len, prefix_len), or None when
        nothing is left (evicted since the probe, or trimmed away)."""
        prompt_len = len(prompt)
        page = self.pool.page_size
        cap = self.engine.max_seq_len
        match = self.trie.match(prompt)
        shared = list(match.pages)
        partial_page = match.partial_page
        partial_len = match.partial_len
        prefix_len = match.prefix_len
        while prefix_len and (prefix_len + decoding.bucket_length(
                prompt_len - prefix_len, cap) > cap):
            if partial_len:
                self.pool.free([partial_page])
                partial_page, partial_len = None, 0
            else:
                self.pool.free([shared.pop()])
            prefix_len = len(shared) * page + partial_len
        if prefix_len == 0:
            if shared:
                self.pool.free(shared)
            return None
        return shared, partial_page, partial_len, prefix_len

    def _admit_hit(self, request, future, t_submit, prompt, shared,
                   partial_page, partial_len, prefix_len):
        """A prefix-cache hit: fresh pages for the unshared tail (blocking,
        with trie pressure), then the gather-prefill of the suffix, or its
        chunks on the tick thread. The gather reads shared pages, which
        no one writes while they are referenced; the prefill's stream
        waits for the inserts that wrote them."""
        held = shared + ([partial_page] if partial_len else [])
        fresh = self._reserve_pages(self.pool.pages_needed(
            len(prompt), request.max_new_tokens) - len(shared))
        if fresh is None:  # shutdown while blocked on the pool
            self.pool.free(held)
            self._add_pending(-1)
            future.set_exception(RuntimeError("scheduler closed"))
            return
        item = _Admitted("hit", request, prompt, future, t_submit,
                         shared=shared, fresh=fresh,
                         partial_page=partial_page, partial_len=partial_len,
                         prefix_len=prefix_len)
        gather_vec = self.pool.page_vec(held)
        if self._prefill_chunk is not None:
            # The gather runs at the first chunk step (tick thread); the
            # held refs keep the prefix pages' content until then.
            item.chunked = self._prefill_chunks(item, gather_vec)
            self._enqueue_chunk_item(item)
            return
        self._prefill_whole(item, gather_vec)

    def _prefill_whole(self, item, gather_vec=None):
        """Runs an admitted request's whole prefill on this thread; the
        result waits in the ready deque for a slot (or completes the
        request when it wants one token)."""
        request = item.request
        t_prefill0 = time.monotonic()
        try:
            result = self.engine.prefill(
                item.prompt, request.max_new_tokens, request.rng_seed,
                self._sampling(request), prefix_len=item.prefix_len,
                gather_vec=gather_vec)
        except BaseException:
            pages = item.all_pages()
            if pages:
                self.pool.free(pages)
            raise
        item.ttft_s = result.t_first - item.t_submit
        self._record_ttft(item.ttft_s, hit=item.kind == "hit")
        self._prefill_hist.observe(time.monotonic() - t_prefill0)
        if item.kind == "hit":
            with self._lock:
                self._prefix_tokens_served += item.prefix_len
        if request.max_new_tokens == 1:
            # Completes at prefill: no slot, no pages, no tick.
            self.engine.release_prefill(result)
            self._complete(request, item.future, item.t_submit, item.ttft_s,
                           [result.first_token])
            return
        item.result = result
        with self._ready_lock:
            self._ready.append(item)
        self._wake.set()

    def _record_ttft(self, ttft, hit):
        self._ttft_hist.observe(ttft)
        (self._ttft_hit_hist if hit else self._ttft_miss_hist).observe(
            ttft)
        with self._lock:
            if hit:
                self._hits += 1
            else:
                self._misses += 1

    # -- chunked prefill: tick-interleaved continuations --------------

    def _prefill_chunks(self, item, gather_vec=None):
        request = item.request
        return self.engine.prefill_chunks(
            item.prompt, request.max_new_tokens, request.rng_seed,
            self._sampling(request), self._prefill_chunk,
            prefix_len=item.prefix_len, gather_vec=gather_vec)

    def _enqueue_chunk_item(self, item):
        self.pool.note_prefill_hold(len(item.all_pages()))
        item.hold_released = False
        if item.request.max_new_tokens > 1:
            with self._lock:
                self._chunk_accounted += 1
        with self._ready_lock:
            self._chunks.append(item)
        self._wake.set()

    def _release_chunk_hold(self, item):
        if not item.hold_released:
            item.hold_released = True
            self.pool.note_prefill_release(len(item.all_pages()))

    def _fail_item(self, item, error):
        """Drains one admitted item on failure/shutdown: its prefill state
        and cache go back, its pages free (exactly once), the future
        fails, and the pending-insert accounting unwinds."""
        if item.chunked is not None:
            item.chunked.abandon()
        if item.result is not None:
            self.engine.release_prefill(item.result)
            item.result = None
        self._release_chunk_hold(item)
        pages = item.all_pages()
        if pages:
            self.pool.free(pages)
        if item.request.max_new_tokens > 1:
            self._add_pending(-1, chunk=item.chunked is not None)
        if not item.future.done():
            item.future.set_exception(error)

    def _step_chunks(self, block=True):
        """Budgeted interleave: dispatches at most ONE prefill chunk per
        tick-loop iteration, oldest continuation first. With `block`
        False (a tick runs) the tail chunk is only started, and collected
        at a later call once its first token is on the host; until then
        no other chunk runs (the static cache is its own). The finished
        prefill records TTFT and moves to the ready deque for slot
        insertion (or completes when max_new == 1). Returns True when a
        chunk was dispatched or a prefill finished."""
        with self._ready_lock:
            if not self._chunks:
                return False
            item = self._chunks.popleft()
        if self._stop.is_set():
            self._fail_item(
                item, self._failure or RuntimeError("scheduler closed"))
            return False
        if item.t_prefill0 is None:
            item.t_prefill0 = time.monotonic()
        chunked = item.chunked
        t0 = time.monotonic()
        try:
            if chunked.tail_started:
                result = chunked.finish(block=block)
                dispatched = False
            elif chunked.tail_next and not block:
                chunked.start_tail()
                result, dispatched = None, True
            else:
                result, dispatched = chunked.step(), True
        except BaseException as exc:  # noqa: BLE001
            self._fail_item(item, exc)
            raise
        if dispatched:
            self._chunks_dispatched += 1
            self._prefill_chunk_hist.observe(time.monotonic() - t0)
        if result is None:
            with self._ready_lock:
                self._chunks.appendleft(item)
            return dispatched
        item.result = result
        item.ttft_s = result.t_first - item.t_submit
        self._record_ttft(item.ttft_s, hit=item.kind == "hit")
        self._prefill_hist.observe(time.monotonic() - item.t_prefill0)
        if item.kind == "hit":
            with self._lock:
                self._prefix_tokens_served += item.prefix_len
        if item.request.max_new_tokens == 1:
            self.engine.release_prefill(result)
            item.result = None
            self._release_chunk_hold(item)
            self._complete(item.request, item.future, item.t_submit,
                           item.ttft_s, [result.first_token],
                           prefix_len=item.prefix_len)
            return True
        with self._ready_lock:
            self._ready.append(item)
        return True

    # -- tick thread --------------------------------------------------

    def _tick_loop(self):
        runtime.set_phase("serve_tick")
        skips = 0
        try:
            while not self._stop.is_set():
                self._insert_ready()
                if not any(s is not None for s in self._slots):
                    self._t_last_commit = None
                    if self._step_chunks():
                        # A continuation advanced and nothing decodes:
                        # drain chunks back to back, no idle sleep.
                        continue
                    if self._wake.wait(timeout=0.05):
                        self._wake.clear()
                    continue
                with self._lock:
                    waiting = self._pending_inserts - self._chunk_accounted
                if self._free_slots and waiting > 0 and skips < 40:
                    # Admissions are in flight on the other thread and
                    # slots are open: yield briefly so the insert lands
                    # before the next tick. The cap bounds the stall
                    # when an admission waits on pages only ticks can
                    # free. Chunk items are excluded: only this loop
                    # advances them.
                    skips += 1
                    self._wake.wait(timeout=0.005)
                    self._wake.clear()
                    continue
                skips = 0
                t0 = time.monotonic()
                launched = self.engine.tick_launch()
                # While the tick runs: at most one chunk, beside it (on
                # the card, on the prefill stream; a tail's first token
                # is collected at a later iteration), and the inserts
                # that became ready (they join the next tick).
                self._step_chunks(block=False)
                fresh = self._insert_ready()
                fetched = self.engine.tick_collect(launched)
                t_commit = time.monotonic()
                elapsed = t_commit - t0
                spans.complete("serve_tick", int(t0 * 1e9),
                               int(elapsed * 1e9))
                self._ticks += 1
                n_active = sum(s is not None for s in self._slots) - len(
                    fresh)
                if self._t_last_commit is not None and n_active:
                    self._decode_gap_hist.observe(
                        t_commit - self._t_last_commit, count=n_active)
                self._t_last_commit = t_commit
                self._distribute(fetched, elapsed, fresh)
                if self.strict_no_retrace:
                    self.engine.check_no_retrace()
        except BaseException as exc:  # noqa: BLE001
            # Boundary of the tick thread: record the failure, stop,
            # and fail every pending request with it.
            self._failure = exc
            self._stop.set()
            self.pool.close()
            self._fail_pending(exc)

    def _insert_ready(self):
        """Inserts ready prefills into free slots; returns the slots
        filled."""
        filled = []
        while self._free_slots:
            with self._ready_lock:
                if not self._ready:
                    break
                item = self._ready.popleft()
            slot = self._insert(item)
            if slot is not None:
                filled.append(slot)
        return filled

    def _insert(self, item):
        """Slot insertion of a prefilled request: the slot's page table
        (a hit's shared pages first), the scatter of its dense cache
        into the pages it owns (a hit's shared entries go to scratch:
        shared pages are immutable, and the divergent page is rebuilt
        into a fresh one, the device-side copy-on-write), then its full
        prompt pages join the trie."""
        if self._stop.is_set():
            self._fail_item(
                item, self._failure or RuntimeError("scheduler closed"))
            return None
        held = item.pages_held()
        slot = self._free_slots.pop()
        state = _Slot(item.request, held, item.future, item.t_submit,
                      item.ttft_s, prefix_len=item.prefix_len)
        state.emitted.append(item.result.first_token)
        self._slots[slot] = state
        page_vec = self.pool.page_vec(held)
        if item.kind == "hit":
            scatter_vec = self.pool.page_vec(
                [0] * len(item.shared) + list(item.fresh))
        else:
            scatter_vec = page_vec
        self.engine.insert(slot, item.result, page_vec, scatter_vec,
                           self._sampling(item.request))
        item.result = None
        if item.kind == "hit" and item.partial_len:
            self.pool.note_cow()
            self.pool.free([item.partial_page])
        self._release_chunk_hold(item)
        self._register(item.prompt, held)
        self._add_pending(-1, chunk=item.chunked is not None)
        return slot

    def _register(self, prompt, pages):
        """Indexes the inserted request's full prompt pages (tick thread,
        right after insert: the pages are written and immutable from
        here; decode writes start past the prompt)."""
        if self.trie is not None:
            self.trie.register(prompt, pages)

    def _distribute(self, fetched, elapsed, fresh=()):
        """The tick's tokens to their slots (`fresh`: slots filled after
        the tick was launched, which it did not advance)."""
        n_active = sum(s is not None for s in self._slots) - len(fresh)
        if n_active:
            self._token_hist.observe(elapsed, count=n_active)
        tokens_row, finished_row = fetched[0], fetched[1]
        evict_mask = np.zeros((self.engine.slots,), bool)
        finished = []
        for slot, state in enumerate(self._slots):
            if state is None or slot in fresh:
                continue
            state.emitted.append(int(tokens_row[slot]))
            if finished_row[slot]:
                evict_mask[slot] = True
                finished.append((slot, state))
        if finished:
            # The slots are freed before their callers hear back: a
            # caller's next request then finds this thread idle.
            self.engine.evict(evict_mask)
            for slot, state in finished:
                self._finish_slot(slot, state)

    def _finish_slot(self, slot, state):
        self._slots[slot] = None
        self._free_slots.append(slot)
        self.pool.free(state.pages)
        self._complete(state.request, state.future, state.t_submit,
                       state.ttft_s, state.emitted,
                       prefix_len=state.prefix_len)

    def _complete(self, request, future, t_submit, ttft, emitted,
                  prefix_len=0):
        emitted = emitted[:request.max_new_tokens]
        # Early-eos eviction: generate() keeps emitting eos after done.
        if len(emitted) < request.max_new_tokens:
            emitted = emitted + [request.eos_token] * (
                request.max_new_tokens - len(emitted))
        tokens = np.concatenate([np.asarray(request.prompt, np.int64),
                                 np.asarray(emitted, np.int64)])
        with self._lock:  # both threads complete requests
            self._completed += 1
            self._tokens_out += request.max_new_tokens
        future.set_result(ServeResult(
            tokens=tokens, ttft_s=ttft,
            latency_s=time.monotonic() - t_submit,
            prefix_len=int(prefix_len)))

    def _fail_pending(self, error):
        with self._ready_lock:
            items = list(self._ready) + list(self._chunks)
            self._ready, self._chunks = (collections.deque(),
                                         collections.deque())
        for item in items:
            self._fail_item(item, error)
        with self._lock:
            self._pending_inserts = 0
            self._chunk_accounted = 0
        for slot, state in enumerate(self._slots):
            if state is not None:
                if state.pages:
                    self.pool.free(state.pages)
                if not state.future.done():
                    state.future.set_exception(error)
            self._slots[slot] = None
        while True:
            try:
                _, _, future, _ = self._admit_q.get_nowait()
            except queue.Empty:
                break
            if not future.done():
                future.set_exception(error)

    # -- invariants, warm-up, stats -----------------------------------

    def assert_drained(self, clear_prefix=False):
        """Refcount leak detector. With no work in flight every held
        pool page must be exactly one trie reference; with
        `clear_prefix` the trie is dropped first and the pool must be
        FULLY free. Raises RuntimeError on any leak."""
        with self._lock:
            pending = self._pending_inserts
        busy = (any(s is not None for s in self._slots) or pending > 0
                or self._admit_q.qsize())
        with self._ready_lock:
            busy = busy or bool(self._ready) or bool(self._chunks)
        if busy:
            raise RuntimeError(
                "assert_drained called with requests in flight.")
        if clear_prefix and self.trie is not None:
            self.trie.clear()
        held = self.pool.leak_report()
        trie_pages = (set(self.trie.held_pages())
                      if self.trie is not None else set())
        leaked = {p: r for p, r in held.items()
                  if p not in trie_pages or r != 1}
        if leaked:
            raise RuntimeError(
                "page refcount leak (page -> holders, beyond the prefix "
                "index): {}".format(leaked))
        if len(held) != len(trie_pages):
            raise RuntimeError(
                "prefix index holds {} pages but the pool records {} "
                "held.".format(len(trie_pages), len(held)))

    def warmup(self, buckets, sampling_configs=((),), max_new=3):
        """Prepares the whole serving surface for `buckets` x sampling
        configs before traffic: the engine captures its graphs (the
        tick, the gather, a window graph per width, the chunk graph;
        `engine.warm`), then two waves of requests drive each bucket
        (full and short lengths), and, with the prefix cache on, every
        pow2 width up to the largest bucket (a hit's suffix can land in
        any) and a shared-prefix trio (the gather and copy-on-write
        path; the trie is cleared afterwards); with chunking, the chunk
        and every tail bucket. Then the retrace sentinel is armed
        (`engine.mark_warm`), the warm-up's stats are kept as
        `warm_stats`, and the stats restart."""
        bucket_length = decoding.bucket_length
        vocab = self.engine.model.vocab_size
        configs = []
        for cfg in sampling_configs:
            merged = dict(temperature=0.0, top_k=None, top_p=None,
                          eos_token=None)
            merged.update(dict(cfg))
            configs.append(merged)
        widths = set(buckets)
        if self.trie is not None and buckets:
            w = 1
            while w <= max(buckets):
                widths.add(w)
                w *= 2
        cap = self.engine.max_seq_len - max_new
        chunk_lengths = []
        tails = set()
        if self._prefill_chunk is not None:
            # Length C + t has one full chunk and a t-token tail, so
            # {C + t : t pow2 <= C} drives the chunk graph and every
            # tail bucket.
            t = 1
            while t <= self._prefill_chunk:
                tails.add(t)
                if self._prefill_chunk + t <= cap:
                    chunk_lengths.append(self._prefill_chunk + t)
                t *= 2
        if self._prefill_chunk is not None:
            # Every prefill runs in chunks: the gather, the chunk and
            # the tail windows.
            self.engine.warm(chunk_sizes=[self._prefill_chunk],
                             tails=tails)
        else:
            self.engine.warm(widths=widths)
        # Distinct first tokens keep warm-up prompts from prefix-matching
        # each other (a warm-up hit would run its suffix bucket instead
        # of the width it was meant to drive).
        combo = 0
        for _ in range(2):
            futures = []
            for bucket in sorted(widths):
                for length in sorted({min(bucket, cap),
                                      min(max(bucket - 1, 1), cap)}):
                    if length < 1 or bucket_length(
                            length, self.engine.max_seq_len) != bucket:
                        continue
                    for cfg in configs:
                        first = 2 + combo % max(vocab - 2, 1)
                        combo += 1
                        futures.append(self.submit(ServeRequest(
                            prompt=[first] + [1] * (length - 1),
                            max_new_tokens=max_new, **cfg)))
            for length in chunk_lengths:
                for cfg in configs:
                    first = 2 + combo % max(vocab - 2, 1)
                    combo += 1
                    futures.append(self.submit(ServeRequest(
                        prompt=[first] + [1] * (length - 1),
                        max_new_tokens=max_new, **cfg)))
            for future in futures:
                future.result(timeout=600)
        if self.trie is not None:
            self._warm_prefix_path(configs[0])
            self.trie.clear()
            self.trie.reset_stats()
        self.engine.mark_warm()
        self.warm_stats = self.stats()
        self._reset_stats()

    def _warm_prefix_path(self, cfg):
        """Shared-prefix trio: a miss that registers a page, a mid-page
        divergence (gather + copy-on-write rebuild), and a clean
        full-page hit."""
        page = self.pool.page_size
        vocab = self.engine.model.vocab_size
        base_len = page + page // 2
        if page < 4 or vocab < 4 or base_len + 2 > self.engine.max_seq_len:
            return
        base = [1] * base_len
        prompts = [
            base,                                       # miss, registers
            base[:(3 * page) // 4] + [2] * (base_len - (3 * page) // 4),
            base[:page] + [3] * (base_len - page),      # full-page hit
        ]
        for prompt in prompts:
            self.submit(ServeRequest(prompt=prompt, max_new_tokens=2,
                                     **cfg)).result(timeout=600)

    def stats(self):
        """Host-side rollup of the traffic since start (or warmup)."""
        wall = max(time.monotonic() - self._t_start, 1e-9)
        lookups = self._hits + self._misses
        out = {
            "requests_completed": self._completed,
            "tokens_emitted": self._tokens_out,
            "ticks": self._ticks,
            "elapsed_seconds": wall,
            "requests_per_sec": self._completed / wall,
            "tokens_per_sec": self._tokens_out / wall,
            "ttft": self._ttft_hist.snapshot(),
            "ttft_hit": self._ttft_hit_hist.snapshot(),
            "ttft_miss": self._ttft_miss_hist.snapshot(),
            "token_latency": self._token_hist.snapshot(),
            "queue_wait": self._queue_wait_hist.snapshot(),
            "reserve_wait": self._reserve_wait_hist.snapshot(),
            "prefill": self._prefill_hist.snapshot(),
            "prefill_chunk": self._prefill_chunk_hist.snapshot(),
            "decode_gap": self._decode_gap_hist.snapshot(),
            "prefill_chunks_dispatched": self._chunks_dispatched,
            "prefill_chunk_size": self._prefill_chunk or 0,
            "queue_depth": self._admit_q.qsize(),
            "prefix_hits": self._hits,
            "prefix_misses": self._misses,
            "prefix_hit_rate": self._hits / lookups if lookups else 0.0,
            "prefix_tokens_served": self._prefix_tokens_served,
            "pool": self.pool.pool_stats(),
            "kv": {"page_dtype": self.kv_dtype,
                   "page_bytes": self.pool.page_bytes},
            "graphs": {"captures": self.engine.captures,
                       "capture_seconds": self.engine.capture_seconds},
        }
        if self.trie is not None:
            out["prefix_cache"] = self.trie.stats()
        return out


__all__ = ["Scheduler", "ServeRequest", "ServeResult"]
