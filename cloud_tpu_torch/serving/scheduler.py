"""Serving request scheduler: admission, batching, backpressure; the
port of the plain (no prefix cache) path of
`cloud_tpu/serving/scheduler.py`.

Two threads around a `DecodeEngine`:

- the ADMISSION thread pops submitted requests from a bounded queue in
  FCFS windows (longest prompt first within a window), reserves KV
  pages for each (BLOCKING when the pool is exhausted: backpressure,
  never an out-of-memory error) and runs its prefill off the tick's
  critical path;
- the TICK thread owns the engine's device state: it inserts ready
  prefills into free slots, advances all active slots one token per
  tick, fetches the tick output (the loop's single counted d2h round
  trip), completes and evicts finished slots, and returns their pages.

Phase labels: the tick thread runs under `runtime.set_phase
("serve_tick")`, the admission thread under "serve_prefill".

The prefix cache, speculation, SLO shedding, chunked prefill, the
host page tier, ladder resize, chaos injection and request tracing are
not ported: their constructor arguments raise NotImplementedError.
"""

import collections
import dataclasses
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
    `generate()` row contract. `prefix_len` is always 0 here (no
    prefix cache)."""
    tokens: np.ndarray
    ttft_s: float
    latency_s: float
    prefix_len: int = 0


class _Slot:
    __slots__ = ("request", "pages", "emitted", "future", "t_submit",
                 "ttft_s")

    def __init__(self, request, pages, future, t_submit, ttft_s):
        self.request = request
        self.pages = pages
        self.emitted = []
        self.future = future
        self.t_submit = t_submit
        self.ttft_s = ttft_s


class _ReadyItem:
    """A prefill waiting for a free slot (the admission thread already
    ran it and holds the reserved pages)."""
    __slots__ = ("request", "result", "pages", "future", "t_submit",
                 "ttft_s")

    def __init__(self, request, result, pages, future, t_submit, ttft_s):
        self.request = request
        self.result = result
        self.pages = pages
        self.future = future
        self.t_submit = t_submit
        self.ttft_s = ttft_s


#: Constructor arguments of `cloud_tpu`'s Scheduler whose features are
#: not ported, with the only value accepted here.
_UNPORTED = {
    "strict_no_retrace": False, "prefix_cache": False,
    "prefix_cache_pages": None, "draft_model": None, "draft_params": None,
    "spec_k": 0, "slo_ttft": None, "shed_policy": None,
    "prefill_chunk": None, "host_tier": None, "host_tier_pages": None,
    "ladder": None, "slots_min": None, "slots_max": None,
    "resize_quiet_ticks": None, "admission_model": None,
}


class Scheduler:
    """Continuous-batching front door. `submit()` from any thread;
    results come back as futures resolving to `ServeResult`."""

    def __init__(self, model, slots=4, page_size=16, num_pages=None,
                 max_new_cap=None, max_queue=64, admission_window=8,
                 kv_dtype="", **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError("unexpected argument {!r}".format(name))
            if value != _UNPORTED[name]:
                raise NotImplementedError(
                    "{}={!r} is not ported (only {!r}).".format(
                        name, value, _UNPORTED[name]))
        kv_dtype = kv_dtype or ""
        if kv_dtype not in ("", "int8"):
            raise ValueError(
                "kv_dtype must be '' or 'int8'; got {!r}.".format(
                    kv_dtype))
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
        self._admission_window = int(admission_window)
        self._admit_q = queue.Queue(maxsize=max_queue)
        self._ready = collections.deque()
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
        # device as much as a full one).
        self._lock = threading.Lock()
        self._pending_inserts = 0
        self._reset_stats()

    def _reset_stats(self):
        self._completed = 0
        self._tokens_out = 0
        self._ticks = 0
        self._ttft_hist = Histogram("ttft")
        self._token_hist = Histogram("token_latency")
        self._queue_wait_hist = Histogram("queue_wait")
        self._reserve_wait_hist = Histogram("reserve_wait")
        self._prefill_hist = Histogram("prefill")
        self._t_start = time.monotonic()

    def _add_pending(self, n):
        with self._lock:
            self._pending_inserts += n

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
        future = Future()
        t_submit = time.monotonic()
        if request.max_new_tokens == 0:
            future.set_result(ServeResult(
                tokens=np.asarray(request.prompt, np.int64),
                ttft_s=0.0, latency_s=0.0))
            return future
        if request.max_new_tokens > 1:
            self._add_pending(1)
        try:
            self._admit_q.put((request, future, t_submit), timeout=timeout)
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
            # Longest prefill first (stable: ties stay FCFS): big
            # prefills hold their slot longest, so starting them first
            # shortens the tail.
            window.sort(key=lambda item: -decoding.bucket_length(
                len(item[0].prompt), self.engine.max_seq_len))
            for request, future, t_submit in window:
                if self._stop.is_set():
                    return
                try:
                    self._admit_one(request, future, t_submit)
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
        for _, _, t_submit in window:
            self._queue_wait_hist.observe(max(now - t_submit, 0.0))
        return window

    def _admit_one(self, request, future, t_submit):
        pages = []
        if request.max_new_tokens > 1:
            need = self.pool.pages_needed(len(request.prompt),
                                          request.max_new_tokens)
            pages = None
            t_reserve0 = time.monotonic()
            while not self._stop.is_set():
                pages = self.pool.reserve(need, timeout=0.2)
                if pages is not None:
                    break
            if pages is None:  # shutdown while blocked on the pool
                self._add_pending(-1)
                future.set_exception(RuntimeError("scheduler closed"))
                return
            self._reserve_wait_hist.observe(time.monotonic() - t_reserve0)
        t_prefill0 = time.monotonic()
        try:
            result = self.engine.prefill(request.prompt,
                                         request.max_new_tokens,
                                         request.rng_seed,
                                         self._sampling(request))
        except BaseException:
            if pages:
                self.pool.free(pages)
            raise
        ttft = time.monotonic() - t_submit
        self._ttft_hist.observe(ttft)
        self._prefill_hist.observe(time.monotonic() - t_prefill0)
        if request.max_new_tokens == 1:
            # Completes at prefill: no slot, no pages, no tick.
            self.engine.release_prefill(result)
            self._complete(request, future, t_submit, ttft,
                           [result.first_token])
            return
        with self._ready_lock:
            self._ready.append(_ReadyItem(request, result, pages, future,
                                          t_submit, ttft))
        self._wake.set()

    # -- tick thread --------------------------------------------------

    def _tick_loop(self):
        runtime.set_phase("serve_tick")
        skips = 0
        try:
            while not self._stop.is_set():
                self._insert_ready()
                if not any(s is not None for s in self._slots):
                    if self._wake.wait(timeout=0.05):
                        self._wake.clear()
                    continue
                with self._lock:
                    pending = self._pending_inserts
                if self._free_slots and pending > 0 and skips < 40:
                    # Admissions are in flight and slots are open: yield
                    # briefly so the insert lands before the next tick.
                    # The cap bounds the stall when an admission waits
                    # on pages only ticks can free.
                    skips += 1
                    self._wake.wait(timeout=0.005)
                    self._wake.clear()
                    continue
                skips = 0
                t0 = time.monotonic()
                fetched = self.engine.tick()
                elapsed = time.monotonic() - t0
                spans.complete("serve_tick", int(t0 * 1e9),
                               int(elapsed * 1e9))
                self._ticks += 1
                self._distribute_plain(fetched, elapsed)
        except Exception as exc:  # noqa: BLE001
            # Boundary of the tick thread: record the failure, stop,
            # and fail every pending request with it.
            self._failure = exc
            self._stop.set()
            self.pool.close()
            self._fail_pending(exc)

    def _insert_ready(self):
        while self._free_slots:
            with self._ready_lock:
                if not self._ready:
                    return
                item = self._ready.popleft()
            self._insert_miss_item(item)

    def _insert_miss_item(self, item):
        slot = self._free_slots.pop()
        state = _Slot(item.request, item.pages, item.future,
                      item.t_submit, item.ttft_s)
        state.emitted.append(item.result.first_token)
        self._slots[slot] = state
        vec = self.pool.page_vec(item.pages)
        self.engine.insert(slot, item.result, vec, vec,
                           self._sampling(item.request))
        self._add_pending(-1)

    def _distribute_plain(self, fetched, elapsed):
        n_active = sum(s is not None for s in self._slots)
        if n_active:
            self._token_hist.observe(elapsed, count=n_active)
        tokens_row, finished_row = fetched[0], fetched[1]
        evict_mask = np.zeros((self.engine.slots,), bool)
        for slot, state in enumerate(self._slots):
            if state is None:
                continue
            state.emitted.append(int(tokens_row[slot]))
            if finished_row[slot]:
                self._finish_slot(slot, state, evict_mask)
        if evict_mask.any():
            self.engine.evict(evict_mask)

    def _finish_slot(self, slot, state, evict_mask):
        evict_mask[slot] = True
        self._slots[slot] = None
        self._free_slots.append(slot)
        self.pool.free(state.pages)
        self._complete(state.request, state.future, state.t_submit,
                       state.ttft_s, state.emitted)

    def _complete(self, request, future, t_submit, ttft, emitted):
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
            latency_s=time.monotonic() - t_submit))

    def _fail_pending(self, error):
        with self._ready_lock:
            ready, self._ready = list(self._ready), collections.deque()
        for item in ready:
            if item.pages:
                self.pool.free(item.pages)
            if not item.future.done():
                item.future.set_exception(error)
        with self._lock:
            self._pending_inserts = 0
        for slot, state in enumerate(self._slots):
            if state is not None:
                if state.pages:
                    self.pool.free(state.pages)
                if not state.future.done():
                    state.future.set_exception(error)
            self._slots[slot] = None
        while True:
            try:
                _, future, _ = self._admit_q.get_nowait()
            except queue.Empty:
                break
            if not future.done():
                future.set_exception(error)

    # -- invariants, warm-up, stats -----------------------------------

    def assert_drained(self):
        """Refcount leak detector: with no work in flight every page
        must be back in the pool. Raises RuntimeError otherwise."""
        with self._lock:
            pending = self._pending_inserts
        busy = (any(s is not None for s in self._slots) or pending > 0
                or self._admit_q.qsize())
        with self._ready_lock:
            busy = busy or bool(self._ready)
        if busy:
            raise RuntimeError(
                "assert_drained called with requests in flight.")
        held = self.pool.leak_report()
        if held:
            raise RuntimeError(
                "page refcount leak (page -> holders): {}".format(held))

    def warmup(self, buckets, sampling_configs=((),), max_new=3):
        """Runs one request per prompt bucket and sampling config, so
        the kernels are built and the libraries' first-call costs are
        paid before traffic; then restarts the stats."""
        configs = []
        for cfg in sampling_configs:
            merged = dict(temperature=0.0, top_k=None, top_p=None,
                          eos_token=None)
            merged.update(dict(cfg))
            configs.append(merged)
        cap = self.engine.max_seq_len - max_new
        futures = []
        for bucket in sorted(set(buckets)):
            for cfg in configs:
                futures.append(self.submit(ServeRequest(
                    prompt=[1] * min(bucket, cap), max_new_tokens=max_new,
                    **cfg)))
        for future in futures:
            future.result(timeout=600)
        self._reset_stats()

    def stats(self):
        """Host-side rollup of the traffic since start (or warmup)."""
        wall = max(time.monotonic() - self._t_start, 1e-9)
        return {
            "requests_completed": self._completed,
            "tokens_emitted": self._tokens_out,
            "ticks": self._ticks,
            "elapsed_seconds": wall,
            "requests_per_sec": self._completed / wall,
            "tokens_per_sec": self._tokens_out / wall,
            "ttft": self._ttft_hist.snapshot(),
            "token_latency": self._token_hist.snapshot(),
            "queue_wait": self._queue_wait_hist.snapshot(),
            "reserve_wait": self._reserve_wait_hist.snapshot(),
            "prefill": self._prefill_hist.snapshot(),
            "queue_depth": self._admit_q.qsize(),
            "pool": self.pool.pool_stats(),
            "kv": {"page_dtype": self.kv_dtype,
                   "page_bytes": self.pool.page_bytes},
        }


__all__ = ["Scheduler", "ServeRequest", "ServeResult"]
