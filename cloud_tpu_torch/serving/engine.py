"""Serving decode engine: a slot-indexed continuous decode tick over a
paged KV pool; the port of the plain `cloud_tpu/serving/engine.py`
`DecodeEngine`.

A tick advances every active slot by one token: one decode-mode
forward of the model over the paged cache (each layer's attention is
`ops.paged_attention`, the CUDA kernel on the card), one sampler pass,
one counted device->host fetch of the sampled tokens. Requests enter
mid-flight: a dense canonical right-pad prefill (safe on an admission
thread) is scattered into a free slot's pages by `insert`, and leave
mid-flight: `evict` zeros the finished slots' page-table and validity
rows.

Per-slot control state (sampling config, eos latch, step counters,
per-step seeds) lives on the host as numpy; the device holds the cache.
The sampler (`cloud_tpu`'s `_sample_slots`/`_sample_one`) is
`decoding.sample_slots`/`sample_one`, shared with `generate()`.
A request decoded through the engine produces the tokens
`models.transformer.generate()` produces for it solo with the same
seed: both run the same prefill, the same page scatter and the same
per-slot kernel, and draw from the same per-step seeds.

Speculation, ladder resize, chunked prefill, the prefix gather and the
host page tier are not ported: their arguments and methods raise
NotImplementedError.
"""

import dataclasses
import time

import numpy as np
import torch

from cloud_tpu_torch.models import decoding
from cloud_tpu_torch.monitoring import spans
from cloud_tpu_torch.parallel import runtime


@dataclasses.dataclass
class PrefillResult:
    """A prefilled request waiting for slot insertion."""
    first_token: int        # drawn from the prompt's last position
    pcache: object          # dense [1, L] decode cache (device)
    step_seeds: np.ndarray  # [max_new_cap] int64; entry i seeds step i
    bucket: int             # pow2 bucket the prefill ran at
    n_steps: int            # max_new_tokens for this request
    prompt_len: int


class DecodeEngine:
    """Continuous-batching decode over `slots` slots of a paged pool.

    Single-owner device state: one thread calls `insert`/`tick`/`evict`
    (the scheduler's tick thread); `prefill` may run concurrently on an
    admission thread.
    """

    def __init__(self, model, slots, page_size, num_pages,
                 max_new_cap=None, draft_model=None, draft_params=None,
                 spec_k=0, page_dtype="", ladder=None):
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
                    "{}: speculative decoding is not ported.".format(name))
        if ladder is not None and tuple(ladder) != (int(slots),):
            raise NotImplementedError("ladder: resize is not ported.")
        if model.max_seq_len % page_size:
            raise ValueError(
                "max_seq_len ({}) must be a multiple of page_size "
                "({}).".format(model.max_seq_len, page_size))
        if page_dtype not in ("", "int8"):
            raise ValueError(
                "page_dtype must be '' or 'int8'; got {!r}.".format(
                    page_dtype))
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

    # -- prefill ------------------------------------------------------

    def prefill(self, prompt, max_new_tokens, seed, sampling,
                prefix_len=0, gather_vec=None, key_override=None):
        """Canonical right-pad prefill for one request (`sampling`: the
        normalized dict of temperature, top_k, top_p, eos_token).
        Returns a `PrefillResult`; blocks until the first token is on
        the host (the TTFT point)."""
        if prefix_len or gather_vec is not None:
            raise NotImplementedError(
                "prefix_len/gather_vec: the prefix-cache gather is not "
                "ported.")
        if key_override is not None:
            raise NotImplementedError(
                "key_override: fault requeue is not ported.")
        t0_ns = time.monotonic_ns()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        seeds = decoding.sample_seeds(seed, 1, max_new_tokens)[0]
        first, pcache, bucket = decoding.prefill_request(
            self.model, prompt, seeds[0], sampling)
        step_seeds = np.zeros((self.max_new_cap,), np.int64)
        step_seeds[:seeds.shape[0]] = seeds
        first_host = int(runtime.device_fetch(first))
        spans.complete("serve_prefill", t0_ns, time.monotonic_ns() - t0_ns)
        return PrefillResult(first_token=first_host, pcache=pcache,
                             step_seeds=step_seeds, bucket=bucket,
                             n_steps=int(max_new_tokens),
                             prompt_len=int(prompt.shape[0]))

    def prefill_chunks(self, *args, **kwargs):
        raise NotImplementedError("chunked prefill is not ported.")

    def release_prefill(self, result):
        """Drops a consumed (or abandoned) prefill's dense cache."""
        result.pcache = None

    # -- slot ops (tick thread) ---------------------------------------

    def insert(self, slot, result, page_vec, scatter_vec, sampling):
        """Writes a prefilled request into free slot `slot`: its dense
        cache goes to the pages of `scatter_vec` (`_scatter_request`),
        its page table row becomes `page_vec`, and the slot's control
        row is armed."""
        self._scatter_request(result.pcache, slot, page_vec, scatter_vec)
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

    def _scatter_request(self, pcache, slot, page_vec, scatter_vec):
        """One request's dense prefill cache into the paged pool (the
        int8 pool quantizes here); see `decoding.scatter_prefill`."""
        decoding.scatter_prefill(self.cache, pcache, slot, page_vec,
                                 scatter_vec)

    def tick(self):
        """Advances every active slot by one token. Returns the host
        array `[2, S]`: row 0 the sampled token (-1 on inactive slots),
        row 1 the finished flag."""
        ctl = self.ctl
        active = ctl["active"].copy()
        dev = self.device
        tokens = torch.from_numpy(ctl["cur_tok"]).to(dev)
        mask = torch.from_numpy(active).to(dev)
        logits = self.model(tokens[:, None], mask[:, None], self.cache)
        rows = np.arange(self.slots)
        key_idx = np.clip(ctl["steps_done"], 0, self.max_new_cap - 1)
        seeds = ctl["step_seeds"][rows, key_idx]
        live_temp = np.where(active, ctl["temperature"], 0.0)
        nxt = decoding.sample_slots(logits[:, 0], seeds, live_temp,
                                    ctl["top_k"], ctl["top_p"])
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
        validity rows go back to scratch/zero, the control row disarms.
        The page ids go back to the host pool separately."""
        evict_mask = np.asarray(evict_mask, bool)
        gone = torch.from_numpy(evict_mask).to(self.device)
        for att in self.cache["layers"]:
            att["page_table"].masked_fill_(gone[:, None], 0)
            att["slot_steps"] = att["slot_steps"].masked_fill(gone, 0)
            att["slot_valid"].masked_fill_(gone[:, None], False)
        self.cache["pos_count"].masked_fill_(gone, 0)
        ctl = self.ctl
        keep = ~evict_mask
        ctl["active"] &= keep
        ctl["done"] &= keep
        for name in ("steps_done", "cur_tok", "max_steps"):
            ctl[name] = np.where(keep, ctl[name], 0)

    def resize(self, new_slots, perm):
        raise NotImplementedError("ladder resize is not ported.")

    def snapshot_pages(self, page_ids):
        raise NotImplementedError("the host page tier is not ported.")

    def promote_pages(self, host_tree, page_ids, n_skip=0):
        raise NotImplementedError("the host page tier is not ported.")

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


__all__ = ["DecodeEngine", "PrefillResult"]
