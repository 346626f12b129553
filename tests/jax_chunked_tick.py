"""The JAX smoke's chunked scenario, measured for its arrivals per tick.

`cloud_tpu/serving/smoke.py` offers its chunked mix 50 ms apart. The
port's smoke (`cloud_tpu_torch/serving/smoke.py`) offers the same mix
`ARRIVAL_TICKS` warm ticks apart, so that a device whose tick is much
shorter runs the same traffic. This script serves JAX's mix, both legs,
as JAX's smoke does, and prints the tick p50 of each leg (the engine's
tick, timed to its output) and 50 ms over it:

    JAX_PLATFORMS=cpu python tests/jax_chunked_tick.py
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cloud_tpu.serving import Scheduler, smoke  # noqa: E402

INTERVAL_S = 0.05   # JAX's smoke: seconds between the chunked arrivals


def main():
    model = smoke.build_model(max_seq_len=512)
    seeder, requests = smoke.build_chunked_requests(model)
    params = model.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    out = {}
    for chunk in (smoke.CHUNK_SIZE, 0):
        slots = 4
        pages_per_slot = model.max_seq_len // 16
        scheduler = Scheduler(model, params, slots=slots, page_size=16,
                              num_pages=(slots + 4) * pages_per_slot + 1,
                              admission_window=len(requests),
                              strict_no_retrace=True,
                              prefill_chunk=chunk).start()
        try:
            buckets = sorted({scheduler._bucket(r)
                              for r in [seeder] + requests})
            scheduler.warmup(buckets,
                             sampling_configs=[(("temperature", 0.0),)])
            ticks = []
            tick = scheduler.engine.tick

            def timed_tick(*args, **kwargs):
                t0 = time.perf_counter()
                result = jax.block_until_ready(tick(*args, **kwargs))
                ticks.append(time.perf_counter() - t0)
                return result

            scheduler.engine.tick = timed_tick
            scheduler.submit(seeder, timeout=30).result(timeout=600)
            futures = []
            for req in requests:
                futures.append(scheduler.submit(req, timeout=30))
                time.sleep(INTERVAL_S)
            for future in futures:
                future.result(timeout=600)
            p50 = statistics.median(ticks)
            out["chunked" if chunk else "unchunked"] = {
                "ticks": len(ticks), "tick_p50_s": p50,
                "arrival_ticks": INTERVAL_S / p50}
        finally:
            scheduler.close()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
