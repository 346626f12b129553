"""The port's input pipeline against the JAX package on the CPU: the
wire casts (`InputCast` against JAX's `host_cast` / `widen`), the
device-resident dataset (its order against `epoch_permutation`, its fit
against the host-fed fit, zero host->device example bytes after the
upload, the memory-budget fallbacks), the streaming datasets
(`GeneratorDataset`, `NpzShardDataset`, `ThreadedDataset`) and
`prefetch_to_device`.

Tolerances, with their reasons:
- the bf16 cast: bit for bit (round to nearest even on both sides, torch
  against ml_dtypes); the uint8 cast: bit for bit on the host (the same
  numpy arithmetic), the widening within 1 ulp (XLA may contract the
  multiply-add).
- orders and batches: bit for bit (integer threefry, the same stable
  sorts).
- fits fed the same batches by different routes in the port: bit for
  bit (the same operations on the same values); a port fit against
  JAX's: 1e-5 (f32 MLP, other summation orders).
"""

import logging
import threading
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import mnist as jmnist
from cloud_tpu.training import data as jdata
from cloud_tpu.training import trainer as jtrainer
from cloud_tpu_torch.models import convert
from cloud_tpu_torch.models import mnist as tmnist
from cloud_tpu_torch.parallel import runtime
from cloud_tpu_torch.training import data as tdata
from cloud_tpu_torch.training import trainer as ttrainer


def _xy(n=96, seed=0, classes=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, classes, size=n).astype(np.int32)
    return x, y


def _mlp(seed=0):
    return tmnist.MLP(hidden=16, num_classes=4, in_features=8,
                      compute_dtype=torch.float32, device="cpu", seed=seed)


def _trainer(**kw):
    kw.setdefault("optimizer", ttrainer.make_optimizer("sgd", 0.1))
    return ttrainer.Trainer(_mlp(), seed=0, **kw)


def _params(trainer):
    return {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}


def _assert_same(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- input casts ------------------------------------------------------------

def test_bf16_cast_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    x = {"img": (rng.normal(size=(64, 5)) * 100).astype(np.float32),
         "ids": rng.integers(0, 9, size=(64,))}
    jp = jdata.make_input_cast("bfloat16", x)
    tp = tdata.make_input_cast("bfloat16", x)
    jx, tx = jp.host_cast(x), tp.host_cast(x)
    assert tx["img"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tx["img"].float().numpy(),
                                  np.asarray(jx["img"], np.float32))
    np.testing.assert_array_equal(tx["ids"], jx["ids"])
    np.testing.assert_array_equal(
        tp.widen({k: torch.as_tensor(v) for k, v in tx.items()})["img"]
        .numpy(), np.asarray(jp.widen(jx)["img"]))
    assert tp.cast_nbytes(x) == jp.cast_nbytes(x)


def test_uint8_cast_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-3, 5, size=(50, 7)).astype(np.float32)
    jp = jdata.make_input_cast("uint8", x)
    tp = tdata.make_input_cast("uint8", x)
    assert tp.cache_key == jp.cache_key
    jq, tq = jp.host_cast(x), tp.host_cast(x)
    assert tq.dtype == torch.uint8
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_allclose(tp.widen(tq).numpy(),
                               np.asarray(jp.widen(jnp.asarray(jq))),
                               rtol=1.2e-7, atol=1e-6)
    assert tp.cast_nbytes(x) == jp.cast_nbytes(x)


def test_uint8_grid_data_round_trips_exactly():
    grid = np.random.default_rng(3).integers(0, 256, size=(40, 6))
    grid[0, :2] = (0, 255)          # the grid's ends fix lo and scale
    x = (grid / 255.0).astype(np.float32)
    tp = tdata.make_input_cast("uint8", x)
    np.testing.assert_allclose(tp.widen(tp.host_cast(x)).numpy(), x,
                               atol=1e-6)


def test_cast_policies_keep_ints_and_reject_unknown():
    x = np.arange(6, dtype=np.int64).reshape(3, 2)
    assert tdata.make_input_cast("bfloat16", x).host_cast(x) is x
    assert tdata.make_input_cast(None, x) is None
    with pytest.raises(ValueError, match="input_cast"):
        tdata.make_input_cast("fp8", x)


@pytest.mark.parametrize("policy", ["bfloat16", "uint8"])
def test_cast_fit_matches_jax(policy):
    """A fit under an input cast against JAX's fit under the same cast
    (the same narrowed values, widened as the step's first op)."""
    x, y = _xy(96)
    jt = jtrainer.Trainer(jmnist.MLP(hidden=16, num_classes=4,
                                     compute_dtype=jnp.float32),
                          optimizer=optax.sgd(0.1, momentum=0.9), seed=0)
    jt.build(x)
    tt = _trainer()
    tt.build(x, variables=convert.image_params_from_flax(
        {"params": jt.state.params}))
    jh = jt.fit(x, y, epochs=2, batch_size=32, input_cast=policy,
                verbose=False)
    th = tt.fit(x, y, epochs=2, batch_size=32, input_cast=policy,
                verbose=False)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    np.testing.assert_allclose(th["accuracy"], jh["accuracy"], rtol=1e-5)


# -- the device-resident dataset --------------------------------------------

@pytest.mark.parametrize("n", [7, 1000, 70000])
def test_device_permutation_equals_epoch_permutation(n):
    for seed, epoch in ((0, 0), (3, 5)):
        np.testing.assert_array_equal(
            tdata.device_permutation(n, seed, epoch, "cpu").numpy(),
            tdata.epoch_permutation(n, seed, epoch))


def test_resident_order_equals_host_order():
    x, y = _xy(40)
    ds = tdata.ArrayDataset(x, y, batch_size=8, shuffle=True, seed=5)
    res = tdata.DeviceResidentDataset(ds, device="cpu")
    for epoch in range(3):
        order = res.epoch_order(epoch)
        np.testing.assert_array_equal(order.numpy(),
                                      tdata.epoch_permutation(40, 5, epoch))
        host = list(ds)
        for step, (xb, yb) in enumerate(host):
            gx, gy = res.gather(order[step * 8:(step + 1) * 8])
            np.testing.assert_array_equal(gx.numpy(), xb)
            np.testing.assert_array_equal(gy.numpy(), yb)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("cast", [None, "uint8"])
def test_resident_fit_equals_host_fit(weighted, cast):
    x, y = _xy(96)
    kw = dict(epochs=3, batch_size=16, verbose=False, input_cast=cast)
    if weighted:
        kw["sample_weight"] = np.linspace(0.5, 1.5, 96).astype(np.float32)
    a, b = _trainer(), _trainer()
    ha = a.fit(x, y, **kw)
    hb = b.fit(x, y, cache="device", **kw)
    assert ha == {k: hb[k] for k in ha if k != "steps_per_sec"} | {
        "steps_per_sec": ha["steps_per_sec"]}
    _assert_same(_params(a), _params(b))


@pytest.mark.parametrize("cast", [None, "bfloat16", "uint8"])
def test_resident_fit_trains_on_arrays_changed_in_place(cast):
    # Each fit uploads anew, as JAX's: a buffer refilled in place between
    # two fits is trained on as it is at the second fit, the same as
    # fresh arrays with those values.
    x, y = _xy(64)
    kw = dict(epochs=1, batch_size=16, cache="device", input_cast=cast,
              verbose=False)
    refilled, fresh = _trainer(), _trainer()
    h1 = refilled.fit(x, y, **kw)
    g1 = fresh.fit(x.copy(), y.copy(), **kw)
    x *= -2.0
    y[:] = y[::-1].copy()
    h2 = refilled.fit(x, y, **kw)
    g2 = fresh.fit(x.copy(), y.copy(), **kw)
    assert h1["loss"] == g1["loss"] and h2["loss"] == g2["loss"]
    _assert_same(_params(refilled), _params(fresh))


def test_resident_composes_with_accumulation_and_spe():
    x, y = _xy(80)
    kw = dict(epochs=2, batch_size=16, verbose=False)
    a = _trainer(gradient_accumulation_steps=2)
    b = _trainer(gradient_accumulation_steps=2, steps_per_execution=2)
    ha = a.fit(x, y, **kw)
    hb = b.fit(x, y, cache="device", **kw)
    assert ha["loss"] == hb["loss"]
    assert a.state.step == b.state.step == 10
    _assert_same(_params(a), _params(b))


def test_zero_h2d_example_bytes_after_upload():
    x, y = _xy(128)
    trainer = _trainer()
    runtime.reset_transfer_stats()
    trainer.fit(x, y, epochs=3, batch_size=16, cache="device",
                input_cast="uint8", verbose=False)
    stats = runtime.transfer_stats()
    # One upload of the narrowed features (1 byte each) and the int64
    # labels, and nothing after it.
    assert stats["h2d_transfers"] == 2
    assert stats["h2d_bytes"] == 128 * 8 + 128 * 8
    assert stats["d2h_fetches"] == 3


def test_host_fit_counts_every_feed():
    x, y = _xy(64)
    runtime.reset_transfer_stats()
    _trainer().fit(x, y, epochs=1, batch_size=16, verbose=False,
                   input_cast="bfloat16")
    stats = runtime.transfer_stats()
    assert stats["h2d_transfers"] == 4 * 2
    assert stats["h2d_bytes"] == 4 * (16 * 8 * 2 + 16 * 8)


def test_budget_fallback_warns_once_and_streams(monkeypatch, caplog):
    x, y = _xy(64)
    monkeypatch.setenv("CLOUD_TPU_RESIDENT_HBM_BUDGET", "100")
    a, b = _trainer(), _trainer()
    with caplog.at_level(logging.WARNING, logger="cloud_tpu_torch"):
        hb = b.fit(x, y, epochs=2, batch_size=16, cache="device",
                   verbose=False)
    warnings = [r for r in caplog.records if "cache='device'" in r.message]
    assert len(warnings) == 1 and "budget 100" in warnings[0].message
    ha = a.fit(x, y, epochs=2, batch_size=16, verbose=False)
    assert ha["loss"] == hb["loss"]


def test_non_array_and_ragged_tail_fall_back(caplog):
    x, y = _xy(40)
    with caplog.at_level(logging.WARNING, logger="cloud_tpu_torch"):
        assert tdata.DeviceResidentDataset.build(
            [(x[:8], y[:8])], device="cpu") is None
        ragged = tdata.ArrayDataset(x, y, batch_size=16,
                                    drop_remainder=False)
        assert tdata.DeviceResidentDataset.build(ragged,
                                                 device="cpu") is None
        small = tdata.ArrayDataset(x[:4], y[:4], batch_size=8)
        assert tdata.DeviceResidentDataset.build(small, device="cpu") is None
    messages = [r.message for r in caplog.records]
    assert sum("cache='device'" in m for m in messages) == 3
    with pytest.raises(ValueError, match="ragged tail"):
        tdata.DeviceResidentDataset(ragged, device="cpu")
    with pytest.raises(ValueError, match="cache"):
        _trainer().fit(x, y, batch_size=8, cache="disk", verbose=False)


# -- streaming datasets and the prefetcher ----------------------------------

def _batches(x, y, b):
    return [(x[i:i + b], y[i:i + b]) for i in range(0, len(x) - b + 1, b)]


def test_generator_dataset_fit_matches_jax_and_arrays():
    x, y = _xy(64)
    batches = _batches(x, y, 16)
    jt = jtrainer.Trainer(jmnist.MLP(hidden=16, num_classes=4,
                                     compute_dtype=jnp.float32),
                          optimizer=optax.sgd(0.1, momentum=0.9), seed=0)
    jt.build(x)
    variables = convert.image_params_from_flax({"params": jt.state.params})
    jh = jt.fit(jdata.GeneratorDataset(lambda: iter(batches)), epochs=2,
                verbose=False)
    streams = {
        "generator": tdata.GeneratorDataset(lambda: iter(batches)),
        "threaded": tdata.ThreadedDataset(
            tdata.GeneratorDataset(lambda: iter(batches)), buffer_size=2),
        "list": list(batches)}
    histories = {}
    for name, stream in streams.items():
        tt = _trainer()
        tt.build(x, variables=variables)
        histories[name] = tt.fit(stream, epochs=2, verbose=False)
        np.testing.assert_allclose(histories[name]["loss"], jh["loss"],
                                   rtol=1e-5)
    arrays = _trainer()
    arrays.build(x, variables=variables)
    ha = arrays.fit(x, y, epochs=2, batch_size=16, shuffle=False,
                    verbose=False)
    for h in histories.values():
        assert h["loss"] == ha["loss"]


def test_generator_dataset_fresh_iterator_and_steps_cap():
    x, y = _xy(64)
    pulls = []

    def endless():
        i = 0
        while True:
            pulls.append(i)
            yield x[:16], y[:16]
            i += 1

    ds = tdata.GeneratorDataset(endless, steps_per_epoch=3)
    trainer = _trainer()
    trainer.fit(ds, epochs=2, verbose=False, prefetch=0)
    assert trainer.state.step == 6
    # The build peek pulls one batch; each epoch pulls exactly three.
    assert len(pulls) == 1 + 6
    with pytest.raises(TypeError, match="callable"):
        tdata.GeneratorDataset(5)
    assert tdata.as_dataset(ds) is ds


def test_npz_shard_dataset_round_trip(tmp_path):
    x, y = _xy(50)
    paths = []
    for i, (lo, hi) in enumerate(((0, 40), (40, 50))):
        path = str(tmp_path / "shard{}.npz".format(i))
        np.savez(path, x=x[lo:hi], y=y[lo:hi])
        paths.append(path)
    got = list(tdata.NpzShardDataset(paths, batch_size=16))
    want = list(jdata.NpzShardDataset(paths, batch_size=16))
    assert [len(b[0]) for b in got] == [16, 16, 10]
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    trainer = _trainer()
    trainer.fit(tdata.NpzShardDataset(paths, batch_size=16), epochs=1,
                verbose=False)
    assert trainer.state.step == 3  # the 10-row shard runs as one step
    with pytest.raises(ValueError):
        tdata.NpzShardDataset([], batch_size=4)


def test_threaded_dataset_order_errors_and_shutdown():
    ds = tdata.ThreadedDataset(list(range(20)), buffer_size=3)
    assert list(ds) == list(range(20)) == list(ds)

    def broken():
        yield 1
        raise RuntimeError("producer failed")

    with pytest.raises(RuntimeError, match="producer failed"):
        list(tdata.ThreadedDataset(tdata.GeneratorDataset(broken)))
    before = threading.active_count()
    it = iter(tdata.ThreadedDataset(
        tdata.GeneratorDataset(lambda: iter(range(10 ** 6))),
        buffer_size=2))
    next(it)
    it.close()
    time.sleep(0.2)
    assert threading.active_count() <= before
    with pytest.raises(TypeError, match="re-iterable"):
        tdata.ThreadedDataset(iter([1, 2]))
    assert tdata.ThreadedDataset(tdata.GeneratorDataset(
        lambda: iter([]), steps_per_epoch=7)).steps_per_epoch == 7


@pytest.mark.parametrize("size", [0, 1, 3])
def test_prefetch_to_device_yields_all_and_counts(size):
    x, y = _xy(40)
    batches = _batches(x, y, 8)
    runtime.reset_transfer_stats()
    got = list(tdata.prefetch_to_device(iter(batches), size=size,
                                        device="cpu"))
    assert len(got) == 5
    for (gx, gy), (hx, hy) in zip(got, batches):
        np.testing.assert_array_equal(gx.numpy(), hx)
        assert gy.dtype == torch.int64
        np.testing.assert_array_equal(gy.numpy(), hy)
    assert runtime.transfer_stats()["h2d_transfers"] == 10
    pulled = []

    def source():
        for i, b in enumerate(batches):
            pulled.append(i)
            yield b

    out = list(tdata.prefetch_to_device(source(), size=size, limit=2,
                                        device="cpu"))
    assert len(out) == 2 and len(pulled) == 2


def test_as_dataset_resolution():
    x, y = _xy(16)
    assert isinstance(tdata.as_dataset(x, y), tdata.ArrayDataset)
    assert isinstance(tdata.as_dataset({"a": x}), tdata.ArrayDataset)
    assert isinstance(tdata.as_dataset([x, x]), tdata.ArrayDataset)
    batches = _batches(x, y, 8)
    assert tdata.as_dataset(batches) is batches
    assert tdata.as_dataset(iter(batches)) == batches
