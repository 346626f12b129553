"""Input pipeline: batched, shuffled iteration over in-memory arrays and
streams, the wire casts, the device-resident dataset and the device
read-ahead.

The port of `cloud_tpu/training/data.py`: `epoch_permutation`,
`ArrayDataset`, `InputCast` / `make_input_cast`,
`DeviceResidentDataset`, `GeneratorDataset`, `NpzShardDataset`,
`ThreadedDataset`, `prefetch_to_device` and `as_dataset`. Batches are
numpy (or, after an input cast, CPU tensors); the Trainer moves them to
the model's device through `prefetch_to_device`, which counts every
host->device feed (`runtime.record_h2d`).

`epoch_permutation` reproduces the JAX package's shuffle order bit for
bit without JAX: the threefry2x32 generator, `fold_in`, `split` and
`random_bits` are written out in numpy below, with the semantics JAX
has under `jax_threefry_partitionable=True` (its default since JAX
0.5, and the setting of the JAX this port is tested against), and the
permutation is JAX's `_shuffle`: ceil(3 ln n / ln(2^32 - 1)) rounds of
a stable sort on fresh 32-bit keys. `device_permutation` draws the
same order on a device (the keys' words reach the kernels as scalars,
so nothing crosses the wire), as the JAX resident executable does
in-graph.

No `ml_dtypes` here: the bf16 wire cast narrows through torch (round
to nearest even, as ml_dtypes does).
"""

import collections
import io
import itertools
import logging
import os
import queue as queue_lib
import threading

import math

import numpy as np
import torch

from cloud_tpu_torch.parallel import runtime as runtime_lib

logger = logging.getLogger("cloud_tpu_torch")

_U32 = np.uint32


def _rotl(x, d):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) over uint32 arrays
    x0, x1 with the uint32 key pair `key`; returns the two output words
    (JAX's `threefry2x32_p`)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed):
    """`jax.random.PRNGKey(seed)` as a uint32 pair: (high, low) 32 bits
    of the seed."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def fold_in(key, data):
    """`jax.random.fold_in`: threefry of the counter pair (0, data)."""
    y0, y1 = threefry2x32(key, np.zeros(1, _U32),
                          np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([y0[0], y1[0]], _U32)


def split(key, num=2):
    """`jax.random.split` (partitionable): key i is threefry of the
    counter pair (0, i)."""
    y0, y1 = threefry2x32(key, np.zeros(num, _U32), np.arange(num,
                                                             dtype=_U32))
    return np.stack([y0, y1], axis=1)


def random_bits32(key, n):
    """`jax.random.bits(key, (n,), uint32)` (partitionable): the xor of
    the two threefry words of counter i."""
    y0, y1 = threefry2x32(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    return y0 ^ y1


def permutation(key, n):
    """`jax.random.permutation(key, n)` for an int n."""
    x = np.arange(n)
    rounds = int(math.ceil(3 * math.log(max(1, n))
                           / math.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, subkey = split(key)
        x = x[np.argsort(random_bits32(subkey, n), kind="stable")]
    return x


def epoch_permutation(num_examples, seed, epoch):
    """The canonical per-epoch shuffle order:
    `permutation(fold_in(PRNGKey(seed), epoch), num_examples)`, the same
    order the JAX package's host and device-resident paths draw."""
    return permutation(fold_in(prng_key(seed), epoch), int(num_examples))


_MASK32 = 0xFFFFFFFF


def _threefry2x32_on(key, x0, x1):
    """`threefry2x32` over int64 tensors holding uint32 words (each
    result masked back to 32 bits); the key's words are Python ints."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _MASK32
    return x0, x1


def device_permutation(num_examples, seed, epoch, device):
    """`epoch_permutation` drawn on `device` (an int64 tensor): the
    same threefry words and stable sorts, with only the four key words
    of each round passed to the kernels as scalars."""
    n = int(num_examples)
    key = fold_in(prng_key(seed), epoch)
    x = torch.arange(n, device=device)
    counter = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(math.ceil(3 * math.log(max(1, n))
                           / math.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, subkey = split(key)
        y0, y1 = _threefry2x32_on(subkey, torch.zeros_like(counter),
                                  counter)
        order = torch.sort(y0 ^ y1, stable=True).indices
        x = x[order]
    return x


def _leaves(x):
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _take(x, idx):
    if isinstance(x, dict):
        return {k: _take(v, idx) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_take(v, idx) for v in x)
    return np.asarray(x)[idx]


class ArrayDataset:
    """In-memory dataset of (features, labels) arrays.

    Args:
        x: array (or dict/list/tuple of arrays) with a common leading
            dimension.
        y: optional labels.
        batch_size: batch size.
        shuffle: reshuffle each epoch (`epoch_permutation`).
        seed: shuffle seed.
        drop_remainder: drop the tail batch (True), or pad it by
            wrapping around the epoch order (False).
        sample_weight: optional [num_examples] per-example weights; when
            set, batches are (x, y, w) triples.
    """

    def __init__(self, x, y=None, batch_size=32, shuffle=False, seed=0,
                 drop_remainder=True, sample_weight=None):
        self.x = x
        self.y = None if y is None else np.asarray(y)
        leaves = _leaves(x)
        if not leaves:
            raise ValueError("Empty dataset.")
        self.num_examples = np.asarray(leaves[0]).shape[0]
        if self.y is not None and self.y.shape[0] != self.num_examples:
            raise ValueError(
                "x has {} examples but y has {}.".format(
                    self.num_examples, self.y.shape[0]))
        if sample_weight is not None:
            sample_weight = np.asarray(sample_weight, np.float32)
            if sample_weight.shape != (self.num_examples,):
                raise ValueError(
                    "sample_weight must be [num_examples]={}; got "
                    "shape {}.".format((self.num_examples,),
                                       sample_weight.shape))
        self.sample_weight = sample_weight
        if batch_size <= 0:
            raise ValueError("batch_size must be positive.")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0

    @property
    def steps_per_epoch(self):
        if self.drop_remainder:
            return self.num_examples // self.batch_size
        return -(-self.num_examples // self.batch_size)

    def _epoch_order(self):
        if self.shuffle:
            return epoch_permutation(self.num_examples, self.seed,
                                     self._epoch)
        return np.arange(self.num_examples)

    def __iter__(self):
        """Yields one epoch of numpy batches: x, (x, y) or (x, y, w)."""
        return self.iter_from(0)

    def iter_from(self, start_step):
        """One epoch's batches from batch index `start_step` on (the
        mid-epoch resume entry point): the permutation `__iter__` would
        draw for this epoch, with the first `start_step` batches skipped
        without being gathered. The epoch counter advances at the first
        `next()`, as with `__iter__`."""
        order = self._epoch_order()
        self._epoch += 1
        for step in range(int(start_step), self.steps_per_epoch):
            idx = order[step * self.batch_size:(step + 1) * self.batch_size]
            if len(idx) < self.batch_size:
                # Pad the tail by tiling the epoch order (works even when
                # the whole dataset is smaller than one batch).
                idx = np.concatenate(
                    [idx, np.resize(order, self.batch_size - len(idx))])
            xb = _take(self.x, idx)
            if self.sample_weight is not None:
                yield xb, (None if self.y is None else self.y[idx]), \
                    self.sample_weight[idx]
            elif self.y is None:
                yield xb
            else:
                yield xb, self.y[idx]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def to_tensor(a):
    """A host leaf as a CPU tensor in the dtype the Trainer feeds:
    floats of more than 32 bits to f32 (JAX's default canonicalisation),
    other floats kept; integers to int64 (the losses' index type);
    bools kept. A tensor (an input cast's narrowed leaf) is kept as it
    is."""
    if isinstance(a, torch.Tensor):
        return a
    t = torch.as_tensor(np.asarray(a))
    if t.dtype == torch.float64:
        return t.float()
    if t.dtype.is_floating_point or t.dtype in (torch.bool, torch.uint8):
        return t
    return t.long()


def _pinned(t):
    """`t` in pinned host memory when a card is there (an asynchronous
    copy needs it); as it is otherwise."""
    if torch.cuda.is_available() and t.device.type == "cpu" \
            and not t.is_pinned():
        return t.pin_memory()
    return t


class _LeafCast:
    """Per-leaf transfer decision: "keep", "bf16" or "uint8" (with lo
    and scale)."""

    __slots__ = ("mode", "lo", "scale")

    def __init__(self, mode, lo=None, scale=None):
        self.mode = mode
        self.lo = lo
        self.scale = scale


class InputCast:
    """A narrow-on-the-wire transfer policy for feature batches.

    The host narrows features before the copy to the device
    (`host_cast`); the train step widens them back to float32 as its
    first operation (`widen`), so the model computes in its own dtype
    and only the wire (or the resident copy) pays the narrow format:

    - "bfloat16": float leaves cross as bf16 (2x fewer bytes; through
      torch, round to nearest even), parameterless (works on streams).
    - "uint8": float leaves cross as affine-quantized uint8 (4x fewer
      bytes): q = clip(round_half_even((a - lo) / scale), 0, 255), with
      lo / scale from the full arrays, so it needs an `ArrayDataset`.
      Data already on a 255-point grid round-trips exactly.

    Integer and bool leaves are never touched. Build instances through
    `make_input_cast`.
    """

    def __init__(self, name, specs):
        self.name = name
        self._specs = specs

    @property
    def cache_key(self):
        """Hashable identity of the policy (its name and every leaf's
        mode, lo and scale)."""
        leaves = []
        _map(lambda s: leaves.append((s.mode, s.lo, s.scale)),
             self._specs)
        return (self.name,) + tuple(leaves)

    def host_cast(self, x):
        """Narrows a host feature batch for the wire: a narrowed leaf
        becomes a CPU tensor (bf16 or uint8, pinned when a card is
        there); a kept leaf stays as it is."""
        def leaf(a, spec):
            if spec.mode == "bf16":
                t = torch.as_tensor(np.asarray(a))
                return _pinned(t.to(torch.bfloat16))
            if spec.mode == "uint8":
                q = np.round((np.asarray(a, np.float32) - spec.lo)
                             / spec.scale)
                return _pinned(torch.from_numpy(
                    np.clip(q, 0, 255).astype(np.uint8)))
            return a
        return _map2(leaf, x, self._specs)

    def widen(self, x):
        """Inverse of `host_cast` on device tensors: f32 again."""
        def leaf(a, spec):
            if spec.mode == "bf16":
                return a.float()
            if spec.mode == "uint8":
                return a.float() * spec.scale + spec.lo
            return a
        return _map2(leaf, x, self._specs)

    def cast_nbytes(self, x):
        """Bytes of `x` after the cast (nothing materialised)."""
        total = [0]

        def leaf(a, spec):
            size = int(np.prod(np.shape(a)))
            if spec.mode == "bf16":
                total[0] += size * 2
            elif spec.mode == "uint8":
                total[0] += size
            else:
                total[0] += int(np.asarray(a).nbytes)
        _map2(leaf, x, self._specs)
        return total[0]


def make_input_cast(policy, x):
    """Builds an `InputCast` for feature tree `x`.

    Args:
        policy: None/"none" (returns None), "bfloat16"/"bf16", "uint8",
            or an existing `InputCast` (passed through).
        x: the feature tree the policy will apply to: the full arrays
            for "uint8" (range calibration), any representative sample
            for "bfloat16".
    """
    if policy is None or policy == "none":
        return None
    if isinstance(policy, InputCast):
        return policy

    def is_float(a):
        if isinstance(a, torch.Tensor):
            return a.dtype.is_floating_point
        return np.issubdtype(np.asarray(a).dtype, np.floating)

    def itemsize(a):
        if isinstance(a, torch.Tensor):
            return a.element_size()
        return np.asarray(a).dtype.itemsize

    if policy in ("bfloat16", "bf16"):
        return InputCast("bfloat16", _map(
            lambda a: _LeafCast("bf16" if is_float(a) and itemsize(a) > 2
                                else "keep"), x))
    if policy == "uint8":
        def spec(a):
            if not is_float(a):
                return _LeafCast("keep")
            a = np.asarray(a)
            lo = float(a.min())
            hi = float(a.max())
            scale = (hi - lo) / 255.0 or 1.0
            return _LeafCast("uint8", lo=lo, scale=scale)
        return InputCast("uint8", _map(spec, x))
    raise ValueError(
        "Unknown input_cast {!r}; expected None, 'bfloat16' or "
        "'uint8'.".format(policy))


def _resident_budget(device):
    """Byte budget for the resident upload on `device`:
    CLOUD_TPU_RESIDENT_HBM_BUDGET (bytes) when set, else 60 % of the
    card's memory (room for parameters, gradients, moments and
    activations); None (no check) off a card."""
    env = os.environ.get("CLOUD_TPU_RESIDENT_HBM_BUDGET")
    if env:
        try:
            return int(float(env))
        except ValueError:
            logger.warning("Ignoring malformed "
                           "CLOUD_TPU_RESIDENT_HBM_BUDGET=%r", env)
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * 0.6)


class DeviceResidentDataset:
    """An `ArrayDataset` uploaded to the device once.

    Training from it then moves no example bytes host->device: the
    Trainer gathers each batch on the device from the uploaded tensors,
    in the order `device_permutation` draws (the host path's
    `epoch_permutation`). Construct through `build()`, which applies
    the memory budget and falls back (returns None after one warning
    line) instead of raising; `__init__` raises on structural problems.

    Attributes:
        data: the uploaded tree, (x, y, w), (x, y) or x, with the full
            example dimension; x stays narrow under an input cast.
        policy: the `InputCast` applied on upload, or None.
        upload_bytes: host bytes moved by the upload.
    """

    def __init__(self, dataset, input_cast=None, device=None):
        if not isinstance(dataset, ArrayDataset):
            raise TypeError(
                "DeviceResidentDataset needs an ArrayDataset (in-memory "
                "arrays); got {!r}.".format(type(dataset).__name__))
        if dataset.steps_per_epoch < 1:
            raise ValueError(
                "Dataset yields no full batch (num_examples={}, "
                "batch_size={}).".format(dataset.num_examples,
                                         dataset.batch_size))
        if (not dataset.drop_remainder
                and dataset.num_examples % dataset.batch_size):
            raise ValueError(
                "drop_remainder=False with a ragged tail pads batches on "
                "the host; the resident path cannot reproduce that on "
                "the device.")
        self.device = runtime_lib.resolve_device(device)
        # The live dataset: the resident fit reads and advances its
        # `_epoch` counter, so the order stays in step with the host
        # path.
        self.source = dataset
        self.num_examples = dataset.num_examples
        self.batch_size = dataset.batch_size
        self.steps_per_epoch = dataset.steps_per_epoch
        self.shuffle = dataset.shuffle
        self.seed = dataset.seed
        self.policy = (input_cast if isinstance(input_cast, InputCast)
                       or input_cast is None
                       else make_input_cast(input_cast, dataset.x))
        x = dataset.x if self.policy is None else self.policy.host_cast(
            dataset.x)
        if dataset.sample_weight is not None:
            host = (x, dataset.y, dataset.sample_weight)
            self.kind = "xyw"
        elif dataset.y is None:
            host = x
            self.kind = "x"
        else:
            host = (x, dataset.y)
            self.kind = "xy"
        host = _map(to_tensor, host)
        self.upload_bytes = runtime_lib.record_h2d(host)
        self.data = _map(lambda t: t.to(self.device), host)

    @classmethod
    def build(cls, dataset, input_cast=None, device=None,
              budget_bytes=None):
        """Residency with a fallback: a `DeviceResidentDataset`, or None
        after one warning line when the dataset cannot live on the
        device (not in-memory arrays, no full batch, a host-padded
        ragged tail, or over the memory budget); the caller then streams
        from the host."""
        def fallback(why):
            logger.warning("cache='device' unavailable (%s); streaming "
                           "from host instead.", why)
            return None

        if not isinstance(dataset, ArrayDataset):
            return fallback("needs in-memory arrays, got {}".format(
                type(dataset).__name__))
        if dataset.steps_per_epoch < 1:
            return fallback("dataset smaller than one batch")
        if (not dataset.drop_remainder
                and dataset.num_examples % dataset.batch_size):
            return fallback("ragged tail is host-padded")
        device = runtime_lib.resolve_device(device)
        policy = (input_cast if isinstance(input_cast, InputCast)
                  or input_cast is None
                  else make_input_cast(input_cast, dataset.x))
        budget = (_resident_budget(device) if budget_bytes is None
                  else budget_bytes)
        if budget is not None:
            need = cls.resident_bytes(dataset, policy)
            if need > budget:
                return fallback(
                    "dataset needs {} bytes on the device, budget {}"
                    .format(need, budget))
        return cls(dataset, input_cast=policy, device=device)

    @staticmethod
    def resident_bytes(dataset, policy):
        """The uploaded footprint after the input cast (labels as int64,
        weights as f32, as they are uploaded)."""
        x_bytes = (policy.cast_nbytes(dataset.x) if policy is not None
                   else sum(to_tensor(a).numel() * to_tensor(a)
                            .element_size() for a in _leaves(dataset.x)))
        total = x_bytes
        if dataset.y is not None:
            total += to_tensor(dataset.y).numel() * 8
        if dataset.sample_weight is not None:
            total += dataset.sample_weight.nbytes
        return int(total)

    def epoch_order(self, epoch):
        """The device-side example order of epoch counter `epoch`."""
        if self.shuffle:
            return device_permutation(self.num_examples, self.seed, epoch,
                                      self.device)
        return torch.arange(self.num_examples, device=self.device)

    def gather(self, idx):
        """The batch of examples `idx` (a device int64 tensor), gathered
        on the device."""
        return _map(lambda a: a.index_select(0, idx), self.data)


def as_dataset(data, y=None, batch_size=32, **kwargs):
    """Coerces user input to a re-iterable dataset of batches, as the
    JAX package does, in this order:

    - an `ArrayDataset` (used as it is);
    - raw arrays or an array tree (dict, or list/tuple of arrays),
      always when `y` is given: an `ArrayDataset`;
    - a one-shot iterator or generator of batches: materialised into a
      list once, so every epoch sees every batch;
    - any other re-iterable of batches (a list, `GeneratorDataset`,
      `NpzShardDataset`, `ThreadedDataset`): used as it is.
    """
    if isinstance(data, ArrayDataset):
        return data
    if y is not None or hasattr(data, "shape") or isinstance(data, dict):
        return ArrayDataset(data, y, batch_size=batch_size, **kwargs)
    if isinstance(data, (list, tuple)):
        if data and all(hasattr(e, "shape") for e in data):
            # A tree of arrays (a multi-input model), not a batch list.
            return ArrayDataset(data, y, batch_size=batch_size, **kwargs)
        return data
    if hasattr(data, "__next__"):
        return list(data)
    if hasattr(data, "__iter__"):
        return data
    return ArrayDataset(data, y, batch_size=batch_size, **kwargs)


class GeneratorDataset:
    """Streaming dataset from an iterator factory: `factory(**
    factory_kwargs)` returns a fresh iterator of batches (numpy arrays
    or (x, y) tuples) each time it is called: once per epoch, plus once
    for the Trainer's build-time peek, so keep it free of side effects.
    `steps_per_epoch` bounds each epoch of an endless stream
    (`Trainer.fit` takes it when its own is unset)."""

    def __init__(self, factory, steps_per_epoch=None, factory_kwargs=None):
        if not callable(factory):
            raise TypeError("factory must be callable, got {!r}".format(
                type(factory)))
        self.factory = factory
        self.steps_per_epoch = steps_per_epoch
        self.factory_kwargs = dict(factory_kwargs or {})

    def __iter__(self):
        return iter(self.factory(**self.factory_kwargs))


class NpzShardDataset:
    """Batches from .npz shards on storage (local paths or gs://, through
    `utils.storage`), read shard by shard each epoch.

    Each shard holds an `x` array (and optionally `y`). Batches of
    `batch_size` are cut per shard; a shard's tail smaller than a batch
    is dropped unless the shard yields no full batch, in which case it
    is yielded whole.
    """

    def __init__(self, shard_paths, batch_size=32):
        if not shard_paths:
            raise ValueError("shard_paths must be non-empty.")
        if batch_size <= 0:
            raise ValueError("batch_size must be positive.")
        self.shard_paths = [str(p) for p in shard_paths]
        self.batch_size = batch_size

    def __iter__(self):
        from cloud_tpu_torch.utils import storage

        for path in self.shard_paths:
            arrays = np.load(io.BytesIO(storage.read_bytes(path)))
            x = arrays["x"]
            y = arrays["y"] if "y" in arrays.files else None
            steps = x.shape[0] // self.batch_size
            if steps == 0:
                yield (x, y) if y is not None else x
                continue
            for i in range(steps):
                sl = slice(i * self.batch_size, (i + 1) * self.batch_size)
                yield (x[sl], y[sl]) if y is not None else x[sl]


class ThreadedDataset:
    """Pulls a wrapped dataset on a background thread through a bounded
    queue: the host-side complement of `prefetch_to_device` (it overlaps
    producing batches, e.g. a slow generator, with training).

    Batch order is kept; a producer exception re-raises in the consumer;
    abandoning an epoch midway (steps_per_epoch, an early break) stops
    the producer thread. `steps_per_epoch`, `num_examples` and
    `batch_size` are forwarded from the wrapped dataset.
    """

    _SENTINEL = object()

    def __init__(self, dataset, buffer_size=4):
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1.")
        if hasattr(dataset, "__next__"):
            raise TypeError(
                "ThreadedDataset needs a re-iterable (multi-epoch "
                "training re-iterates per epoch; a one-shot iterator "
                "would be silently empty after epoch 1). Wrap the "
                "source in GeneratorDataset(factory) instead.")
        self.dataset = dataset
        self.buffer_size = buffer_size
        for attr in ("steps_per_epoch", "num_examples", "batch_size"):
            value = getattr(dataset, attr, None)
            if value is not None:
                setattr(self, attr, value)

    def __iter__(self):
        q = queue_lib.Queue(maxsize=self.buffer_size)
        stop = threading.Event()

        def put(item):
            """put() that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_lib.Full:
                    continue
            return False

        def producer():
            try:
                for item in self.dataset:
                    if not put((None, item)):
                        return
                put((None, self._SENTINEL))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                put((e, None))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                err, item = q.get()
                if err is not None:
                    raise err
                if item is self._SENTINEL:
                    return
                yield item
        finally:
            # Signal, then join: an abandoned epoch must not leave a
            # producer racing the next epoch's over the inner dataset.
            stop.set()
            thread.join(timeout=5.0)


def device_put(batch, device):
    """Moves a host batch (a tree of numpy arrays, CPU tensors or
    values) to `device` as tensors (`to_tensor` dtypes), counting the
    bytes sent (`runtime.record_h2d`); None leaves stay None. A copy to a
    card is issued without waiting (from pinned memory when the leaf is
    pinned)."""
    host = _map(lambda a: None if a is None else to_tensor(a), batch)
    runtime_lib.record_h2d(host)
    return _map(lambda t: None if t is None else t.to(
        device, non_blocking=True), host)


class _Staged:
    """A batch copied on the side stream, with the event that marks the
    end of its copy."""

    __slots__ = ("tree", "event")

    def __init__(self, tree, event):
        self.tree = tree
        self.event = event


def prefetch_to_device(iterator, size=2, feed=None, limit=None,
                       device=None):
    """Wraps a host batch iterator with device read-ahead: `size`
    batches are in flight ahead of the one being consumed (up to size +
    1 alive; 0 feeds synchronously).

    On a card, each batch goes to pinned host memory and is copied on a
    side stream; the consumer's stream waits on the copy's event when
    the batch is yielded (and the tensors are recorded on that stream),
    so the step never reads a batch before it has arrived and the copy
    of batch i + 1 overlaps step i. Every feed is counted
    (`runtime.record_h2d`).

    Args:
        iterator: host batch iterable.
        size: read-ahead depth.
        feed: optional callable replacing the default feed (`device_put`
            to `device`); its return value is yielded.
        limit: bound on the pulls from the iterator, taken BEFORE
            reading ahead (steps_per_epoch over an endless stream).
        device: the target device of the default feed (default: the
            card).
    """
    if feed is None:
        device = runtime_lib.resolve_device(device)
        if device.type == "cuda":
            side = torch.cuda.Stream(device)

            def feed(batch):
                pinned = _map(lambda a: None if a is None
                              else _pinned(to_tensor(a)), batch)
                runtime_lib.record_h2d(pinned)
                with torch.cuda.stream(side):
                    tree = _map(lambda t: None if t is None else t.to(
                        device, non_blocking=True), pinned)
                    event = torch.cuda.Event()
                    event.record(side)
                return _Staged(tree, event)
        else:
            def feed(batch):
                return device_put(batch, device)

    def ready(item):
        if not isinstance(item, _Staged):
            return item
        stream = torch.cuda.current_stream()
        stream.wait_event(item.event)
        _map(lambda t: None if t is None else t.record_stream(stream),
             item.tree)
        return item.tree

    it = iter(iterator)
    if limit is not None:
        it = itertools.islice(it, limit)
    if size <= 0:
        for batch in it:
            yield ready(feed(batch))
        return
    pending = collections.deque()
    try:
        for _ in range(size):
            pending.append(feed(next(it)))
    except StopIteration:
        pass
    while pending:
        out = pending.popleft()
        try:
            pending.append(feed(next(it)))
        except StopIteration:
            pass
        yield ready(out)


__all__ = ["ArrayDataset", "DeviceResidentDataset", "GeneratorDataset",
           "InputCast", "NpzShardDataset", "ThreadedDataset", "as_dataset",
           "device_permutation", "device_put", "epoch_permutation",
           "fold_in", "make_input_cast", "permutation", "prefetch_to_device",
           "prng_key", "random_bits32", "split", "threefry2x32",
           "to_tensor"]
