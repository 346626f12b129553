"""Input pipeline: batched, shuffled iteration over in-memory arrays.

The array subset of `cloud_tpu/training/data.py`: `epoch_permutation`,
`ArrayDataset` and `as_dataset` for arrays. Batches are numpy; the
Trainer moves them to the model's device.

`epoch_permutation` reproduces the JAX package's shuffle order bit for
bit without JAX: the threefry2x32 generator, `fold_in`, `split` and
`random_bits` are written out in numpy below, with the semantics JAX
has under `jax_threefry_partitionable=True` (its default since JAX
0.5, and the setting of the JAX this port is tested against), and the
permutation is JAX's `_shuffle`: ceil(3 ln n / ln(2^32 - 1)) rounds of
a stable sort on fresh 32-bit keys.
"""

import math

import numpy as np

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
        order = self._epoch_order()
        self._epoch += 1
        for step in range(self.steps_per_epoch):
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


def as_dataset(data, y=None, batch_size=32, **kwargs):
    """Wraps array inputs in an `ArrayDataset` (an `ArrayDataset` is used
    as it is). Other iterables (streams, generators, file shards) are
    not ported yet and raise."""
    if isinstance(data, ArrayDataset):
        return data
    arrays = (hasattr(data, "shape") or isinstance(data, dict)
              or (isinstance(data, (list, tuple)) and data
                  and all(hasattr(e, "shape") for e in data)))
    if y is not None or arrays:
        return ArrayDataset(data, y, batch_size=batch_size, **kwargs)
    raise NotImplementedError(
        "only array inputs are ported; streaming datasets "
        "(GeneratorDataset, NpzShardDataset, ThreadedDataset) are "
        "ROADMAP items.")


__all__ = ["ArrayDataset", "as_dataset", "epoch_permutation", "fold_in",
           "permutation", "prng_key", "random_bits32", "split",
           "threefry2x32"]
