"""One-device runtime: device choice, the counted host<->device
transfers, and per-thread phase labels.

The single-device subset of `cloud_tpu/parallel/runtime.py`. Every
device->host read of the serving loop goes through `device_fetch`, so
the d2h counters stay a census of fetch sites (one round trip per
call, whatever the number of tensors fetched). Every host->device feed
of training data (the Trainer's batch feed, `prefetch_to_device`, the
one-time resident upload) calls `record_h2d` first, so "zero example
bytes after the upload" can be read off `transfer_stats()`.
"""

import threading

import numpy as np
import torch

_phase = threading.local()
_transfer_lock = threading.Lock()
_transfer_stats = {"h2d_transfers": 0, "h2d_bytes": 0,
                   "d2h_fetches": 0, "d2h_bytes": 0}


def default_device():
    """The device every entry point uses when the caller names none:
    the first CUDA card."""
    return torch.device("cuda")


def resolve_device(device=None):
    """`device` as a `torch.device` (None = `default_device()`). Raises
    when a CUDA device is asked for and no GPU is present: the port
    never falls back to the CPU on its own; a caller that wants the
    CPU passes `device="cpu"`."""
    device = default_device() if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU.")
    return device


def process_index():
    """This process's index in a multi-process job: the rank of an
    initialised `torch.distributed` group, else 0."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return int(torch.distributed.get_rank())
    return 0


def set_phase(name):
    """Sets this thread's phase label; returns the previous label."""
    previous = getattr(_phase, "name", None)
    _phase.name = name
    return previous


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def _host_leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _host_leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _host_leaves(value)
    elif tree is not None:
        yield tree


def record_h2d(tree):
    """Counts the host->device bytes about to be transferred for `tree`:
    one transfer per host leaf (a numpy array, a CPU tensor or a Python
    value, measured through `np.asarray`); a tensor already on a card
    costs nothing and is skipped. Returns the byte count recorded, so
    the one-time resident upload can report its own size."""
    transfers = 0
    total = 0
    for leaf in _host_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type != "cpu":
                continue
            nbytes = leaf.numel() * leaf.element_size()
        else:
            nbytes = getattr(leaf, "nbytes", None)
            if nbytes is None:
                nbytes = np.asarray(leaf).nbytes
        transfers += 1
        total += int(nbytes)
    if transfers:
        with _transfer_lock:
            _transfer_stats["h2d_transfers"] += transfers
            _transfer_stats["h2d_bytes"] += total
    return total


def record_d2h(tree):
    """Counts one device->host fetch about to be issued for `tree`: one
    round trip, bytes summed over its tensors. A tree with no tensor
    records nothing. Returns the byte count recorded."""
    tensors = list(_tensors(tree))
    total = sum(t.numel() * t.element_size() for t in tensors)
    if tensors:
        with _transfer_lock:
            _transfer_stats["d2h_fetches"] += 1
            _transfer_stats["d2h_bytes"] += total
    return total


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return np.asarray(tree)


def device_fetch(tree):
    """The sanctioned instrumented readback: record, then copy every
    tensor of `tree` to host numpy (same structure). Blocks until the
    device has produced the values."""
    record_d2h(tree)
    return _to_host(tree)


def transfer_stats():
    """A snapshot of the process-wide transfer counters (h2d and
    d2h)."""
    with _transfer_lock:
        return dict(_transfer_stats)


def reset_transfer_stats():
    """Zeroes the transfer counters."""
    with _transfer_lock:
        for key in _transfer_stats:
            _transfer_stats[key] = 0


__all__ = ["default_device", "device_fetch", "process_index",
           "record_d2h", "record_h2d", "reset_transfer_stats",
           "resolve_device",
           "set_phase", "transfer_stats"]
