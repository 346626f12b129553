"""Checkpoint and restore of the train state.

The port of `cloud_tpu/training/checkpoint.py`, with the JAX package's
layout: `<dir>/<step>` holds one checkpoint and `<dir>/<step>.meta.json`
its sidecar, with the same fields (`format`, `step`, `digest`,
`data_state`, `time`). The files are the port's own: `<dir>/<step>` is a
directory holding `state.pt`, written by `torch.save` and read back by
`torch.load(weights_only=True)`, so a checkpoint holds tensors and plain
values and loading one never unpickles code. Orbax checkpoints of the
JAX package are not read; parameters cross between the packages through
`models.convert`.

What `save` takes is a tree (nested dicts, lists and tuples of tensors
and plain values) or an object with `state_dict()` (a
`trainer.TrainState`, whose tree is the full train state; a
`torch.nn.Module`). Every save first copies the tree to host memory
(one counted device->host fetch), so the written bytes are a snapshot
that the next in-place optimizer step cannot touch; the content digest
hashes that snapshot and `restore` checks it.
"""

import concurrent.futures
import hashlib
import io
import json
import logging
import os
import sys
import threading
import time

import numpy as np
import torch

from cloud_tpu_torch.parallel import runtime
from cloud_tpu_torch.utils import storage

logger = logging.getLogger("cloud_tpu_torch")

#: Sidecar filename suffix: `<dir>/<step>.meta.json` rides next to the
#: step directory; `latest_step`'s digit scan never sees it.
METADATA_SUFFIX = ".meta.json"
#: The file inside `<dir>/<step>`.
STATE_FILE = "state.pt"

# One background writer for async saves (saves commit in order), and the
# `<dir>/<step>` paths with a save in flight: a second save to a path
# still being written waits for the first, so two writes never
# interleave in one directory.
_pending_lock = threading.Lock()
_pending_paths = set()
_pending_futures = []
_writer = None


def _get_writer():
    global _writer
    with _pending_lock:
        if _writer is None:
            _writer = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="cloud-tpu-torch-ckpt")
        return _writer


def wait_until_finished():
    """Blocks until every async save has committed; re-raises the first
    error a background write hit. No-op when none is pending. Call
    before reading a checkpoint written with `save(..., use_async=True)`
    or at the end of training (`Trainer.fit` does on every exit
    path)."""
    with _pending_lock:
        futures = list(_pending_futures)
        del _pending_futures[:]
    error = None
    for future in futures:
        try:
            future.result()
        except Exception as exc:  # noqa: BLE001 - re-raised below
            if error is None:
                error = exc
    with _pending_lock:
        _pending_paths.clear()
    if error is not None:
        raise error


def pending_saves():
    """The `<dir>/<step>` paths with an async save in flight (empty after
    wait_until_finished)."""
    with _pending_lock:
        return frozenset(_pending_paths)


def _tree_of(state):
    return state.state_dict() if hasattr(state, "state_dict") else state


def _copy_to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: _copy_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_to_host(v) for v in tree)
    return tree


def _host_snapshot(tree):
    """A host copy of every tensor of `tree` (numpy arrays become
    tensors), counted as one device->host fetch."""
    previous = runtime.set_phase("checkpoint")
    try:
        runtime.record_d2h(tree)
        return _copy_to_host(tree)
    finally:
        runtime.set_phase(previous)


def _leaves(tree, path=()):
    """(path, leaf) over a tree in a canonical order: dict items sorted
    by key, list and tuple items in order; the path names each
    container's type, so two trees of other structure differ in it."""
    if isinstance(tree, dict):
        for key, value in sorted(tree.items(), key=lambda kv: repr(kv[0])):
            yield from _leaves(value, path + (("dict", key),))
    elif isinstance(tree, (list, tuple)):
        kind = type(tree).__name__
        for i, value in enumerate(tree):
            yield from _leaves(value, path + ((kind, i),))
    else:
        yield path, tree


def tree_digest(tree):
    """sha256 content digest of a tree (or of `state.state_dict()`):
    its structure, and every tensor's shape, dtype and bytes (other
    leaves by repr)."""
    digest = hashlib.sha256()
    for path, leaf in _leaves(_tree_of(tree)):
        digest.update(repr(path).encode("utf-8"))
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(leaf)
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu").contiguous()
            digest.update(str(tuple(t.shape)).encode("utf-8"))
            digest.update(str(t.dtype).encode("utf-8"))
            digest.update(memoryview(
                t.reshape(-1).view(torch.uint8).numpy()))
        else:
            digest.update(repr(leaf).encode("utf-8"))
    return digest.hexdigest()


def _normalize(directory):
    """Local paths become absolute; gs:// URIs pass through."""
    if storage.is_gcs_path(directory):
        return str(directory).rstrip("/")
    return os.path.abspath(directory)


def _metadata_path(directory, step):
    return storage.join(_normalize(directory), str(step) + METADATA_SUFFIX)


def _write_metadata(directory, step, digest, data_state):
    """Writes the `<step>.meta.json` sidecar (locally through a temp file
    and `os.replace`, so a crash never leaves half a sidecar)."""
    record = {
        "format": "cloud_tpu_torch.checkpoint.meta.v1",
        "step": int(step),
        "digest": digest,
        "data_state": data_state,
        "time": time.time(),
    }
    path = _metadata_path(directory, step)
    payload = (json.dumps(record, sort_keys=True) + "\n").encode("utf-8")
    if storage.is_gcs_path(path):
        storage.write_bytes(path, payload)
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)
    return path


def load_metadata(directory, step):
    """The sidecar dict of `<directory>/<step>` (content digest and the
    resumable `data_state`), or None when there is none."""
    try:
        payload = storage.read_bytes(_metadata_path(directory, step))
    except (OSError, ValueError):
        return None
    try:
        return json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        logger.warning("Unreadable checkpoint metadata for step %s "
                       "under %s; ignoring it.", step, directory)
        return None


def _write_state(path, snapshot):
    """Writes `snapshot` as `<path>/state.pt`: locally to a temp file
    renamed into place, so the file is whole or absent."""
    target = storage.join(path, STATE_FILE)
    if storage.is_gcs_path(path):
        buffer = io.BytesIO()
        torch.save(snapshot, buffer)
        storage.write_bytes(target, buffer.getvalue())
        return
    os.makedirs(path, exist_ok=True)
    tmp = target + ".tmp"
    torch.save(snapshot, tmp)
    os.replace(tmp, target)


def _read_state(path):
    target = storage.join(path, STATE_FILE)
    if storage.is_gcs_path(path):
        source = io.BytesIO(storage.read_bytes(target))
    else:
        source = target
    return torch.load(source, map_location="cpu", weights_only=True)


def _chaos_notify(path, step):
    # The fault injector's checkpoint hook: fires only when the chaos
    # module is already loaded (a plan may be installed).
    chaos = sys.modules.get("cloud_tpu_torch.analysis.chaos")
    if chaos is not None:
        chaos.notify_checkpoint(path, step)


def save(directory, state, step=0, force=True, use_async=False,
         data_state=None):
    """Saves `state` (a tree, or an object with `state_dict()`) under
    `<directory>/<step>`; returns that path.

    force: replace a checkpoint already at that step (else raise).
    use_async: return once the state is copied to host memory; the
        digest and the writes run on a background thread. Call
        `wait_until_finished()` before reading it back or exiting.
    data_state: the resumable data-stream position
        (`Trainer.current_data_state()`), stamped into the sidecar.
    """
    path = storage.join(_normalize(directory), str(step))
    with _pending_lock:
        same_path_pending = path in _pending_paths
    if same_path_pending:
        # A second save to a path still being written waits for the
        # first: last writer wins, over a whole checkpoint.
        wait_until_finished()
    if not force and storage.exists(storage.join(path, STATE_FILE)):
        raise FileExistsError("A checkpoint exists at {}.".format(path))
    snapshot = _host_snapshot(_tree_of(state))

    def commit():
        # The state, then its sidecar: a sidecar never names bytes that
        # are not on disk yet.
        _write_state(path, snapshot)
        _write_metadata(directory, step, tree_digest(snapshot), data_state)
        _chaos_notify(path, step)

    if use_async:
        with _pending_lock:
            _pending_paths.add(path)
        future = _get_writer().submit(commit)
        with _pending_lock:
            _pending_futures.append(future)
    else:
        commit()
    return path


def latest_step(directory):
    """Largest step checkpointed under `directory` (local or gs://), or
    None. Waits for in-flight async saves first."""
    wait_until_finished()
    steps = [int(name) for name in storage.listdir(_normalize(directory))
             if name.isdigit()]
    return max(steps) if steps else None


def _like(tree, target):
    """`tree` with each tensor moved to the device of `target`'s tensor
    at the same place; raises ValueError where their structure, shapes
    or dtypes differ."""
    if isinstance(target, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != \
                target.shape or tree.dtype != target.dtype:
            raise ValueError("checkpoint leaf {} does not match the "
                             "target's {} {}.".format(
                                 getattr(tree, "shape", tree),
                                 tuple(target.shape), target.dtype))
        return tree.to(target.device)
    if isinstance(target, dict):
        if not isinstance(tree, dict) or set(tree) != set(target):
            raise ValueError("checkpoint keys differ from the target's.")
        return {k: _like(tree[k], v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(target):
            raise ValueError("checkpoint structure differs from the "
                             "target's.")
        return type(target)(_like(a, b) for a, b in zip(tree, target))
    return tree


def restore(directory, target=None, step=None, verify=True):
    """Restores the checkpoint `<directory>/<step>` (default: the
    latest).

    target: None returns the tree as saved, on the CPU; an object with
        `load_state_dict` (a `TrainState`, a module) takes the tree in
        place and is returned; any other tree gets the checkpoint's
        tensors on the devices of its own, and must match it.
    verify: recompute the content digest and compare it with the
        sidecar's. A mismatch, or a checkpoint that fails to load,
        raises the typed `resilience.CheckpointCorrupt` (so that
        `fit(resume="auto")` can quarantine the step and fall back).
    """
    from cloud_tpu_torch.training import resilience

    directory = _normalize(directory)
    wait_until_finished()  # never read a checkpoint mid-write
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                "No checkpoints found under {}.".format(directory))
    path = storage.join(directory, str(step))
    try:
        tree = _read_state(path)
    except Exception as e:
        raise resilience.CheckpointCorrupt(
            "Checkpoint {} failed to load ({}: {}).".format(
                path, type(e).__name__, e), path=path, step=step) from e
    if verify:
        meta = load_metadata(directory, step)
        expected = None if meta is None else meta.get("digest")
        if expected:
            actual = tree_digest(tree)
            if actual != expected:
                raise resilience.CheckpointCorrupt(
                    "Checkpoint {} failed its content digest (expected "
                    "{}..., got {}...).".format(path, expected[:12],
                                                actual[:12]),
                    path=path, step=step)
    if target is None:
        return tree
    if hasattr(target, "load_state_dict"):
        target.load_state_dict(tree)
        return target
    return _like(tree, target)


def quarantine(directory, step):
    """Moves `<directory>/<step>` (and its sidecar) aside as
    `<step>.corrupt` so `latest_step` falls back to the previous
    checkpoint. gs:// has no rename: there it warns and moves nothing.
    Returns the quarantine path, or None."""
    norm = _normalize(directory)
    src = storage.join(norm, str(step))
    if storage.is_gcs_path(norm):
        logger.warning(
            "Cannot quarantine %s: gs:// has no rename. Move the "
            "object aside manually so resume stops selecting it.", src)
        return None
    if not os.path.exists(src):
        return None
    dst = src + ".corrupt"
    suffix = 0
    while os.path.exists(dst):
        suffix += 1
        dst = "{}.corrupt{}".format(src, suffix)
    try:
        os.replace(src, dst)
    except OSError:
        logger.warning("Failed to quarantine %s.", src, exc_info=True)
        return None
    meta_src = src + METADATA_SUFFIX
    if os.path.exists(meta_src):
        try:
            os.replace(meta_src, dst + METADATA_SUFFIX)
        except OSError:
            pass
    logger.warning("Quarantined corrupt checkpoint %s -> %s.", src, dst)
    return dst


__all__ = ["METADATA_SUFFIX", "STATE_FILE", "latest_step", "load_metadata",
           "pending_saves", "quarantine", "restore", "save", "tree_digest",
           "wait_until_finished"]
