"""Storage abstraction: local filesystem + GCS (`gs://`) paths.

The port's own copy of `cloud_tpu/utils/storage.py` (which imports no
JAX). The single seam for files: local paths always work, `gs://` paths
go through google-cloud-storage when it is installed (imported at the
first gs:// call, so importing this module needs the standard library
alone).
"""

import os


def is_gcs_path(path):
    return str(path).startswith("gs://")


def _split_gcs(path):
    rest = str(path)[len("gs://"):]
    bucket, _, blob = rest.partition("/")
    return bucket, blob


def _client():
    try:
        from google.cloud import storage as gcs
    except ImportError:
        raise RuntimeError(
            "google-cloud-storage is required for gs:// paths.")
    return gcs.Client()


def write_bytes(path, data):
    if is_gcs_path(path):
        bucket_name, blob_name = _split_gcs(path)
        _client().bucket(bucket_name).blob(blob_name).upload_from_string(
            data)
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def append_bytes(path, data):
    """Appends to a file or gs:// object with linear total bytes.

    GCS has no append primitive; the object is extended server-side via
    a two-source compose (existing + new part), so per-call cost is the
    new part, not the accumulated stream — O(total) bytes over a run
    instead of rewriting the whole stream every call.
    """
    if is_gcs_path(path):
        import uuid

        bucket_name, blob_name = _split_gcs(path)
        bucket = _client().bucket(bucket_name)
        dest = bucket.blob(blob_name)
        if not dest.exists():
            dest.upload_from_string(data)
            return
        # Unique part name: concurrent appenders never clobber each
        # other's staged bytes, and a crash leaves only an orphan part
        # (never silently reused). The compose is guarded by a
        # generation precondition so two concurrent composes can't
        # drop each other's records; on contention, reload and retry.
        part = bucket.blob("{}.part.{}".format(blob_name, uuid.uuid4().hex))
        part.upload_from_string(data)
        try:
            try:
                from google.api_core import exceptions as api_exceptions
                precondition_failed = api_exceptions.PreconditionFailed
            except ImportError:  # pragma: no cover - ships with the SDK
                precondition_failed = ()
            for _ in range(5):
                dest.reload()
                try:
                    dest.compose([dest, part],
                                 if_generation_match=dest.generation)
                    return
                except precondition_failed:
                    continue  # another appender won; re-read and retry
            raise RuntimeError(
                "append_bytes: persistent compose contention on "
                "{}".format(path))
        finally:
            part.delete()
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    with open(path, "ab") as f:
        f.write(data)


def read_bytes(path):
    if is_gcs_path(path):
        bucket_name, blob_name = _split_gcs(path)
        return (_client().bucket(bucket_name).blob(blob_name)
                .download_as_bytes())
    with open(path, "rb") as f:
        return f.read()


def exists(path):
    if is_gcs_path(path):
        bucket_name, blob_name = _split_gcs(path)
        return _client().bucket(bucket_name).blob(blob_name).exists()
    return os.path.exists(path)


def listdir(path):
    """Immediate child names under a directory (local or gs:// prefix).

    Missing directories list as empty (callers treat "nothing there yet"
    uniformly — e.g. checkpoint discovery on first run).
    """
    if is_gcs_path(path):
        bucket_name, prefix = _split_gcs(path)
        prefix = prefix.rstrip("/")
        prefix = prefix + "/" if prefix else ""  # "" = bucket root
        # delimiter="/" makes GCS aggregate children server-side: one
        # page of names instead of enumerating every blob under the
        # prefix (an orbax checkpoint tree holds thousands of shards).
        names = set()
        listing = _client().bucket(bucket_name).list_blobs(
            prefix=prefix, delimiter="/")
        for blob in listing:
            rest = blob.name[len(prefix):]
            if rest:
                names.add(rest)
        names.update(p[len(prefix):].rstrip("/") for p in listing.prefixes)
        return sorted(names)
    if not os.path.isdir(path):
        return []
    return sorted(os.listdir(path))


def join(base, *parts):
    if is_gcs_path(base):
        return "/".join([str(base).rstrip("/")] +
                        [str(p).strip("/") for p in parts])
    return os.path.join(base, *parts)
