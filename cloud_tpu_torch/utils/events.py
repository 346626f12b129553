"""TensorBoard event-file writer, dependency-free.

The port's own copy of `cloud_tpu/utils/events.py` (which imports no
JAX). The primary metric channel is structured JSONL
(`training.callbacks.MetricsLogger`), but any TensorBoard pointed at a
training directory should show the curves. TensorFlow is not a
dependency, so this module hand-encodes the two tiny wire formats
involved:

- TFRecord framing: little-endian uint64 length, masked crc32c of the
  length bytes, payload, masked crc32c of the payload. Masking is
  TensorFlow's ((crc >> 15 | crc << 17) + 0xa282ead8) % 2^32.
- `Event` protobuf (tensorflow/core/util/event.proto), scalar subset:
    Event { double wall_time=1; int64 step=2;
            oneof { string file_version=3; Summary summary=5; } }
    Summary { repeated Value value=1 }
    Value   { string tag=1; float simple_value=2 }

Only scalar summaries are emitted — exactly what per-epoch metrics and
the tuner's objective readback need. A matching minimal reader is
provided for tests and for the tuner-side parsing path.
"""

import json
import logging
import os
import socket
import struct
import sys
import time

from cloud_tpu_torch.utils import storage

logger = logging.getLogger("cloud_tpu_torch")

_CRC_TABLE = []
_WRITER_COUNT = 0


def _crc32c_table():
    # Castagnoli polynomial (reflected): 0x82F63B78.
    global _CRC_TABLE
    if not _CRC_TABLE:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data):
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = crc32c(data)
    return ((crc >> 15 | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(value):
    out = bytearray()
    value &= (1 << 64) - 1
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field, wire_type):
    return _varint((field << 3) | wire_type)


def _len_delimited(field, payload):
    return _key(field, 2) + _varint(len(payload)) + payload


def _encode_value(tag, value):
    payload = (_len_delimited(1, tag.encode("utf-8"))
               + _key(2, 5) + struct.pack("<f", float(value)))
    return payload


def encode_scalar_event(step, scalars, wall_time=None):
    """Event proto bytes for {tag: float} scalars at `step`."""
    if wall_time is None:
        wall_time = time.time()
    summary = b"".join(
        _len_delimited(1, _encode_value(tag, value))
        for tag, value in scalars.items())
    return (_key(1, 1) + struct.pack("<d", wall_time)
            + _key(2, 0) + _varint(int(step))
            + _len_delimited(5, summary))


def encode_file_version(wall_time=None):
    if wall_time is None:
        wall_time = time.time()
    return (_key(1, 1) + struct.pack("<d", wall_time)
            + _len_delimited(3, b"brain.Event:2"))


def _frame(payload):
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class EventFileWriter:
    """Appends scalar events to one `events.out.tfevents.*` file.

    Every flush appends only the not-yet-written delta through
    `storage.append_bytes` — linear total bytes over a run for local
    AND gs:// paths (GCS appends ride the two-source compose there).
    """

    def __init__(self, log_dir):
        self.log_dir = str(log_dir)
        if not storage.is_gcs_path(self.log_dir):
            os.makedirs(self.log_dir, exist_ok=True)
        # ts.host.pid.counter: same uniqueness recipe as TF's own
        # writers — two writers in the same second (fast tests,
        # back-to-back fits into one dir) must not interleave streams.
        global _WRITER_COUNT
        _WRITER_COUNT += 1
        name = "events.out.tfevents.{:.0f}.{}.{}.{}".format(
            time.time(), socket.gethostname(), os.getpid(),
            _WRITER_COUNT)
        self.path = storage.join(self.log_dir, name)
        self._buffer = bytearray(_frame(encode_file_version()))
        self.flush()

    def add_scalars(self, step, scalars, wall_time=None):
        self._buffer.extend(_frame(
            encode_scalar_event(step, scalars, wall_time=wall_time)))

    def flush(self):
        # Pending frames only: the buffer is cleared once appended, so
        # writer memory stays bounded however long the run.
        if self._buffer:
            storage.append_bytes(self.path, bytes(self._buffer))
            self._buffer = bytearray()

    def close(self):
        self.flush()


# -- Structured job events (JSONL side channel) -------------------------


def _process_index():
    """This process's index in a multi-process job: the
    CLOUD_TPU_PROCESS_ID env contract first, an initialised
    `torch.distributed` group second (looked up in `sys.modules`:
    logging an event never imports torch), else 0."""
    value = os.environ.get("CLOUD_TPU_PROCESS_ID")
    if value is not None:
        try:
            return int(value)
        except ValueError:
            return 0
    torch = sys.modules.get("torch")
    if torch is not None and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        return int(torch.distributed.get_rank())
    return 0


def log_job_event(kind, payload, path=None):
    """Appends one structured job event as a JSONL line.

    The scalar event files above are the TensorBoard-compat channel;
    this is the machine-readable side channel for launch-time facts
    that have no step axis — preflight lint findings, deploy
    decisions, preemption notices. `path` defaults to the
    CLOUD_TPU_EVENT_LOG environment variable; when neither is set the
    call is a no-op (returns None), so library code can log
    unconditionally. Local and gs:// paths both work (appends ride
    `storage.append_bytes`).

    Every record carries the writer's identity and both clocks: host +
    pid + process_index so the fleet collector can tell two workers'
    events apart (they used to be indistinguishable), wall time for
    humans, and a monotonic stamp for intra-process ordering/ages that
    survives NTP steps.

    Returns the path written to, or None when logging is disabled.
    """
    path = path or os.environ.get("CLOUD_TPU_EVENT_LOG")
    if not path:
        return None
    record = {"time": time.time(), "monotonic": time.monotonic(),
              "host": socket.gethostname(), "pid": os.getpid(),
              "process_index": _process_index(),
              "kind": kind, "payload": payload}
    storage.append_bytes(
        path, (json.dumps(record, sort_keys=True) + "\n").encode("utf-8"))
    return path


def read_job_events(path, with_stats=False, kind=None):
    """Parses a JSONL job-event file -> list of dicts.

    Skips blanks AND corrupt/partial lines (a writer that crashed
    mid-append, or two unsynchronized appenders interleaving) with one
    warning for the whole file — a single torn line must not poison
    every later reader of an otherwise-healthy log. With
    `with_stats=True` returns (records, {"corrupt_lines": n}) so the
    fleet collector can report torn files instead of silently eating
    them. `kind` filters to one event kind (e.g. "graftguard",
    "graftchaos", "graftwatch") — the common post-hoc assertion shape
    in the chaos-smoke CI job and tests.
    """
    data = storage.read_bytes(path).decode("utf-8", errors="replace")
    records = []
    corrupt = 0
    for line in data.splitlines():
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            corrupt += 1
    if corrupt:
        logger.warning(
            "read_job_events: skipped %d corrupt/partial JSON line(s) "
            "in %s (crashed writer?); returning the %d parseable "
            "record(s).", corrupt, path, len(records))
    if kind is not None:
        records = [r for r in records if r.get("kind") == kind]
    if with_stats:
        return records, {"corrupt_lines": corrupt}
    return records


# -- Reader (tests + tuner-side readback) -------------------------------


def _read_varint(data, pos):
    shift, value = 0, 0
    while True:
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7


def _parse_fields(data):
    """Yields (field_number, wire_type, value) over one message."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value = data[pos:pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(data, pos)
            value = data[pos:pos + length]
            pos += length
        elif wire == 5:
            value = data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError("Unsupported wire type {}.".format(wire))
        yield field, wire, value


def read_events(path):
    """Parses an event file -> [(step, {tag: value})], scalars only.

    Verifies the TFRecord CRCs — a truncated or corrupted file fails
    loudly instead of yielding garbage floats.
    """
    data = storage.read_bytes(path)
    events = []
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(
                "Truncated event file (partial record header): "
                "{}".format(path))
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        if pos + 16 + length > len(data):
            raise ValueError(
                "Truncated event file (partial record payload): "
                "{}".format(path))
        (header_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if _masked_crc(header) != header_crc:
            raise ValueError("Corrupt event file (header crc): "
                             "{}".format(path))
        payload = data[pos + 12:pos + 12 + length]
        (payload_crc,) = struct.unpack(
            "<I", data[pos + 12 + length:pos + 16 + length])
        if _masked_crc(payload) != payload_crc:
            raise ValueError("Corrupt event file (payload crc): "
                             "{}".format(path))
        pos += 16 + length

        step, scalars = 0, {}
        for field, wire, value in _parse_fields(payload):
            if field == 2 and wire == 0:
                step = value
            elif field == 5 and wire == 2:
                for f2, w2, v2 in _parse_fields(value):
                    if f2 == 1 and w2 == 2:
                        tag, number = None, None
                        for f3, w3, v3 in _parse_fields(v2):
                            if f3 == 1 and w3 == 2:
                                tag = v3.decode("utf-8")
                            elif f3 == 2 and w3 == 5:
                                (number,) = struct.unpack("<f", v3)
                        if tag is not None and number is not None:
                            scalars[tag] = number
        if scalars:
            events.append((step, scalars))
    return events


__all__ = ["EventFileWriter", "read_events", "crc32c",
           "encode_scalar_event", "log_job_event", "read_job_events"]
