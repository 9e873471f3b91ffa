"""Per-tick low-level observability log (port of
``bilevel_gait_gen_tpu/utils/lowlevel_log.py``; numpy, no torch).

A decimated, append-only binary row stream with a self-describing JSON
header, written from the host side of the control loop: the hardware
layer's decimated state/command log (the reference's
``state_record_pattern`` files, hardware/hardware_robot.cpp:183-186).

File format (the JAX package's, byte for byte): ``b"BGGL"`` magic, u32
header length, JSON header {"fields": [[name, width], ...], "decimation":
d}, then consecutive float32 rows of sum(widths) values.  Rows flush to
disk every ``flush_every`` records.

One difference from the JAX package: :func:`load` keeps the complete rows
of a file whose last row is partial (a writer killed mid-flush) and drops
the partial one, where the JAX ``load`` raises on the reshape.
"""
from __future__ import annotations

import json
import struct

import numpy as np

_MAGIC = b"BGGL"


class LowLevelLog:
    """Decimated per-tick row logger.

    fields: ordered (name, width) pairs; every `record` call supplies one
    flat float array per field.  Only every `decimation`-th call is kept
    (reference state_record_pattern).
    """

    def __init__(self, path: str, fields, decimation: int = 1,
                 flush_every: int = 256):
        self.path = path
        self.fields = [(str(n), int(w)) for n, w in fields]
        self.decimation = max(int(decimation), 1)
        self.row_width = sum(w for _, w in self.fields)
        self._n_calls = 0
        self._buf: list[np.ndarray] = []
        self._flush_every = flush_every
        header = json.dumps({"fields": self.fields,
                             "decimation": self.decimation}).encode()
        self._f = open(path, "wb")
        self._f.write(_MAGIC + struct.pack("<I", len(header)) + header)

    def record(self, **arrays) -> None:
        self._n_calls += 1
        if (self._n_calls - 1) % self.decimation:
            return
        parts = []
        for name, width in self.fields:
            a = np.asarray(arrays[name], np.float32).reshape(-1)
            if a.size != width:
                raise ValueError(f"field {name}: expected {width} values, "
                                 f"got {a.size}")
            parts.append(a)
        self._buf.append(np.concatenate(parts))
        if len(self._buf) >= self._flush_every:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            np.stack(self._buf).tofile(self._f)
            self._buf.clear()
        self._f.flush()

    def close(self) -> None:
        self.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load(path: str) -> dict:
    """Parse a log file back: {"decimation": d, field: [rows, width] ...};
    the complete rows only."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"not a lowlevel log: bad magic {magic!r}")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode())
        data = np.fromfile(f, dtype=np.float32)
    fields = header["fields"]
    width = sum(w for _, w in fields)
    if width:
        # a partial last row (the writer stopped mid-row) is dropped
        rows = data[:data.size - data.size % width].reshape(-1, width)
    else:
        rows = data.reshape(-1, 1)
    out = {"decimation": header["decimation"]}
    off = 0
    for name, w in fields:
        out[name] = rows[:, off:off + w]
        off += w
    return out
