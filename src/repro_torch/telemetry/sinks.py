"""Telemetry sinks: where metric rows land.

Port of ``repro/telemetry/sinks.py`` (plain Python, unchanged in
behaviour; the two packages read each other's files).

One protocol, three implementations:

  * :class:`MemorySink`  — rows accumulate in a python list (tests, notebooks);
  * :class:`JsonlSink`   — one JSON object per line, streamed (flushed every
    row) so a killed run keeps everything recorded so far.  The default:
    ``python -m repro_torch.telemetry.report`` reads it back;
  * :class:`CsvSink`     — spreadsheet-friendly; the header is fixed by the
    FIRST row (later rows are projected onto it — collectors emit a constant
    key set per run, see metrics.py, so nothing is lost in practice).

A sink receives plain-python dict rows (floats/ints/strings -- the recorder
converts device tensors before emitting) and must be cheap: emission
happens on the host, at the recorder's flush.
"""
from __future__ import annotations

import csv
import io
import json
import os
from typing import Optional, Protocol, runtime_checkable

__all__ = [
    "TelemetrySink", "MemorySink", "JsonlSink", "CsvSink", "make_sink",
    "SINKS", "read_jsonl", "read_csv",
]


@runtime_checkable
class TelemetrySink(Protocol):
    """Anything with ``emit(row: dict)`` and ``close()``; ``path`` is None
    for in-memory sinks."""

    path: Optional[str]

    def emit(self, row: dict) -> None: ...

    def close(self) -> None: ...


class MemorySink:
    """Rows in a list (``sink.rows``); nothing touches disk."""

    def __init__(self, path: Optional[str] = None):
        self.path = None
        self.rows: list[dict] = []

    def emit(self, row: dict) -> None:
        self.rows.append(dict(row))

    def close(self) -> None:
        pass


class _FileSink:
    """Shared open/close plumbing; makes the parent directory, flushes per
    row so partial runs stay readable."""

    def __init__(self, path: str):
        if not path:
            raise ValueError(f"{type(self).__name__} needs a path")
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh: Optional[io.TextIOBase] = open(path, "w")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class JsonlSink(_FileSink):
    """One JSON object per line — the canonical on-disk stream."""

    def emit(self, row: dict) -> None:
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()


class CsvSink(_FileSink):
    """CSV with the header locked to the first row's keys; later rows are
    projected onto that header (missing -> empty cell, extras dropped)."""

    def __init__(self, path: str):
        super().__init__(path)
        self._writer: Optional[csv.DictWriter] = None

    def emit(self, row: dict) -> None:
        if self._writer is None:
            self._writer = csv.DictWriter(
                self._fh, fieldnames=list(row), extrasaction="ignore")
            self._writer.writeheader()
        self._writer.writerow({k: row.get(k, "") for k in
                               self._writer.fieldnames})
        self._fh.flush()


SINKS = {"memory": MemorySink, "jsonl": JsonlSink, "csv": CsvSink}


def make_sink(kind: str, path: Optional[str] = None) -> TelemetrySink:
    """Instantiate a registered sink.  ``memory`` ignores ``path``; the file
    sinks require one."""
    if kind not in SINKS:
        raise ValueError(f"unknown telemetry sink {kind!r}; have "
                         f"{sorted(SINKS)}")
    return SINKS[kind](path) if kind != "memory" else MemorySink()


# -- read-back helpers (report.py + tests) -----------------------------------

def read_jsonl(path: str) -> list[dict]:
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def read_csv(path: str) -> list[dict]:
    """Rows with numeric-looking cells converted back to floats."""
    out = []
    with open(path) as fh:
        for row in csv.DictReader(fh):
            conv = {}
            for k, v in row.items():
                try:
                    conv[k] = float(v)
                except (TypeError, ValueError):
                    conv[k] = v
            out.append(conv)
    return out
