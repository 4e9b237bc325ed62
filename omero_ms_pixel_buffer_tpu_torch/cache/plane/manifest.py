"""Crash-consistent disk-tier manifest: warm restarts for the spill tier
(copy of ``omero_ms_pixel_buffer_tpu/cache/plane/manifest.py``, with the
clocks injectable).

- **Append-only journal** (``manifest.journal`` in the spill directory):
  one checksummed record per admission or eviction,
  ``<crc32-hex> <compact-json>\\n``. Appends are buffered writes with no
  fsync a record: losing the journal's tail in a crash means a slightly
  colder restart, never corruption.
- **Replay at start-up**: records apply in order (an admit overwrites,
  an evict deletes). Replay stops at the first record whose checksum or
  framing fails (a torn tail from a crash mid-append) and truncates the
  journal there.
- **Reconcile against the directory**: entries whose file is missing or
  of another size are dropped; ``.tile``/``.tmp`` files the journal does
  not claim are orphans and are deleted, then the directory is fsynced,
  so a crash mid-cleanup cannot resurrect them.
- **Compaction**: past ``compact_bytes`` the journal is rewritten as the
  live index's admits (tmp + fsync + rename + directory fsync). Start-up
  always compacts after reconcile.

``snapshot`` adds ``replay_s`` (the seconds ``restore`` took) to the JAX
keys. Timestamps are journaled on the wall clock and rebased onto the
monotonic clock at replay (``stored_at`` feeds the TTL rule).
``wall_clock`` and ``mono_clock`` default to ``time.time`` and
``time.monotonic``.

Everything here runs on the cache's single I/O thread or at
construction: blocking file I/O is the point.
"""

from __future__ import annotations

import json
import logging
import os
import time
import zlib
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cache.plane")

JOURNAL_NAME = "manifest.journal"


def fsync_dir(path: str) -> None:
    """Durably commit a directory's entry operations (rename, unlink).
    Best effort where the platform refuses it."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _frame(payload: bytes) -> bytes:
    return b"%08x %s\n" % (zlib.crc32(payload), payload)


def _encode(record: dict) -> bytes:
    return _frame(json.dumps(record, separators=(",", ":")).encode())


class DiskManifest:
    """The journal of one spill directory. Its owner (``DiskTier``) calls
    ``restore()`` once at construction, then ``record_admit`` and
    ``record_evict`` from its I/O thread."""

    def __init__(self, directory: str, compact_bytes: int = 1 << 20,
                 wall_clock: Optional[Callable[[], float]] = None,
                 mono_clock: Optional[Callable[[], float]] = None):
        self.directory = directory
        self.path = os.path.join(directory, JOURNAL_NAME)
        self.compact_bytes = compact_bytes
        self._wall = wall_clock or time.time
        self._mono = mono_clock or time.monotonic
        self._fh = None
        self._closed = False
        self._journal_bytes = 0
        self.replayed = 0
        self.torn = False
        self.orphans_removed = 0
        self.dropped_missing = 0
        self.replay_s = 0.0

    # -- start-up: replay + reconcile ----------------------------------

    def restore(self, fname_of: Callable[[str], str]
                ) -> List[Tuple[str, int, str, str, float]]:
        """Replay the journal and reconcile it against the directory: the
        live entries as ``(key, nbytes, etag, filename,
        stored_at_monotonic)`` in admission order. Leaves the journal
        compacted."""
        t0 = time.perf_counter()
        index = self._replay()
        live: "OrderedDict[str, dict]" = OrderedDict()
        claimed = set()
        for key, meta in index.items():
            file_name = fname_of(key)
            try:
                actual = os.path.getsize(os.path.join(self.directory, file_name))
            except OSError:
                actual = -1
            if actual != meta["n"]:
                # the admit record outran its data (or the file was
                # truncated): dropped, and the orphan pass removes the file
                self.dropped_missing += 1
                continue
            claimed.add(file_name)
            live[key] = meta
        removed = False
        for name in os.listdir(self.directory):
            if name == JOURNAL_NAME or not name.endswith((".tile", ".tmp")):
                continue
            if name in claimed:
                continue
            try:
                os.unlink(os.path.join(self.directory, name))
                self.orphans_removed += 1
                removed = True
            except OSError:
                pass
        if removed:
            fsync_dir(self.directory)
        self.replayed = len(live)
        self.compact([(k, m["n"], m["etag"], m["fn"], m["wall"]) for k, m in live.items()],
                     raw_wall=True)
        now_mono, now_wall = self._mono(), self._wall()
        self.replay_s = time.perf_counter() - t0
        return [(k, m["n"], m["etag"], m["fn"], now_mono - max(0.0, now_wall - m["wall"]))
                for k, m in live.items()]

    def _replay(self) -> "OrderedDict[str, dict]":
        index: "OrderedDict[str, dict]" = OrderedDict()
        try:
            fh = open(self.path, "rb")
        except FileNotFoundError:
            return index
        with fh:
            good_offset = 0
            while True:
                line = fh.readline()
                if not line:
                    break
                record = self._parse(line)
                if record is None:
                    # a torn tail or corruption: what precedes it stays
                    self.torn = True
                    break
                good_offset += len(line)
                op, key = record.get("op"), record.get("key")
                if op == "admit" and isinstance(key, str):
                    index[key] = {"n": int(record["n"]), "etag": record.get("etag") or "",
                                  "fn": record.get("fn") or "",
                                  "wall": float(record.get("wall") or 0.0)}
                    index.move_to_end(key)
                elif op == "evict" and isinstance(key, str):
                    index.pop(key, None)
        if self.torn:
            try:
                with open(self.path, "rb+") as fh:
                    fh.truncate(good_offset)
            except OSError:
                pass
        return index

    @staticmethod
    def _parse(line: bytes):
        if not line.endswith(b"\n"):
            return None  # torn: the last append never finished
        body = line[:-1]
        if len(body) < 10 or body[8:9] != b" ":
            return None
        payload = body[9:]
        try:
            if int(body[:8], 16) != zlib.crc32(payload):
                return None
            record = json.loads(payload)
        except (ValueError, UnicodeDecodeError):
            return None
        return record if isinstance(record, dict) else None

    # -- appends (the tier's I/O thread) -------------------------------

    def _append(self, record: dict) -> None:
        if self._closed:
            # a spill racing close() must not reopen the journal: a
            # successor may already be compacting this path (the file
            # reconciles as an orphan at the next start)
            raise OSError("manifest journal closed")
        if self._fh is None:
            self._fh = open(self.path, "ab")
            self._journal_bytes = self._fh.tell()
        framed = _encode(record)
        self._fh.write(framed)
        self._fh.flush()  # to the OS; no fsync (module docstring)
        self._journal_bytes += len(framed)

    def record_admit(self, key: str, nbytes: int, etag: str, filename: str,
                     stored_at_monotonic: float) -> None:
        wall = self._wall() - max(0.0, self._mono() - stored_at_monotonic)
        self._append({"op": "admit", "key": key, "n": nbytes, "etag": etag,
                      "fn": filename, "wall": wall})

    def record_evict(self, key: str) -> None:
        self._append({"op": "evict", "key": key})

    @property
    def needs_compaction(self) -> bool:
        return self._journal_bytes > self.compact_bytes

    def compact(self, live: List[tuple], raw_wall: bool = False) -> None:
        """Atomically rewrite the journal as the admits of ``live`` entries
        ``(key, nbytes, etag, filename, stored_at)``: the tmp file is
        fsynced before the rename and the directory after it, so a crash
        leaves the old journal or the new one, never a mix."""
        if self._closed:
            return  # a successor owns the path now
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        tmp = self.path + ".compact"
        now_mono, now_wall = self._mono(), self._wall()
        with open(tmp, "wb") as fh:
            for key, nbytes, etag, filename, stored_at in live:
                wall = stored_at if raw_wall else now_wall - max(0.0, now_mono - stored_at)
                fh.write(_encode({"op": "admit", "key": key, "n": nbytes, "etag": etag,
                                  "fn": filename, "wall": wall}))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        fsync_dir(self.directory)
        self._journal_bytes = os.path.getsize(self.path)

    def close(self) -> None:
        self._closed = True
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def snapshot(self) -> dict:
        """The JAX snapshot, and ``replay_s``: the seconds ``restore`` took
        (replay, reconcile and compaction; the port's addition)."""
        return {"journal_bytes": self._journal_bytes, "replayed": self.replayed,
                "torn_tail": self.torn, "orphans_removed": self.orphans_removed,
                "dropped_missing": self.dropped_missing, "replay_s": self.replay_s}
