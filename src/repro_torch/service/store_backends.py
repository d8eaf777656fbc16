"""Pluggable storage backends for the artifact store (DESIGN.md §14.1) —
the port's own copy of ``repro.service.store_backends`` (standard library
only, kept identical so both packages read and write one store).

The ``ArtifactStore`` addresses artifacts by content digest; *where* the
bytes live is this module's concern. A backend is a flat key/value space
of opaque slash-separated keys with four verbs — put/get/list/delete —
plus streaming reads, so the store's publish protocol (staged upload,
manifest committed last; §14.2) composes over any of them.

Two implementations:

- ``LocalDirBackend`` — the original on-disk layout, one file per key
  under a root directory. ``put`` is atomic via tmp-file + ``os.replace``;
  ``local_path`` exposes the real file so model/dataset loads stay
  zero-copy.
- ``ObjectStoreBackend`` — a simulated object store (S3/GCS-shaped): an
  in-memory bucket shared between any number of handle views
  (``share()``), per-op injectable latency, and a fault hook that can
  raise, tear a write in half, lose a read, or fail *after* the write
  landed — the failure modes the crash-consistency suite drives
  (tests/test_store_backends.py). Keys are atomic: a reader sees the old
  bytes or the new bytes, never a mix, unless a "torn" fault was
  explicitly injected.

Fault hooks are callables ``(op, key) -> Optional[str]`` evaluated before
each operation; ``ScriptedFaults`` builds deterministic one-shot
schedules from them. A backend failure surfaces as ``BackendError``,
a subclass of ``OSError`` so the store's existing fault-tolerance
contract (caching failures cost the cache, not the training) covers
remote backends for free.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple


class BackendError(OSError):
    """A storage-backend operation failed (network, fault injection, …)."""


# A fault hook inspects (op, key) and returns None (no fault) or one of:
#   "raise"       fail before any side effect
#   "raise_after" (put only) write lands, then the call fails — the
#                 ambiguous-ack case behind duplicate publishes
#   "torn"        (put only) roughly half the bytes land, then the call
#                 fails — a torn payload a checksum must catch
#   "lost"        (get only) pretend the key is missing
FaultHook = Callable[[str, str], Optional[str]]


class ScriptedFaults:
    """Deterministic one-shot fault schedule.

    ``entries`` is a list of ``(match, action)`` pairs; each fires at most
    once, in order. ``match`` is an op name (``"put"``), an
    ``(op, key_substring)`` pair, or a predicate ``(op, key) -> bool``.
    Thread-safe: concurrent hosts sharing a schedule consume entries
    exactly once.
    """

    def __init__(self, entries: Iterable[Tuple[object, str]]):
        self._entries: List[Optional[Tuple[object, str]]] = list(entries)
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, str, str]] = []

    def __call__(self, op: str, key: str) -> Optional[str]:
        with self._lock:
            for i, entry in enumerate(self._entries):
                if entry is None:
                    continue
                match, action = entry
                if callable(match):
                    hit = bool(match(op, key))
                elif isinstance(match, tuple):
                    hit = op == match[0] and match[1] in key
                else:
                    hit = op == match
                if hit:
                    self._entries[i] = None
                    self.fired.append((op, key, action))
                    return action
        return None

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(e is not None for e in self._entries)


class StoreBackend:
    """Flat key/value storage behind :class:`ArtifactStore`.

    Keys are opaque ``/``-separated strings. ``put`` must be atomic per
    key (barring injected torn writes); there is no atomicity across
    keys — the store's manifest-last protocol provides that.
    """

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_stream(self, key: str,
                   chunk_size: int = 1 << 20) -> Optional[Iterator[bytes]]:
        """Key-at-a-time streaming read (the modelzoo streaming-checkpoint
        idiom): an iterator of chunks, or None if the key is missing.
        Subclasses with real streaming override; the default chunks one
        ``get``."""
        data = self.get(key)
        if data is None:
            return None
        return (data[i:i + chunk_size]
                for i in range(0, max(len(data), 1), chunk_size))

    def list(self, prefix: str = "") -> List[str]:
        """All keys under ``prefix``, sorted."""
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> int:
        """Remove every key under ``prefix``; returns how many went."""
        n = 0
        for key in self.list(prefix):
            if self.delete(key):
                n += 1
        return n

    def mtime(self, key: str) -> Optional[float]:
        """Last-modified time, for age-gated GC of staged uploads."""
        raise NotImplementedError

    def local_path(self, key: str) -> Optional[str]:
        """A filesystem path holding this key's bytes, when the backend has
        one (fast path for .npz loads); None for remote backends."""
        return None


class LocalDirBackend(StoreBackend):
    """Keys are relative file paths under ``root`` — the store's original
    on-disk layout, unchanged, so pre-backend stores read back as-is."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.put.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            return None

    def get_stream(self, key: str,
                   chunk_size: int = 1 << 20) -> Optional[Iterator[bytes]]:
        path = self._path(key)
        if not os.path.isfile(path):
            return None

        def chunks() -> Iterator[bytes]:
            with open(path, "rb") as f:
                while True:
                    chunk = f.read(chunk_size)
                    if not chunk:
                        return
                    yield chunk
        return chunks()

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            base = "" if rel == "." else rel.replace(os.sep, "/") + "/"
            if not dirnames and not filenames and base:
                # an empty directory (e.g. a crashed writer's bare tmp dir)
                # is still listable garbage — surface it as a pseudo-key so
                # sweep() can age it out
                key = base
                if key.startswith(prefix):
                    out.append(key)
            for name in filenames:
                key = base + name
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> bool:
        path = self._path(key)
        try:
            if key.endswith("/"):
                os.rmdir(path)
            else:
                os.unlink(path)
            return True
        except OSError:
            return False

    def delete_prefix(self, prefix: str) -> int:
        import shutil
        n = len([k for k in self.list(prefix) if not k.endswith("/")])
        target = self._path(prefix.rstrip("/"))
        if os.path.isdir(target):
            shutil.rmtree(target, ignore_errors=True)
            return n
        return super().delete_prefix(prefix)

    def mtime(self, key: str) -> Optional[float]:
        try:
            return os.path.getmtime(self._path(key.rstrip("/")))
        except OSError:
            return None

    def local_path(self, key: str) -> Optional[str]:
        path = self._path(key)
        return path if os.path.isfile(path) else None


class ObjectStoreBackend(StoreBackend):
    """Simulated object store: a dict bucket of ``key -> (bytes, mtime)``
    behind one lock, shareable between host views.

    ``share()`` returns a new handle over the *same* bucket with its own
    fault schedule and latency — the multi-host fleet tests give every
    simulated host its own view of one shared store. ``latency_s`` sleeps
    (via the injectable ``sleep``) once per operation; ``clock`` stamps
    mtimes, so age-gated GC works under a fake clock.
    """

    def __init__(self, bucket: Optional[Dict[str, Tuple[bytes, float]]] = None,
                 *, latency_s: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.time,
                 faults: Optional[FaultHook] = None,
                 lock: Optional[threading.RLock] = None):
        self._bucket: Dict[str, Tuple[bytes, float]] = (
            bucket if bucket is not None else {})
        self._lock = lock if lock is not None else threading.RLock()
        self.latency_s = latency_s
        self._sleep = sleep
        self._clock = clock
        self.faults = faults
        self.op_counts: Dict[str, int] = {}

    def share(self, *, faults: Optional[FaultHook] = None,
              latency_s: Optional[float] = None) -> "ObjectStoreBackend":
        """A new view over the same bucket (another host's handle)."""
        return ObjectStoreBackend(
            self._bucket, lock=self._lock,
            latency_s=self.latency_s if latency_s is None else latency_s,
            sleep=self._sleep, clock=self._clock, faults=faults)

    def _enter(self, op: str, key: str) -> Optional[str]:
        self.op_counts[op] = self.op_counts.get(op, 0) + 1
        if self.latency_s:
            self._sleep(self.latency_s)
        action = self.faults(op, key) if self.faults is not None else None
        if action == "raise":
            raise BackendError(f"injected fault: {op} {key}")
        return action

    def put(self, key: str, data: bytes) -> None:
        action = self._enter("put", key)
        data = bytes(data)
        with self._lock:
            if action == "torn":
                self._bucket[key] = (data[:max(1, len(data) // 2)],
                                     self._clock())
                raise BackendError(f"injected fault: torn put {key}")
            self._bucket[key] = (data, self._clock())
        if action == "raise_after":
            raise BackendError(f"injected fault: put acked late {key}")

    def get(self, key: str) -> Optional[bytes]:
        action = self._enter("get", key)
        if action == "lost":
            return None
        with self._lock:
            entry = self._bucket.get(key)
        return entry[0] if entry is not None else None

    def list(self, prefix: str = "") -> List[str]:
        self._enter("list", prefix)
        with self._lock:
            return sorted(k for k in self._bucket if k.startswith(prefix))

    def delete(self, key: str) -> bool:
        self._enter("delete", key)
        with self._lock:
            return self._bucket.pop(key, None) is not None

    def mtime(self, key: str) -> Optional[float]:
        with self._lock:
            entry = self._bucket.get(key)
        return entry[1] if entry is not None else None


def get_backend(spec: str, root: str) -> StoreBackend:
    """CLI-facing factory: ``"local"`` (directory at ``root``) or
    ``"object"`` (fresh in-process simulated object store — a demo stand-in
    for a real bucket client)."""
    if spec == "local":
        return LocalDirBackend(root)
    if spec == "object":
        return ObjectStoreBackend()
    raise ValueError(f"unknown store backend {spec!r} "
                     f"(expected 'local' or 'object')")
