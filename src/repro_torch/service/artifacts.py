"""Content-addressed artifact store — service layer L2 (DESIGN.md §7.2, §14).

Persists trained ``PerfModel``s, selections, and plan metadata so repeat
optimisation runs warm-start in milliseconds — the paper's Table 4 claim
("optimising a network costs seconds, not hours") made operational across
process restarts, and (§14) across *hosts*: the store now sits on a
pluggable :class:`~store_backends.StoreBackend`, so a fleet
of serving machines shares one calibration instead of each re-profiling.

Addressing: an artifact's identity is a dict of key fields — canonically
(platform fingerprint, backend name, columns, dataset fingerprint, model
kind) plus role/mode/seed — serialised to canonical JSON and hashed
(sha256, 16 hex chars). Same inputs => same address => warm hit; any drift
in the profiled data or model configuration changes the address and forces
a retrain. No cache-invalidation logic exists because none is needed.
The backend name rides in every model and selection address (DESIGN.md §9)
so two backends optimising the same network can never collide on an
artifact, even if their platform fingerprints were ever to coincide — each
backend's warm start is byte-identical to its own cold result.

Durability — the staged-upload-then-manifest-commit protocol (§14.2):
an entry is the key group ``{category}/{digest}/``. Publish uploads the
payload under a fresh staged name (``stage.<pid>-<seq>.<payload>``),
then commits ``manifest.json`` — payload checksum, key fields, and the
staged payload name — with one atomic key put, LAST. An entry without a
manifest, or whose manifest's payload is missing or checksum-mismatched,
is invisible. A writer killed at any point leaves either the old entry
(manifest still names the old payload) or the new one — never a readable
partial — and ``sweep()`` collects the orphaned staged uploads. Entries
written by the pre-backend layout (payload under its plain name) remain
readable.

Fleet calibration pooling (§14.3): ``publish_drift`` pushes a host's
served-traffic ``PerfDataset`` (drift attribution, DESIGN.md §8.5) into
the shared ``drift_pool`` category keyed by platform fingerprint;
``pooled_drift`` returns every *other* host's newest evidence for the
same fingerprint, so one host's drift excursion becomes every host's
free recalibration.

The port of ``repro.service.artifacts``: ``digest``, the key fields, the
layout and the payloads (``model.npz``, ``data.json``, ``dataset.npz``) are
the reference's, so either package reads what the other wrote. The store
also names the device its models load onto and train on (``device``).
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.perfmodel import PerfModel
from repro_torch.profiler.dataset import PerfDataset
from repro_torch.service.store_backends import (BackendError, LocalDirBackend,
                                                StoreBackend)

_MODEL_PAYLOAD = "model.npz"
_JSON_PAYLOAD = "data.json"
_DATASET_PAYLOAD = "dataset.npz"
_MANIFEST = "manifest.json"


def digest(fields: Dict[str, Any]) -> str:
    """Canonical-JSON sha256 address of a key-field dict."""
    blob = json.dumps(fields, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class ArtifactStore:
    def __init__(self, root: Optional[str] = None, keep: Optional[int] = None,
                 *, backend: Optional[StoreBackend] = None,
                 clock: Callable[[], float] = time.time,
                 device="cuda"):
        """``keep`` enables opportunistic per-category GC: after every put,
        only the newest ``keep`` artifacts of that category are retained
        (à la ``ckpt/manager.py``) — so e.g. the serving drift loop's
        recalibration generations cannot grow the store without bound.
        ``None`` (default) keeps everything. Retention is by age alone:
        ``keep`` must cover the category's live working set (e.g. one
        model pair per platform in ``models``) or warm-starts silently
        thrash.

        ``backend`` selects where bytes live; default is the original
        local directory at ``root``. ``clock`` stamps manifests and drives
        age-gated GC — injectable for deterministic fleet tests.
        ``device`` is where ``get_model`` and ``get_or_train`` place the
        models they load, and where the platforms train the models a miss
        asks for."""
        if keep is not None and keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if backend is None:
            if root is None:
                raise ValueError("ArtifactStore needs a root or a backend")
            backend = LocalDirBackend(root)
        self.root = root
        self.keep = keep
        self.backend = backend
        self.clock = clock
        self.device = device
        self._seq = itertools.count()

    # -- keys ----------------------------------------------------------------
    def _prefix(self, category: str, key: str) -> str:
        return f"{category}/{key}"

    def path(self, category: str, fields: Dict[str, Any]) -> str:
        """The entry's location: a real directory for the local backend,
        the key prefix otherwise."""
        prefix = self._prefix(category, digest(fields))
        if isinstance(self.backend, LocalDirBackend):
            return os.path.join(self.backend.root, *prefix.split("/"))
        return prefix

    # -- manifest / validity -------------------------------------------------
    def _manifest(self, category: str, key: str) -> Optional[Dict[str, Any]]:
        try:
            data = self.backend.get(f"{self._prefix(category, key)}/{_MANIFEST}")
            if data is None:
                return None
            return json.loads(data.decode())
        except (OSError, ValueError, UnicodeDecodeError):
            return None

    def _checksum_ok(self, category: str, key: str,
                     man: Dict[str, Any]) -> bool:
        payload = man.get("payload")
        if not isinstance(payload, str):
            return False
        try:
            stream = self.backend.get_stream(
                f"{self._prefix(category, key)}/{payload}")
            if stream is None:
                return False
            h = hashlib.sha256()
            for chunk in stream:
                h.update(chunk)
            return man.get("checksum") == h.hexdigest()
        except (OSError, ValueError):
            return False

    def _valid_manifest(self, category: str,
                        key: str) -> Optional[Dict[str, Any]]:
        man = self._manifest(category, key)
        if man is None or not self._checksum_ok(category, key, man):
            return None
        return man

    # -- generic put/get -----------------------------------------------------
    def _put(self, category: str, fields: Dict[str, Any], payload_name: str,
             write_payload: Callable[[str], None]) -> str:
        key = digest(fields)
        prefix = self._prefix(category, key)
        with tempfile.TemporaryDirectory(prefix="artifact.") as td:
            local = os.path.join(td, payload_name)
            write_payload(local)
            checksum = _file_sha256(local)
            with open(local, "rb") as f:
                data = f.read()
        staged = f"stage.{os.getpid()}-{next(self._seq)}.{payload_name}"
        # 1) staged upload — invisible: no manifest names it yet
        self.backend.put(f"{prefix}/{staged}", data)
        manifest = {
            "key": key,
            "fields": fields,
            "payload": staged,
            "checksum": checksum,
            "created": self.clock(),
        }
        # 2) commit — one atomic key put marks the entry complete and
        #    atomically supersedes any previous payload of this address
        self.backend.put(
            f"{prefix}/{_MANIFEST}",
            json.dumps(manifest, indent=1, default=str).encode())
        self._collect_superseded(category, key)
        if self.keep is not None:
            self.sweep(self.keep, category=category)
        return self.path(category, fields)

    def _collect_superseded(self, category: str, key: str) -> None:
        """Best-effort: drop payloads the committed manifest no longer
        names (an overwritten entry's old bytes). Re-reads the manifest so
        a concurrent same-address publisher's winning payload survives."""
        prefix = self._prefix(category, key)
        try:
            man = self._manifest(category, key)
            live = man.get("payload") if man else None
            for k in self.backend.list(prefix + "/"):
                rest = k[len(prefix) + 1:]
                if rest in (_MANIFEST, live) or not rest:
                    continue
                self.backend.delete(k)
        except OSError:
            pass

    def _load(self, category: str, fields: Dict[str, Any],
              loader: Callable[[str], Any]) -> Optional[Any]:
        """Validate, then hand the payload to a path-based loader — via the
        backend's local file when it has one, else through a temp spool."""
        key = digest(fields)
        man = self._valid_manifest(category, key)
        if man is None:
            return None
        payload_key = f"{self._prefix(category, key)}/{man['payload']}"
        local = self.backend.local_path(payload_key)
        if local is not None:
            return loader(local)
        stream = self.backend.get_stream(payload_key)
        if stream is None:
            return None
        with tempfile.TemporaryDirectory(prefix="artifact.") as td:
            spool = os.path.join(td, os.path.basename(man["payload"]))
            with open(spool, "wb") as f:
                for chunk in stream:
                    f.write(chunk)
            return loader(spool)

    # -- models --------------------------------------------------------------
    def put_model(self, fields: Dict[str, Any], model: PerfModel) -> str:
        return self._put("models", fields, _MODEL_PAYLOAD, model.save)

    def get_model(self, fields: Dict[str, Any]) -> Optional[PerfModel]:
        return self._load("models", fields,
                          lambda path: PerfModel.load(path, self.device))

    def get_or_train(self, fields: Dict[str, Any],
                     train_fn: Callable[[], PerfModel]) -> Tuple[PerfModel, bool]:
        """(model, warm): warm-load on address hit, else train and persist.
        A store that fails to persist (read-only root, unreachable backend)
        never discards the freshly trained model — caching failures cost
        the cache, not the training."""
        try:
            m = self.get_model(fields)
        except OSError:
            m = None
        if m is not None:
            return m, True
        m = train_fn()
        try:
            self.put_model(fields, m)
        except OSError:
            pass
        return m, False

    # -- JSON artifacts (selections, plan metadata) --------------------------
    def put_json(self, category: str, fields: Dict[str, Any], obj: Any) -> str:
        def write(path: str) -> None:
            with open(path, "w") as f:
                json.dump(obj, f, indent=1, default=str)
        return self._put(category, fields, _JSON_PAYLOAD, write)

    def get_json(self, category: str, fields: Dict[str, Any]) -> Optional[Any]:
        def load(path: str) -> Any:
            with open(path) as f:
                return json.load(f)
        return self._load(category, fields, load)

    # -- datasets (profiled-measurement warm-start, pooled drift evidence) ---
    def put_dataset(self, fields: Dict[str, Any], dataset,
                    category: str = "datasets") -> str:
        return self._put(category, fields, _DATASET_PAYLOAD, dataset.save)

    def get_dataset(self, fields: Dict[str, Any],
                    category: str = "datasets"):
        return self._load(category, fields, PerfDataset.load)

    def delete(self, category: str, fields: Dict[str, Any]) -> bool:
        """Remove one artifact (e.g. a host dataset known to be stale after
        platform drift). True if something was deleted."""
        prefix = self._prefix(category, digest(fields))
        try:
            return self.backend.delete_prefix(prefix + "/") > 0
        except OSError:
            return False

    # -- fleet calibration pooling (DESIGN.md §14.3) -------------------------
    def publish_drift(self, platform_fp: str, dataset, *, host: str,
                      net: Optional[str] = None) -> str:
        """Publish one host's served-traffic evidence for its platform
        fingerprint. Monotonic per-host ``seq`` makes re-publishes ordered;
        one retry absorbs a transient backend fault (the commit protocol
        makes a half-published attempt invisible, so retrying is safe)."""
        seq = 0
        for man in self.drift_entries(platform_fp):
            f = man.get("fields", {})
            if f.get("host") == host:
                seq = max(seq, int(f.get("seq", 0)) + 1)
        fields = {"artifact": "drift_pool", "platform": platform_fp,
                  "host": host, "net": net, "seq": seq,
                  "data": dataset.fingerprint()}
        try:
            return self.put_dataset(fields, dataset, category="drift_pool")
        except BackendError:
            return self.put_dataset(fields, dataset, category="drift_pool")

    def drift_entries(self, platform_fp: str,
                      exclude_host: Optional[str] = None) -> List[Dict[str, Any]]:
        """Valid drift-pool manifests for ``platform_fp``, ordered by
        (host, seq) for determinism."""
        out = []
        for man in self.entries("drift_pool"):
            f = man.get("fields", {})
            if f.get("platform") != platform_fp:
                continue
            if exclude_host is not None and f.get("host") == exclude_host:
                continue
            out.append(man)
        out.sort(key=lambda m: (str(m["fields"].get("host")),
                                int(m["fields"].get("seq", 0)),
                                m.get("key", "")))
        return out

    def pooled_drift(self, platform_fp: str, *,
                     exclude_host: Optional[str] = None) -> List["Any"]:
        """The fleet's pooled evidence: each other host's newest dataset
        for this fingerprint. Unreadable entries (a host mid-publish, a
        faulty backend read) are skipped, not fatal — pooling is additive."""
        newest: Dict[str, Dict[str, Any]] = {}
        for man in self.drift_entries(platform_fp, exclude_host=exclude_host):
            newest[str(man["fields"].get("host"))] = man
        out = []
        for host in sorted(newest):
            man = newest[host]
            try:
                ds = self.get_dataset(man["fields"], category="drift_pool")
            except (OSError, ValueError):
                ds = None
            if ds is not None and ds.n:
                out.append(ds)
        return out

    # -- retention / GC ------------------------------------------------------
    def sweep(self, keep: Optional[int] = None,
              category: Optional[str] = None,
              grace_s: float = 3600.0) -> int:
        """Garbage-collect the store. Always removed: corrupt or partially
        written entries (missing/unparsable manifest, payload missing or
        checksum-mismatched — invisible to reads but otherwise immortal),
        stale ``tmp.`` dirs from pre-backend crashed writers, and orphaned
        staged uploads older than ``grace_s`` that no manifest names. With
        ``keep`` additionally retain only the newest ``keep`` valid
        artifacts per category (manifest ``created`` time; ties broken by
        key for determinism). ``keep=None`` is the pure GC pass: collect
        garbage, trim nothing. Returns the number of *entries* removed
        (orphaned staged keys and tmp dirs are collected but not counted,
        matching the original semantics)."""
        removed = 0
        now = self.clock()
        groups: Dict[Tuple[str, str], List[str]] = {}
        try:
            keys = self.backend.list(f"{category}/" if category else "")
        except OSError:
            return 0
        for k in keys:
            parts = k.split("/")
            # a bare "<category>/" pseudo-key (empty local dir) is not an
            # entry — deleting its "" group would rmtree the whole category
            if len(parts) < 2 or not parts[1]:
                continue
            groups.setdefault((parts[0], parts[1]), []).append(
                "/".join(parts[2:]))
        by_cat: Dict[str, List[Tuple[float, str]]] = {}
        for (cat, entry), rests in sorted(groups.items()):
            prefix = f"{cat}/{entry}"
            # every per-entry read tolerates a concurrent sweeper (e.g. a
            # drift-recalibration thread) deleting it under us
            try:
                if entry.startswith("tmp."):
                    mt = self.backend.mtime(prefix + "/")
                    if mt is None:
                        mt = max((self.backend.mtime(f"{prefix}/{r}") or now)
                                 for r in rests)
                    if now - mt > grace_s:
                        self.backend.delete_prefix(prefix + "/")
                    continue
                man = self._manifest(cat, entry)
                if man is None or not self._checksum_ok(cat, entry, man):
                    self.backend.delete_prefix(prefix + "/")
                    removed += 1
                    continue
                live = man.get("payload")
                for rest in rests:
                    if (rest.startswith("stage.") and rest != live):
                        mt = self.backend.mtime(f"{prefix}/{rest}")
                        if mt is None or now - mt > grace_s:
                            self.backend.delete(f"{prefix}/{rest}")
                created = float(man.get("created", 0.0))
            except (OSError, ValueError):
                continue
            by_cat.setdefault(cat, []).append((created, entry))
        if keep is not None and keep > 0:
            for cat, aged in by_cat.items():
                aged.sort()
                for _, entry in aged[:-keep]:
                    try:
                        self.backend.delete_prefix(f"{cat}/{entry}/")
                        removed += 1
                    except OSError:
                        continue
        return removed

    # -- introspection -------------------------------------------------------
    def entries(self, category: Optional[str] = None) -> List[Dict[str, Any]]:
        """Manifests of all valid artifacts (debugging / GC tooling / fleet
        pooling)."""
        out = []
        try:
            keys = self.backend.list(f"{category}/" if category else "")
        except OSError:
            return []
        seen = set()
        for k in sorted(keys):
            parts = k.split("/")
            if len(parts) < 2 or not parts[1]:
                continue
            cat, entry = parts[0], parts[1]
            if (cat, entry) in seen or entry.startswith("tmp."):
                continue
            seen.add((cat, entry))
            man = self._valid_manifest(cat, entry)
            if man is None:
                continue
            man["category"] = cat
            out.append(man)
        return out


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
