"""Process-level serving front end — the port of
``repro.service.serving.frontend`` (DESIGN.md §12).

Python-side batch assembly (ticket intake, payload copies, pow2 padding,
result slicing) holds the serving process's GIL, which the port's worker
threads already contend for while they replay plans. This module moves
batch assembly into **intake processes**:

  * ``SlabPool`` — a shared-memory tensor pool: preallocated pow2-bucket
    slabs (``multiprocessing.shared_memory``) recycled through a free-list
    ring. An intake process writes each request payload ONCE into a slab
    row; everything downstream passes the ``SlabHandle`` by reference.
  * ``_intake_main`` — the intake process body: receives requests (or
    synthesizes load in ``drive`` mode), assembles pow2-padded batches
    directly inside a slab, and emits compact batch descriptors.
  * ``ProcessFrontend`` — the parent-side manager: a dispatcher thread
    turns descriptors into pre-assembled ``BatchGroup``s (zero-copy slab
    views) that the serving core's workers execute directly; results ship
    back to the owning intake in one bulk message per batch, where per-row
    slicing happens off the serving process's GIL.

On a cuda server the parent page-locks every slab segment once when the
front end starts (``OptimisedServer._pin_slabs``), so a group's padded batch
goes to the card in one asynchronous copy on the executing worker's stream;
the segments are unregistered after a device sync, before they are closed.

Slab lifecycle: intake ``alloc`` → intake writes rows + pad → dispatcher
``view`` (zero-copy) → workers execute the view → the dispatch settles →
``on_done`` frees the slab and ships results. The free happens only after
every ticket of the batch settled (the core's ``finally`` guarantees it), so
a recycled slot can never be overwritten under a live dispatch; a zombie
worker still reading a recycled slab sees bytes whose output is discarded
by the first-finish-wins settle — stale reads are harmless by construction.
Handles carry a per-slot generation: ``free``/``view`` with a stale handle
raise instead of silently aliasing a newer allocation.

Fault tolerance is unchanged: groups route through the same breaker-gated
scorer as loose tickets, execute under the fault injector, degrade per
ticket under the same rule as loose tickets, and settle idempotently — the
shared-memory path changes where bytes live, not the delivery contract.

Intake processes use the ``spawn`` start method and import only numpy, this
module and ``queues`` — never torch (the ``repro_torch`` package
``__init__``s load their submodules lazily), so no intake process touches
the card.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue as pyqueue
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import multiprocessing as mp
from multiprocessing import shared_memory

import numpy as np

from repro_torch.service.serving.queues import Ticket, pow2_ceil

_CTX = mp.get_context("spawn")

# intake assembly: how long an alloc retries when the pool is exhausted
# (server-side frees are what replenish it) before the batch is rejected
ALLOC_WAIT_S = 5.0
ALLOC_POLL_S = 0.001
# parent dispatcher/reply loops: bounded poll so stop() is prompt without
# busy-spinning (queue.get blocks in C, releasing the GIL)
PARENT_POLL_S = 0.1


@dataclasses.dataclass(frozen=True)
class SlabHandle:
    """A by-reference claim on one slab: pow2 ``bucket`` rows in ``slot`` of
    that bucket's segment. ``generation`` is the slot's allocation epoch —
    a freed handle goes stale and any further ``view``/``free`` raises."""

    bucket: int
    slot: int
    generation: int


class SlabPool:
    """Preallocated pow2-bucket shared-memory slabs + a free-list ring.

    One data segment per bucket (``slots`` slabs of ``bucket`` images each)
    plus one int64 control segment holding, per bucket: ring head, free
    count, the ring of free slot ids, and a per-slot generation counter.
    All mutation happens under one cross-process lock; ``view`` re-checks
    the generation unlocked as a best-effort stale-handle guard.

    The creating process owns the segments (``close(unlink=True)``);
    intake processes ``attach`` by name and only ever ``close()``.
    """

    def __init__(self, image_shape: Tuple[int, ...], *, max_batch: int = 32,
                 slots: int = 16, dtype=np.float32):
        self.image_shape = tuple(int(d) for d in image_shape)
        self.dtype = np.dtype(dtype)
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.buckets: List[int] = []
        b, top = 1, pow2_ceil(max_batch)
        while b <= top:
            self.buckets.append(b)
            b *= 2
        self.lock = _CTX.Lock()
        self._owner = True
        item = int(np.prod(self.image_shape)) * self.dtype.itemsize
        self._item = item
        self._data = {b: shared_memory.SharedMemory(
            create=True, size=max(b * item * self.slots, 1))
            for b in self.buckets}
        per = 2 + 2 * self.slots
        self._ctrl = shared_memory.SharedMemory(
            create=True, size=8 * per * len(self.buckets))
        self._c = np.ndarray((len(self.buckets), per), dtype=np.int64,
                             buffer=self._ctrl.buf)
        for bi in range(len(self.buckets)):
            row = self._c[bi]
            row[0] = 0                       # ring head
            row[1] = self.slots              # free count
            row[2:2 + self.slots] = np.arange(self.slots)   # the ring
            row[2 + self.slots:] = 0         # per-slot generation

    # -- cross-process handoff --------------------------------------------
    def spec(self) -> Dict:
        """Picklable attach recipe (segment names + geometry). The lock is
        NOT in here — multiprocessing primitives must travel through
        ``Process`` args, so pass ``(spec, lock)`` pairs."""
        return {"image_shape": self.image_shape, "dtype": self.dtype.str,
                "slots": self.slots, "buckets": list(self.buckets),
                "data": {b: self._data[b].name for b in self.buckets},
                "ctrl": self._ctrl.name}

    @classmethod
    def attach(cls, spec: Dict, lock) -> "SlabPool":
        """Map an existing pool by name. The attaching process never
        unlinks. Attachers must be processes sharing the owner's resource
        tracker (spawn children, or the owner's own process): attaching
        re-registers each segment with that one shared tracker, which is
        set-idempotent."""
        self = cls.__new__(cls)
        self.image_shape = tuple(spec["image_shape"])
        self.dtype = np.dtype(spec["dtype"])
        self.slots = int(spec["slots"])
        self.buckets = [int(b) for b in spec["buckets"]]
        self.lock = lock
        self._owner = False
        self._item = int(np.prod(self.image_shape)) * self.dtype.itemsize
        self._data = {}
        segs = []
        try:
            for b in self.buckets:
                self._data[b] = shared_memory.SharedMemory(
                    name=spec["data"][b])
                segs.append(self._data[b])
            self._ctrl = shared_memory.SharedMemory(name=spec["ctrl"])
        except BaseException:
            for s in segs:
                s.close()
            raise
        per = 2 + 2 * self.slots
        self._c = np.ndarray((len(self.buckets), per), dtype=np.int64,
                             buffer=self._ctrl.buf)
        return self

    def segments(self) -> List[Tuple[int, int]]:
        """``(address, bytes)`` of each data segment's mapping in this
        process — what the server page-locks for one-copy uploads."""
        out = []
        for b in self.buckets:
            buf = self._data[b].buf
            out.append((int(np.frombuffer(buf, np.uint8, count=1)
                            .ctypes.data), len(buf)))
        return out

    # -- alloc / free / view ----------------------------------------------
    def _index(self, bucket: int) -> int:
        b = pow2_ceil(bucket)
        try:
            return self.buckets.index(b)
        except ValueError:
            raise ValueError(f"bucket {bucket} outside pool ladder "
                             f"{self.buckets}") from None

    def alloc(self, bucket: int) -> Optional[SlabHandle]:
        """Claim one free slab of (at least) ``bucket`` rows; None when that
        bucket's ring is empty (backpressure — the server replenishes the
        ring as dispatches settle)."""
        bi = self._index(bucket)
        b = self.buckets[bi]
        with self.lock:
            row = self._c[bi]
            if row[1] == 0:
                return None
            head = int(row[0])
            slot = int(row[2 + head])
            row[0] = (head + 1) % self.slots
            row[1] -= 1
            gen = int(row[2 + self.slots + slot])
        return SlabHandle(bucket=b, slot=slot, generation=gen)

    def free(self, h: SlabHandle) -> None:
        """Return a slab to its ring. Bumps the slot generation, so the
        handle (and any copy of it) is dead afterwards — double frees and
        use-after-free raise instead of aliasing the next allocation."""
        bi = self._index(h.bucket)
        with self.lock:
            row = self._c[bi]
            if int(row[2 + self.slots + h.slot]) != h.generation:
                raise ValueError(f"stale slab handle {h}: slot already "
                                 f"recycled (double free?)")
            row[2 + self.slots + h.slot] += 1
            tail = (int(row[0]) + int(row[1])) % self.slots
            row[2 + tail] = h.slot
            row[1] += 1

    def view(self, h: SlabHandle, rows: Optional[int] = None) -> np.ndarray:
        """Zero-copy ndarray over the slab: ``(bucket, *image_shape)``, or
        the first ``rows`` of it. Raises on a stale handle."""
        bi = self._index(h.bucket)
        if int(self._c[bi, 2 + self.slots + h.slot]) != h.generation:
            raise ValueError(f"stale slab handle {h}")
        off = h.slot * h.bucket * self._item
        arr = np.ndarray((h.bucket,) + self.image_shape, dtype=self.dtype,
                         buffer=self._data[h.bucket].buf, offset=off)
        return arr if rows is None else arr[:rows]

    def available(self, bucket: int) -> int:
        bi = self._index(bucket)
        with self.lock:
            return int(self._c[bi, 1])

    # -- lifecycle ---------------------------------------------------------
    def close(self, unlink: Optional[bool] = None) -> None:
        """Unmap the segments; the owner also unlinks the names. Lingering
        zero-copy views (a ticket someone still holds) keep their mapping
        alive — the close is best-effort, the unlink unconditional."""
        if unlink is None:
            unlink = self._owner
        self._c = None
        for shm in list(self._data.values()) + [self._ctrl]:
            try:
                shm.close()
            except BufferError:
                pass               # a live view pins the mapping; fine
            if unlink and self._owner:
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass


# ---------------------------------------------------------------------------
# Intake process
# ---------------------------------------------------------------------------

class _Pending:
    """One in-assembly batch inside an intake process: the claimed slab,
    rows written so far, per-row request ids (None rows = drive mode), and
    the window start."""

    def __init__(self, handle: SlabHandle, buf: np.ndarray, t0: float):
        self.handle = handle
        self.buf = buf                 # (bucket, *image_shape) slab view
        self.rows = 0
        self.req_ids: List[Optional[int]] = []
        self.t0 = t0


def _flush(pool: SlabPool, outbox, idx: int, seq, inflight: Dict,
           net: str, p: _Pending) -> None:
    """Pad the pending rows to their pow2 bucket inside the slab (replicate
    the last real row) and emit the batch descriptor."""
    b = pow2_ceil(p.rows)
    if b > p.rows:
        p.buf[p.rows:b] = p.buf[p.rows - 1]
    bid = next(seq)
    inflight[bid] = (net, p.req_ids, time.perf_counter())
    outbox.put(("batch", idx, bid, net, p.handle, p.rows))


def _alloc_blocking(pool: SlabPool, bucket: int) -> Optional[SlabHandle]:
    """Alloc with bounded retry: the ring refills as the server settles
    dispatches, so exhaustion is transient backpressure, not an error —
    until ``ALLOC_WAIT_S``, after which the caller rejects the batch."""
    deadline = time.perf_counter() + ALLOC_WAIT_S
    while True:
        h = pool.alloc(bucket)
        if h is not None or time.perf_counter() > deadline:
            return h
        time.sleep(ALLOC_POLL_S)


def _intake_main(idx: int, pools_arg: Dict, inbox, outbox, reply_q) -> None:
    """Intake process body. Messages on ``inbox``:

    ``("cfg", net, cfg)``            per-net assembly policy (cap, wait_s)
    ``("req", req_id, net, payload)`` one externally-submitted request
    ``("drive", net, n, seed)``      synthesize ``n`` request payloads
    ``("done", bid, payload)``       results of one emitted batch
    ``("stop",)``                    drain nothing, exit now

    Replies on ``reply_q``: ``("reply", idx, req_ids, results, errors,
    degraded)`` per settled batch with external requests, ``("drove", idx,
    net, stats)`` when a drive job resolved, ``("fatal", idx, traceback)``
    when the body raised. No busy-spin: with nothing pending the loop blocks
    on ``inbox.get``; with an open assembly window it blocks until that
    window's deadline.
    """
    pools = {net: SlabPool.attach(spec, lock)
             for net, (spec, lock) in pools_arg.items()}
    cfg: Dict[str, Dict] = {}
    pending: Dict[str, _Pending] = {}
    inflight: Dict[int, Tuple[str, List[Optional[int]], float]] = {}
    seq = itertools.count()
    drives: Dict[str, Dict] = {}       # net -> accounting for a drive job
    templates: Dict[str, np.ndarray] = {}
    stop = False

    def window_deadline() -> Optional[float]:
        if not pending:
            return None
        return min(p.t0 + cfg[n]["wait_s"] for n, p in pending.items())

    def start_pending(net: str) -> Optional[_Pending]:
        c = cfg[net]
        h = _alloc_blocking(pools[net], c["cap"])
        if h is None:
            return None
        return _Pending(h, pools[net].view(h), time.perf_counter())

    def add_row(net: str, payload: Optional[np.ndarray],
                req_id: Optional[int]) -> None:
        p = pending.get(net)
        if p is None:
            p = start_pending(net)
            if p is None:              # pool exhausted beyond patience
                if req_id is not None:
                    reply_q.put(("reply", idx, [req_id], [None],
                                 ["rejected: slab pool exhausted"], [False]))
                elif net in drives:
                    drives[net]["rejected"] += 1
                    drives[net]["resolved"] += 1
                return
            pending[net] = p
        if payload is None:            # drive mode: template row, one write
            p.buf[p.rows] = templates[net]
        else:
            p.buf[p.rows] = payload
        p.req_ids.append(req_id)
        p.rows += 1
        if p.rows >= cfg[net]["cap"]:
            _flush(pools[net], outbox, idx, seq, inflight, net,
                   pending.pop(net))

    def pump_drive() -> bool:
        """Generate at most one batch worth of drive rows; True when any
        drive job still has rows to generate."""
        for net, job in drives.items():
            if job["to_generate"] <= 0:
                continue
            n = min(job["to_generate"], cfg[net]["cap"])
            for _ in range(n):
                add_row(net, None, None)
                job["to_generate"] -= 1
            if net in pending:         # partial tail: let the window run
                if job["to_generate"] <= 0 and pending[net].rows:
                    _flush(pools[net], outbox, idx, seq, inflight, net,
                           pending.pop(net))
            return True
        return any(j["to_generate"] > 0 for j in drives.values())

    def handle_done(bid: int, payload) -> None:
        net, req_ids, t_sub = inflight.pop(bid)
        if payload[0] == "bulk":       # every row served by the primary plan
            rows = payload[1]
            results = [rows[i] for i in range(len(req_ids))]
            errors: List[Optional[str]] = [None] * len(req_ids)
            degraded = [False] * len(req_ids)
        else:
            _, results, errors, degraded = payload
        ext = [i for i, r in enumerate(req_ids) if r is not None]
        if ext:
            reply_q.put(("reply", idx, [req_ids[i] for i in ext],
                         [results[i] for i in ext],
                         [errors[i] for i in ext],
                         [degraded[i] for i in ext]))
        job = drives.get(net)
        if job is not None:
            mine = sum(1 for r in req_ids if r is None)
            if mine:
                lat = time.perf_counter() - t_sub
                for i, r in enumerate(req_ids):
                    if r is not None:
                        continue
                    job["resolved"] += 1
                    if errors[i] is not None:
                        key = ("rejected" if "rejected" in errors[i]
                               else "failed")
                        job[key] += 1
                    elif degraded[i]:
                        job["degraded"] += 1
                        job["served"] += 1
                    else:
                        job["served"] += 1
                job["latency_sum"] += lat * mine
            if job["resolved"] >= job["requests"]:
                job["seconds"] = time.perf_counter() - job["t0"]
                done = dict(job)
                done.pop("t0", None)
                reply_q.put(("drove", idx, net, done))
                del drives[net]

    try:
        while True:
            if stop and not inflight and not pending:
                break
            busy = pump_drive()
            dl = window_deadline()
            if dl is not None:
                timeout = max(dl - time.perf_counter(), 0.0) + 1e-4
            elif busy:
                timeout = 0.0
            elif stop:
                timeout = 0.05         # only waiting on in-flight results
            else:
                timeout = None         # idle: block, no spinning
            try:
                msg = (inbox.get_nowait() if timeout == 0.0
                       else inbox.get(timeout=timeout))
            except pyqueue.Empty:
                msg = None
            if msg is not None:
                kind = msg[0]
                if kind == "cfg":
                    _, net, c = msg
                    cfg[net] = c
                    rng = np.random.default_rng(1000 + idx)
                    templates[net] = rng.standard_normal(
                        c["image_shape"]).astype(np.float32)
                elif kind == "req":
                    _, req_id, net, payload = msg
                    add_row(net, np.asarray(payload, np.float32), req_id)
                elif kind == "drive":
                    _, net, n, seed = msg
                    rng = np.random.default_rng(seed)
                    templates[net] = rng.standard_normal(
                        cfg[net]["image_shape"]).astype(np.float32)
                    drives[net] = {"requests": int(n), "to_generate": int(n),
                                   "resolved": 0, "served": 0, "degraded": 0,
                                   "failed": 0, "rejected": 0,
                                   "latency_sum": 0.0, "seconds": 0.0,
                                   "t0": time.perf_counter()}
                elif kind == "done":
                    handle_done(msg[1], msg[2])
                elif kind == "stop":
                    stop = True
            # expired windows flush even when the inbox stays quiet
            now = time.perf_counter()
            for net in [n for n, p in pending.items()
                        if now - p.t0 >= cfg[n]["wait_s"]]:
                _flush(pools[net], outbox, idx, seq, inflight, net,
                       pending.pop(net))
    except BaseException:
        reply_q.put(("fatal", idx, traceback.format_exc()))
    finally:
        for pool in pools.values():
            pool.close()


# ---------------------------------------------------------------------------
# Parent-side manager
# ---------------------------------------------------------------------------

class ProcessFrontend:
    """N intake processes + a dispatcher thread feeding pre-assembled slab
    batches into an ``OptimisedServer``.

    Two entry points:

    * ``ingest(net, xs)`` — ship request payloads to the intake processes
      (round-robin) and get parent-side tickets back; the assembly, padding
      and result slicing all happen in the children.
    * ``drive(net, requests)`` — synthetic intake: each process generates
      its share of the load locally (modelling network receivers), writes
      payloads straight into slabs, and accounts served/degraded/failed
      until every request resolves. This is the benchmark/soak loadgen.
    """

    def __init__(self, server, procs: int, *, slots: int = 16):
        if procs < 1:
            raise ValueError(f"frontend procs must be >= 1, got {procs}")
        self.server = server
        self.procs = procs
        self.slots = slots
        self._pools: Dict[str, SlabPool] = {}
        self._cfg: Dict[str, Dict] = {}
        self._inboxes = [_CTX.Queue() for _ in range(procs)]
        self._outbox = _CTX.Queue()
        self._reply_q = _CTX.Queue()
        self._children: List = []
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._rr = 0
        self._req_seq = itertools.count()
        self._pending_lock = threading.Lock()
        self._pending: Dict[int, Ticket] = {}
        self._drive_results: Dict[Tuple[int, str], Dict] = {}
        self._drive_event = threading.Condition()
        self.fatal: Optional[str] = None
        self._started = False

    # -- lifecycle ---------------------------------------------------------
    def _net_policies(self) -> Dict[str, Dict]:
        """Snapshot per-logical-net assembly policy from the server: image
        shape, batch cap (max across the route's backends), window."""
        out = {}
        with self.server._cond:
            for net, keys in self.server._routes.items():
                states = [self.server._nets[k] for k in keys
                          if k in self.server._nets]
                if not states:
                    continue
                n0 = states[0].opt.spec.nodes[0]
                out[net] = {
                    "image_shape": (n0.c, n0.im, n0.im),
                    "cap": max(s.queue.batch_cap for s in states),
                    "wait_s": max(s.queue.max_wait_s for s in states),
                }
        return out

    def start(self) -> "ProcessFrontend":
        """Create one slab pool per registered network, page-lock the pools
        on a cuda server, spawn the intake processes and start the parent
        loops. A failed page-lock raises with nothing left running."""
        if self._started:
            return self
        self._cfg = self._net_policies()
        if not self._cfg:
            raise RuntimeError("no networks registered: register() before "
                               "starting the process front end")
        for net, c in self._cfg.items():
            self._pools[net] = SlabPool(c["image_shape"],
                                        max_batch=c["cap"],
                                        slots=self.slots)
        try:
            self.server._pin_slabs(list(self._pools.values()))
        except BaseException:
            self._close_pools()
            raise
        pools_arg = {net: (p.spec(), p.lock)
                     for net, p in self._pools.items()}
        for i in range(self.procs):
            pr = _CTX.Process(target=_intake_main,
                              args=(i, pools_arg, self._inboxes[i],
                                    self._outbox, self._reply_q),
                              daemon=True, name=f"intake-{i}")
            pr.start()
            self._children.append(pr)
            for net, c in self._cfg.items():
                self._inboxes[i].put(("cfg", net, c))
        for fn, name in ((self._dispatch_loop, "frontend-dispatch"),
                         (self._reply_loop, "frontend-reply")):
            t = threading.Thread(target=fn, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        self._started = True
        return self

    def refresh(self) -> None:
        """Re-send assembly policy (caps/windows may have moved with a
        hot_swap or bucket-policy refresh). Nets registered after start
        still need their own pools — register before starting."""
        self._cfg = {n: c for n, c in self._net_policies().items()
                     if n in self._pools}
        for i in range(self.procs):
            for net, c in self._cfg.items():
                self._inboxes[i].put(("cfg", net, c))

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the intake processes and parent loops, then release the
        slabs. ``OptimisedServer.stop`` calls the two halves around stopping
        its workers, so no dispatch still reads a slab when it is unpinned."""
        self.stop_intake(timeout)
        self.close()

    def stop_intake(self, timeout: float = 10.0) -> None:
        """Stop the intake processes and the dispatcher / reply threads; the
        slab pools stay mapped (queued groups may still execute)."""
        if not self._started:
            return
        for q in self._inboxes:
            q.put(("stop",))
        for pr in self._children:
            pr.join(timeout)
            if pr.is_alive():
                pr.terminate()
                pr.join(1.0)
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        for q in self._inboxes + [self._outbox, self._reply_q]:
            q.close()
            q.cancel_join_thread()
        self._started = False

    def close(self) -> None:
        """Unpin (after a device sync) and close the slab pools."""
        try:
            self.server._unpin_slabs()
        finally:
            self._close_pools()

    def _close_pools(self) -> None:
        for pool in self._pools.values():
            pool.close()
        self._pools = {}

    # -- parent-side loops -------------------------------------------------
    def _dispatch_loop(self) -> None:
        server = self.server
        while not self._stop.is_set():
            try:
                msg = self._outbox.get(timeout=PARENT_POLL_S)
            except pyqueue.Empty:
                continue
            _, pi, bid, net, handle, rows = msg
            inbox = self._inboxes[pi]
            pool = self._pools[net]
            try:
                xs = pool.view(handle, pow2_ceil(rows))
            except ValueError as e:
                inbox.put(("done", bid, ("rows", [None] * rows,
                                         [f"slab error: {e}"] * rows,
                                         [False] * rows)))
                continue
            on_done = self._make_on_done(pool, handle, inbox, bid, rows)
            server._submit_group(net, xs, rows, handle=handle,
                                 on_done=on_done)

    def _make_on_done(self, pool: SlabPool, handle: SlabHandle, inbox,
                      bid: int, rows: int) -> Callable:
        def on_done(tickets: List[Ticket],
                    out: Optional[np.ndarray]) -> None:
            # the slab is recycled whatever happens to the reply: a closed
            # pool or inbox (shutdown) must not stop the other half
            try:
                pool.free(handle)
            finally:
                if out is not None and all(t.error is None and not t.degraded
                                           for t in tickets):
                    payload = ("bulk", np.ascontiguousarray(out[:rows]))
                else:
                    payload = ("rows",
                               [t.result for t in tickets],
                               [t.error for t in tickets],
                               [t.degraded for t in tickets])
                inbox.put(("done", bid, payload))
        return on_done

    def _reply_loop(self) -> None:
        while not self._stop.is_set():
            try:
                msg = self._reply_q.get(timeout=PARENT_POLL_S)
            except pyqueue.Empty:
                continue
            if msg[0] == "reply":
                _, _pi, req_ids, results, errors, degraded = msg
                with self._pending_lock:
                    tickets = [self._pending.pop(r, None) for r in req_ids]
                for t, res, err, deg in zip(tickets, results, errors,
                                            degraded):
                    if t is None:
                        continue
                    if err is not None:
                        t.finish(error=err, rejected="rejected" in err)
                    else:
                        t.finish(result=res, degraded=deg)
            elif msg[0] == "drove":
                _, pi, net, stats = msg
                with self._drive_event:
                    self._drive_results[(pi, net)] = stats
                    self._drive_event.notify_all()
            elif msg[0] == "fatal":
                self.fatal = msg[2]
                with self._drive_event:
                    self._drive_event.notify_all()

    # -- request entry -----------------------------------------------------
    def ingest(self, net: str, xs) -> List[Ticket]:
        """Ship request payloads to the intake processes; returns tickets
        finished by the reply loop as batches settle. The payload crosses
        into an intake once (the ingress hop a networked front end would
        pay at its socket) and is written exactly once into a slab."""
        self.start()
        clock = self.server._clock
        tickets = []
        for x in xs:
            x = np.asarray(x, np.float32)
            rid = next(self._req_seq)
            t = Ticket(net=net, x=x, submitted_s=clock(), clock=clock)
            with self._pending_lock:
                self._pending[rid] = t
            self._inboxes[self._rr].put(("req", rid, net, x))
            self._rr = (self._rr + 1) % self.procs
            tickets.append(t)
        return tickets

    def drive(self, net: str, requests: int, *, seed: int = 0,
              timeout: float = 180.0) -> Dict:
        """Synthetic intake: split ``requests`` across the intake processes,
        each generating and submitting its share locally. Blocks until all
        resolve; returns aggregated accounting (requests, served, degraded,
        failed, rejected, img/s)."""
        self.start()
        share = [requests // self.procs] * self.procs
        for i in range(requests % self.procs):
            share[i] += 1
        expect = []
        for i, n in enumerate(share):
            if n <= 0:
                continue
            self._inboxes[i].put(("drive", net, n, seed + i))
            expect.append((i, net))
        deadline = time.perf_counter() + timeout
        with self._drive_event:
            while any(k not in self._drive_results for k in expect):
                if self.fatal is not None:
                    raise RuntimeError(f"intake process died:\n{self.fatal}")
                left = deadline - time.perf_counter()
                if left <= 0:
                    raise TimeoutError(f"drive({net!r}, {requests}) not "
                                       f"resolved within {timeout:.0f}s")
                self._drive_event.wait(min(left, 0.25))
            stats = [self._drive_results.pop(k) for k in expect]
        agg = {k: sum(s[k] for s in stats)
               for k in ("requests", "served", "degraded", "failed",
                         "rejected", "latency_sum")}
        agg["seconds"] = max(s["seconds"] for s in stats)
        agg["images_per_s"] = (agg["served"] / agg["seconds"]
                               if agg["seconds"] > 0 else 0.0)
        agg["latency_mean_ms"] = (agg["latency_sum"] / agg["requests"] * 1e3
                                  if agg["requests"] else 0.0)
        agg.pop("latency_sum")
        return agg
