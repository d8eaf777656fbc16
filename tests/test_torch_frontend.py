"""The port's process front end against the reference on the CPU.

* ``SlabPool``: the reference's and the port's pools driven side by side by
  one sequence of allocs, frees and views (equal handles, counts and
  bytes; either attaches to the other's segments), the generation guards,
  concurrent producers, and the alloc/free invariant under hypothesis.
* Slab groups through the serving core in pump mode, both servers on the
  same weights: ``_submit_group`` at one bucket byte-identical to the copy
  path (the only exact check), group rejection, per-ticket degradation
  under injected faults, coexistence with loose tickets in FIFO order —
  decisions equal, results within the fp32 tolerance of
  ``tests/test_kernels.py`` (1e-4).
* ``ProcessFrontend`` end to end with spawned intake processes: each ingest
  ticket against ``server.serve`` of the same inputs (1e-5; the intake may
  split a burst into smaller pow2 buckets, and the reference's own byte
  check across buckets is a known failure of the reference), against the
  reference's front end on the same inputs (1e-4), ``drive`` accounting,
  the chaos soak through the slab path, the serving CLI.
* The intake processes stay off torch: a spawned child that imports the
  front end has no ``torch`` in ``sys.modules``.
* Page-locking on a cuda server: every slab segment registered once, a
  failed register raises with nothing left running, unregistering after a
  device sync (driven through a stand-in for ``torch.cuda.cudart``).

Every wait has a timeout; no verdict depends on a wall-clock race.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import multiprocessing as mp
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from hypothesis_stub import given, settings, st

from repro.models import cnn_zoo as JZ
from repro.primitives import executor as JE
from repro.primitives.plan import heuristic_assignment as j_heuristic
from repro.service import Fault as JFault
from repro.service import FaultInjector as JInjector
from repro.service import OptimisedNetwork as JNet
from repro.service import OptimisedServer as JServer
from repro.service.serving import frontend as JF
from repro_torch.kernels.common import KernelError
from repro_torch.models import cnn_zoo as TZ
from repro_torch.primitives.plan import heuristic_assignment as t_heuristic
from repro_torch.service import Fault, FaultInjector
from repro_torch.service import OptimisedNetwork as TNet
from repro_torch.service import OptimisedServer as TServer
from repro_torch.service.serving import frontend as TF
from repro_torch.service.serving.server import main as t_main

ROOT = Path(__file__).resolve().parents[1]
RESULT_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels.py::_TOL fp32
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)      # one package, other pow2 buckets
IMAGE = (3, 32, 32)


def _weights():
    return {k: np.asarray(v) for k, v in JE.make_weights(JZ.get("edge_cnn")).items()}


def _net(pkg, *, predicted=2e-3):
    if pkg == "j":
        spec = JZ.get("edge_cnn")
        return JNet.from_assignment(spec, j_heuristic(spec),
                                    predicted_cost_s=predicted)
    spec = TZ.get("edge_cnn")
    return TNet.from_assignment(spec, t_heuristic(spec),
                                predicted_cost_s=predicted)


def _server(pkg, weights, *, predicted=2e-3, backends=(None,), **kw):
    server = (JServer(**kw) if pkg == "j" else TServer(device="cpu", **kw))
    for b in backends:
        server.register(_net(pkg, predicted=predicted), backend=b,
                        weights=weights)
    return server


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + IMAGE).astype(np.float32)


# ---------------------------------------------------------------------------
# Slab pool: the reference's and the port's side by side
# ---------------------------------------------------------------------------

def _pools(image_shape, **kw):
    return JF.SlabPool(image_shape, **kw), TF.SlabPool(image_shape, **kw)


def _close(*pools):
    for p in pools:
        p.close()


def test_slab_pool_alloc_free_roundtrip():
    pools = _pools((3, 4, 4), max_batch=8, slots=3)
    try:
        for pool in pools:
            assert pool.buckets == [1, 2, 4, 8]
            h = pool.alloc(5)                      # rounds up the pow2 ladder
            assert h.bucket == 8
            v = pool.view(h)
            assert v.shape == (8, 3, 4, 4) and v.dtype == np.float32
            v[:] = 2.5
            assert (pool.view(h, rows=3) == 2.5).all()
            assert pool.available(8) == 2
            pool.free(h)
            assert pool.available(8) == 3
            assert pool.available(1) == 3 and pool.available(4) == 3
        assert pools[0].spec().keys() == pools[1].spec().keys()
        assert [len(pools[0]._data[b].buf) for b in pools[0].buckets] == \
            [n for _, n in pools[1].segments()]
    finally:
        _close(*pools)


def test_slab_pool_exhaustion_backpressure_and_refill():
    pools = _pools((2, 2, 2), max_batch=4, slots=2)
    try:
        got = []
        for pool in pools:
            a, b = pool.alloc(4), pool.alloc(4)
            assert a is not None and b is not None and a.slot != b.slot
            assert pool.alloc(4) is None           # ring empty: backpressure
            pool.free(a)
            c = pool.alloc(4)                      # refilled by the free
            assert c is not None and c.generation == a.generation + 1
            pool.free(b)
            pool.free(c)
            assert pool.available(4) == 2
            got.append([(h.bucket, h.slot, h.generation) for h in (a, b, c)])
        assert got[0] == got[1]
    finally:
        _close(*pools)


def test_slab_pool_generation_guards_double_free_and_stale_view():
    pools = _pools((2, 2, 2), max_batch=2, slots=2)
    try:
        for pool in pools:
            h = pool.alloc(2)
            pool.view(h)[:] = 1.0
            pool.free(h)
            with pytest.raises(ValueError):        # double free
                pool.free(h)
            with pytest.raises(ValueError):        # use-after-free
                pool.view(h)
            both = [pool.alloc(2), pool.alloc(2)]   # FIFO ring: drain it whole
            h2 = next(x for x in both if x.slot == h.slot)
            assert h2.generation > h.generation
            with pytest.raises(ValueError):
                pool.view(h)
            for x in both:
                pool.free(x)
    finally:
        _close(*pools)


def test_slab_pool_no_aliasing_across_generations():
    """Payloads written through one generation never leak into another, in
    either pool, and both pools hand out the same slots in the same order."""
    pools = _pools((1, 2, 2), max_batch=2, slots=4)
    try:
        order = []
        for pool in pools:
            live, seen = {}, []
            for round_ in range(3):
                handles = [pool.alloc(2) for _ in range(4)]
                assert all(h is not None for h in handles)
                assert len({h.slot for h in handles}) == 4
                for i, h in enumerate(handles):
                    pool.view(h)[:] = round_ * 10.0 + i
                    live[(h.slot, h.generation)] = round_ * 10.0 + i
                for h in handles:
                    assert (pool.view(h) == live[(h.slot, h.generation)]).all()
                    pool.free(h)
                seen.append([(h.slot, h.generation) for h in handles])
            order.append(seen)
        assert order[0] == order[1]
    finally:
        _close(*pools)


def test_slab_pool_concurrent_producers():
    """N producer threads alloc/write/verify/free in a loop against the
    port's pool: no slab is ever handed to two producers at once, and the
    ring is whole afterwards."""
    pool = TF.SlabPool((2, 3, 3), max_batch=4, slots=4)
    errors = []

    def producer(tid):
        rng = np.random.default_rng(tid)
        try:
            for it in range(120):
                bucket = int(rng.choice([1, 2, 4]))
                h = pool.alloc(bucket)
                if h is None:
                    continue                   # transient exhaustion: fine
                tag = tid * 1000.0 + it
                v = pool.view(h)
                v[:] = tag
                if not (pool.view(h) == tag).all():
                    errors.append(f"aliased slab {h} (producer {tid})")
                pool.free(h)
        except Exception as e:                 # pragma: no cover
            errors.append(f"producer {tid}: {e!r}")

    threads = [threading.Thread(target=producer, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        for b in (1, 2, 4):
            assert pool.available(b) == 4      # every slab returned
    finally:
        pool.close()


def test_slab_pool_attach_shares_bytes_and_never_unlinks():
    """The port attaches to its own pool and to the reference's: the same
    segments, the same ring, and the attaching side never unlinks."""
    pools = _pools((2, 2, 2), max_batch=2, slots=2)
    try:
        for owner in pools:
            other = TF.SlabPool.attach(owner.spec(), owner.lock)
            h = other.alloc(2)
            other.view(h)[:] = 9.0
            assert (owner.view(h) == 9.0).all()   # same physical memory
            owner.free(h)                         # either side may free
            assert other.available(2) == 2
            other.close()                         # non-owner: unmap only
            h2 = owner.alloc(2)                   # owner's segments live on
            owner.view(h2)[:] = 1.0
            owner.free(h2)
    finally:
        _close(*pools)


@given(st.lists(st.integers(min_value=0, max_value=5), min_size=1,
                max_size=60))
@settings(max_examples=40, deadline=None)
def test_slab_pool_random_alloc_free_invariants(ops):
    """Property, both pools on one op sequence: live handles are unique per
    (bucket, slot), ``available()`` counts exactly the free slabs, a freed
    handle is dead, and the two pools answer alike."""
    pools = _pools((1, 2, 2), max_batch=4, slots=3)
    live = [[], []]
    try:
        for op in ops:
            if op < 3:                         # alloc from ladder rung `op`
                bucket = 1 << op
                hs = [p.alloc(bucket) for p in pools]
                assert (hs[0] is None) == (hs[1] is None)
                if hs[1] is None:
                    assert pools[1].available(bucket) == 0
                    continue
                assert (hs[0].slot, hs[0].generation) == \
                    (hs[1].slot, hs[1].generation)
                assert all(not (hs[1].bucket == o.bucket and hs[1].slot == o.slot)
                           for o in live[1]), "slab handed out twice"
                for mine, h in zip(live, hs):
                    mine.append(h)
            elif live[1]:                      # free the oldest live handle
                for pool, mine in zip(pools, live):
                    h = mine.pop(0)
                    pool.free(h)
                    with pytest.raises(ValueError):
                        pool.view(h)
        for b in pools[1].buckets:
            used = sum(1 for h in live[1] if h.bucket == b)
            assert pools[1].available(b) == pools[0].available(b) == 3 - used
    finally:
        _close(*pools)


# ---------------------------------------------------------------------------
# Group dispatch through the serving core (pump mode, no processes)
# ---------------------------------------------------------------------------

def test_group_bytes_identical_zero_copy_vs_copy():
    """The same payload served through the zero-copy slab path and through
    the per-ticket copy path at one bucket: byte-identical in the port, and
    within 1e-4 of the reference's slab path."""
    weights = _weights()
    xs = _requests(3, seed=7)
    got = {}
    for pkg in ("j", "t"):
        server = _server(pkg, weights, max_batch=8, latency_budget_ms=50.0)
        pool = (JF if pkg == "j" else TF).SlabPool(IMAGE, max_batch=8, slots=2)
        try:
            h = pool.alloc(4)
            buf = pool.view(h)
            buf[:3] = xs
            buf[3] = xs[2]                     # pow2 pad: replicate last row
            freed = []
            g = server._submit_group("edge_cnn", pool.view(h), 3, handle=h,
                                     on_done=lambda ts, out:
                                     (pool.free(h), freed.append(out)))
            assert server.pump() == 1
            assert all(t.done and t.error is None for t in g.tickets)
            assert all(t.slab == h and t.row == i
                       for i, t in enumerate(g.tickets))
            assert freed and freed[0] is not None and freed[0].shape[0] == 4
            assert pool.available(4) == 2      # slab recycled by on_done
            ref = server.serve("edge_cnn", xs)  # copy path: same bucket 4
            for i, t in enumerate(g.tickets):
                if pkg == "t":
                    np.testing.assert_array_equal(t.result, ref[i])
                    np.testing.assert_array_equal(freed[0][i], ref[i])
            got[pkg] = np.stack([t.result for t in g.tickets])
        finally:
            pool.close()
            server.stop()
    np.testing.assert_allclose(got["t"], got["j"], **RESULT_TOL)


def test_group_rejection_fires_on_done_and_finishes_tickets():
    weights = _weights()
    xs = _requests(4)
    for pkg in ("j", "t"):
        server = _server(pkg, weights, max_batch=4, queue_depth=2)
        fired = []
        # over depth: the whole group is rejected, on_done still fires
        g = server._submit_group("edge_cnn", xs, 4,
                                 on_done=lambda ts, out: fired.append(out))
        assert all(t.done and t.rejected for t in g.tickets)
        assert fired == [None]
        assert server.stats("edge_cnn")["rejected"] == 4
        # unknown net: same contract
        g2 = server._submit_group("nope", xs, 2,
                                  on_done=lambda ts, out: fired.append(out))
        assert all(t.done and t.rejected for t in g2.tickets)
        assert fired == [None, None]
        # a queued group drained by a re-register: rejected, on_done fires
        g3 = server._submit_group("edge_cnn", xs, 2,
                                  on_done=lambda ts, out: fired.append(out))
        server.register(_net(pkg), weights=weights)
        assert all(t.done and t.rejected and "re-registered" in t.error
                   for t in g3.tickets)
        assert fired == [None, None, None]
        server.stop()


def test_group_dispatch_degrades_per_ticket_under_faults():
    """A slab dispatch hit by injected faults degrades to the safe plan per
    ticket in both packages, and on_done reports per-row results."""
    weights = _weights()
    xs = _requests(2, seed=3)
    results, stats = {}, {}
    for pkg, fault, inj in (("j", JFault, JInjector), ("t", Fault, FaultInjector)):
        server = _server(pkg, weights, max_batch=4,
                         faults=inj([fault("raise", net="edge_cnn", first=0,
                                           last=2)]))
        outs = []
        g = server._submit_group("edge_cnn", xs, 2,
                                 on_done=lambda ts, out: outs.append(out))
        assert server.pump() == 1
        assert outs == [None]                  # primary failed: per-row path
        assert all(t.done and t.degraded and t.result is not None
                   for t in g.tickets)
        s = server.stats("edge_cnn")
        assert s["images"] + s["fallback_images"] == 2
        results[pkg] = np.stack([t.result for t in g.tickets])
        stats[pkg] = {k: s[k] for k in ("fallback_images", "failed_tickets",
                                        "images", "retries",
                                        "failed_dispatches", "failures")}
        server.stop()
    assert stats["t"] == stats["j"]
    assert stats["t"]["fallback_images"] == 2 and stats["t"]["failed_tickets"] == 0
    np.testing.assert_allclose(results["t"], results["j"], **RESULT_TOL)


def test_group_and_loose_tickets_coexist_fifo():
    """Loose submits and slab groups share one queue; a pending group
    dispatches whole and first (its window already ran in the intake), in
    both packages."""
    weights = _weights()
    xs = _requests(3)
    order = {}
    for pkg in ("j", "t"):
        server = _server(pkg, weights, max_batch=4, latency_budget_ms=50.0)
        shapes = []
        real = server._run_plan

        def spy(opt, batch, w, real=real, shapes=shapes):
            shapes.append(batch.shape[0])
            return real(opt, batch, w)
        server._run_plan = spy
        t_loose = server.submit("edge_cnn", xs[0])
        g = server._submit_group("edge_cnn", xs[1:3], 2)
        assert len(server._nets["edge_cnn"].queue) == 3
        assert server.pump() == 2              # the group whole + the loose
        assert t_loose.done and t_loose.error is None
        assert all(t.done and t.error is None for t in g.tickets)
        order[pkg] = shapes
        server.stop()
    assert order["t"] == order["j"] == [2, 1]


def test_group_kernel_error_fails_tickets_and_recycles_the_slab(monkeypatch):
    """The port's rule holds for slab batches: a kernel that fails to
    launch fails the group's tickets (never degraded), and ``on_done``
    still fires so the slab goes back to the ring."""
    server = _server("t", _weights(), max_batch=4)
    pool = TF.SlabPool(IMAGE, max_batch=4, slots=1)

    def broken(*a, **k):
        raise KernelError("matmul: kernel launch failed with cudaError 98")
    monkeypatch.setattr(server, "_run_plan", broken)
    try:
        h = pool.alloc(2)
        pool.view(h)[:] = _requests(2)
        outs = []
        g = server._submit_group("edge_cnn", pool.view(h), 2, handle=h,
                                 on_done=lambda ts, out:
                                 (pool.free(h), outs.append(out)))
        assert server.pump() == 1
        assert outs == [None] and pool.available(2) == 1
        assert all(t.error is not None and "cudaError 98" in t.error
                   and not t.degraded and t.result is None for t in g.tickets)
        st = server.stats("edge_cnn")
        assert st["failures"] == {"kernel": 1} and st["fallback_images"] == 0
        assert st["failed_tickets"] == 2
    finally:
        pool.close()
        server.stop()


# ---------------------------------------------------------------------------
# ProcessFrontend end to end (spawned processes + worker pool)
# ---------------------------------------------------------------------------

def _ingest_and_drive(pkg, weights, xs):
    server = _server(pkg, weights, max_batch=8, latency_budget_ms=50.0,
                     workers=2, max_wait_ms=2.0, frontend_procs=2)
    server.serve("edge_cnn", xs)               # warm the bucket-4 plan
    fe = server.frontend()
    try:
        tickets = fe.ingest("edge_cnn", xs)
        for t in tickets:
            assert t.wait(120.0), "ingest ticket never finished"
            assert t.error is None, t.error
        ref = server.serve("edge_cnn", xs)
        agg = fe.drive("edge_cnn", 24, seed=5)
        assert fe.fatal is None
    finally:
        server.stop()
    assert fe._children and all(not p.is_alive() for p in fe._children)
    return [t.result for t in tickets], ref, agg


def test_process_frontend_ingest_and_drive():
    """Intake processes assemble slab batches, the dispatcher hands them to
    the worker pool by reference, results ship back per batch. Each ingest
    result equals ``serve`` of the same inputs (1e-5) and the reference's
    front end (1e-4); ``drive`` accounting loses nothing."""
    weights = _weights()
    xs = _requests(4, seed=11)
    port, serve, agg = _ingest_and_drive("t", weights, xs)
    for got, want in zip(port, serve):
        np.testing.assert_allclose(got, want, **SERVE_TOL)
    ref, _, ref_agg = _ingest_and_drive("j", weights, xs)
    np.testing.assert_allclose(np.stack(port), np.stack(ref), **RESULT_TOL)
    for a in (agg, ref_agg):
        assert a["requests"] == 24
        assert a["served"] + a["failed"] + a["rejected"] == 24, a
        assert a["served"] == 24 and a["degraded"] == 0
    assert {k: agg[k] for k in ("requests", "served", "degraded", "failed",
                                "rejected")} == \
        {k: ref_agg[k] for k in ("requests", "served", "degraded", "failed",
                                 "rejected")}


@pytest.mark.parametrize("case", ["frontend_procs", "frontend"])
def test_frontend_requires_worker_pool(case):
    with pytest.raises(ValueError):
        if case == "frontend_procs":
            TServer(workers=0, frontend_procs=2, device="cpu")
        else:
            server = _server("t", _weights(), workers=0)
            try:
                server.frontend(2)
            finally:
                server.stop()


def test_slab_group_chaos_soak():
    """The fault-tolerance gates hold on the shm path: slab groups routed
    across two backends while one raises — zero lost tickets, zero
    duplicates (accounting identity), every slab recycled, degraded rows
    reported row by row."""
    inj = FaultInjector([Fault("raise", net="edge_cnn#a", first=1, last=3)])
    server = _server("t", _weights(), backends=("a",), predicted=1e-6,
                     max_batch=4, workers=2, max_wait_ms=1.0, faults=inj,
                     breaker_failures=3)
    server.register(_net("t", predicted=1e-3), backend="b", weights=_weights())
    pool = TF.SlabPool(IMAGE, max_batch=4, slots=8)
    groups, outs, done = [], {}, threading.Event()
    outstanding = [0]
    lock = threading.Lock()

    def make_done(i, h):
        def on_done(tickets, out):
            pool.free(h)
            with lock:
                outs[i] = out
                outstanding[0] -= 1
                if outstanding[0] == 0:
                    done.set()
        return on_done

    try:
        rng = np.random.default_rng(0)
        for i in range(12):
            rows = int(rng.integers(1, 5))
            deadline = time.perf_counter() + 60.0
            while (h := pool.alloc(4)) is None:    # backpressure: frees
                assert time.perf_counter() < deadline  # refill the ring
                time.sleep(0.001)
            buf = pool.view(h)
            buf[:rows] = _requests(rows, seed=i)
            buf[rows:] = buf[rows - 1]
            with lock:
                outstanding[0] += 1
            groups.append(server._submit_group("edge_cnn", pool.view(h), rows,
                                               handle=h,
                                               on_done=make_done(i, h)))
        assert done.wait(120.0), "groups never settled"
        tickets = [t for g in groups for t in g.tickets]
        assert all(t.done for t in tickets), "lost tickets"
        served = [t for t in tickets if t.error is None]
        assert not any(t.rejected for t in tickets)
        assert len(served) == len(tickets)
        sa, sb = (server.stats(f"edge_cnn#{b}") for b in ("a", "b"))
        assert (sa["images"] + sa["fallback_images"] + sb["images"]
                + sb["fallback_images"]) == len(served)
        assert sa["failed_dispatches"] >= 1          # faults really fired
        assert sa["fallback_images"] >= 1            # rescued, not dropped
        assert pool.available(4) == 8                # every slab recycled
        for i, g in enumerate(groups):
            if any(t.degraded for t in g.tickets):
                assert outs[i] is None               # row by row
            else:
                np.testing.assert_array_equal(
                    outs[i][:len(g.tickets)], np.stack([t.result for t in g.tickets]))
    finally:
        server.stop()
        pool.close()


# ---------------------------------------------------------------------------
# Intake processes load no torch; page-locking; the CLI
# ---------------------------------------------------------------------------

_CHILD = """
import pickle, sys
import repro_torch.service.serving.frontend as fe
pickle.loads(pickle.dumps(fe._intake_main))
pickle.loads(pickle.dumps(fe.SlabHandle(1, 0, 0)))
q.put(sorted(m for m in ("torch", "jax", "repro") if m in sys.modules))
"""


def test_intake_child_loads_no_torch():
    """A spawned child (the intake processes' start method) that imports
    the front end module and unpickles what an intake receives has neither
    torch, jax nor the reference loaded."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    child = ctx.Process(target=exec, args=(_CHILD, {"q": q}))
    child.start()
    try:
        loaded = q.get(timeout=60.0)
    finally:
        child.join(60.0)
    assert not child.is_alive() and child.exitcode == 0
    assert loaded == []


class _FakeCudart:
    """Stand-in for ``torch.cuda.cudart()``: records (un)registrations and
    fails the ``fail_at``-th registration."""

    def __init__(self, fail_at=None):
        self.fail_at = fail_at
        self.registered, self.unregistered = [], []

    def cudaHostRegister(self, addr, nbytes, flags):
        if len(self.registered) == self.fail_at:
            return 2                           # cudaErrorMemoryAllocation
        self.registered.append((addr, nbytes, flags))
        return 0

    def cudaHostUnregister(self, addr):
        self.unregistered.append(addr)
        return 0


def test_slabs_page_locked_once_and_unpinned_after_a_sync(monkeypatch):
    fake = _FakeCudart()
    syncs = []
    monkeypatch.setattr(torch.cuda, "cudart", lambda: fake)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(len(fake.unregistered)))
    server = _server("t", _weights(), max_batch=4)
    pool = TF.SlabPool(IMAGE, max_batch=4, slots=2)
    try:
        server._pin_slabs([pool])              # a CPU server pins nothing
        assert fake.registered == [] and server._pinned == []
        server.device = torch.device("cuda")
        server._pin_slabs([pool])
        assert [(a, n) for a, n, _ in fake.registered] == pool.segments()
        assert {f for *_, f in fake.registered} == {0}
        h = pool.alloc(2)
        assert server._is_pinned(pool.view(h))
        assert not server._is_pinned(_requests(2))
        server._unpin_slabs()
        assert syncs == [0]                    # synchronised before any
        assert fake.unregistered == [a for a, _ in pool.segments()]
        assert server._pinned == [] and not server._is_pinned(pool.view(h))
    finally:
        server.device = torch.device("cpu")
        pool.close()
        server.stop()


def test_failed_page_lock_raises_and_leaves_nothing_running(monkeypatch):
    fake = _FakeCudart(fail_at=2)
    monkeypatch.setattr(torch.cuda, "cudart", lambda: fake)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    server = _server("t", _weights(), max_batch=4)
    server.device = torch.device("cuda")
    fe = TF.ProcessFrontend(server, 1)
    try:
        with pytest.raises(RuntimeError, match="cudaHostRegister"):
            fe.start()
        assert fake.unregistered == [a for a, _, _ in fake.registered]
        assert len(fake.registered) == 2 and server._pinned == []
        assert not fe._children and not fe._threads and not fe._pools
    finally:
        server.device = torch.device("cpu")
        server.stop()


def test_cli_serves_through_the_process_front_end(tmp_path, capsys):
    for part in ("models", "selections"):
        shutil.copytree(ROOT / "artifacts" / part, tmp_path / part)
    assert t_main(["--device", "cpu", "--workers", "2", "--frontend-procs",
                   "2", "--net", "edge_cnn", "--platform", "arm",
                   "--requests", "16", "--store", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines() if "[serve] frontend:" in l)
    assert "2 intake procs, 16 requests -> 16 served" in line
    assert "0 failed, 0 rejected" in line
