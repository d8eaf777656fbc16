"""Fleet-scale calibration sharing in the port against the reference: the
reference's deterministic multi-host soak
(``tests/test_fleet_calibration.py``), run once in each package on the CPU.

Three simulated hosts on one fake clock share one faulty object-store
bucket. Host A serves, drifts 4x, recalibrates from its own served evidence
and publishes it to the pool through a torn first upload; host B
warm-starts from A's selection, serves, then pool-polls and hot-swaps from
A's evidence profiling nothing; host C never serves and recalibrates from
fleet evidence alone, profiling nothing; host D crashes between staged
upload and manifest commit and ``sweep`` collects the orphan. This drives
the port's ``publish_drift`` and ``pooled_drift`` through
``make_recalibrator(pool=True)`` and ``poll_pool``.

Both packages start from the committed arm models, copied into each
package's bucket, so their decisions can be held to each other: the
generations every host went through, each host's recalibration sample
(served, fresh and pooled rows), the assignment each host serves after
its recalibration, the profiling calls, the pool's entries and what
``sweep`` leaves. (The reference's own test trains a 16-triplet model
cold; the two packages' cold inits differ, so the shared start is the
committed 60-triplet pair.) Served results agree within 1e-4.

Plan execution advances the shared fake clock, so drift detection,
windows and store mtimes are deterministic; the only real waiting is for
the background recalibration threads, each bounded by a timeout.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import repro.service as J
from repro.service.platforms import SimulatedPlatform as JPlatform
import repro_torch.service as T
from repro_torch.service.platforms import SimulatedPlatform as TPlatform

ROOT = Path(__file__).resolve().parents[1]
RESULT_TOL = dict(rtol=1e-4, atol=1e-4)
WARM = dict(max_triplets=60, max_iters=2000)   # the committed arm pair


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


def _package(pkg):
    """The names the soak uses, with the port's explicit CPU device."""
    if pkg == "j":
        return SimpleNamespace(mod=J, Platform=JPlatform, dev={})
    return SimpleNamespace(mod=T, Platform=TPlatform, dev={"device": "cpu"})


def _fleet_server(P, fake_clock, base_cost_s, **kw):
    class FleetServer(P.mod.OptimisedServer):
        """Real plan execution; dispatch timing is the shared fake clock
        advanced by the host's per-image cost x the platform's
        ``time_scale``."""

        def _run_plan(self, opt, xs, weights):
            out = super()._run_plan(opt, xs, weights)
            scale = getattr(opt.platform, "time_scale", 1.0) or 1.0
            fake_clock.advance(base_cost_s * xs.shape[0] * scale)
            return out
    return FleetServer(clock=fake_clock, **P.dev, **kw)


def _requests(spec, n, seed=0):
    n0 = spec.nodes[0]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n0.c, n0.im, n0.im)).astype(np.float32)


def _pump_batch(server, net, xs, tickets):
    batch = [server.submit(net, x) for x in xs]
    tickets.extend(batch)
    server.pump()
    return batch


def _wait_recal(server, timeout_s=120.0):
    deadline = time.time() + timeout_s
    while not server.recalibrations_idle() and time.time() < deadline:
        time.sleep(0.01)
    assert server.recalibrations_idle(), "recalibration thread hung"


def _count_profiles(platform):
    calls = []
    orig = platform.profile
    platform.profile = lambda cfgs: (calls.append(
        len(np.atleast_2d(np.asarray(cfgs)))), orig(cfgs))[1]
    return calls


def _sample(st):
    s = st["recal_sample"] or {}
    return {k: s.get(k) for k in ("served_rows", "fresh_rows",
                                  "pooled_sources")}


def _run_fleet(pkg):
    """The reference's soak in package ``pkg``; returns its decisions."""
    P = _package(pkg)
    M = P.mod
    clock = FakeClock()
    shared = M.ObjectStoreBackend(clock=clock)
    for path in sorted((ROOT / "artifacts" / "models").rglob("*")):
        if path.is_file():
            key = path.relative_to(ROOT / "artifacts").as_posix()
            shared.put(key, path.read_bytes())

    def store(faults=None):
        return M.ArtifactStore(backend=shared.share(faults=faults),
                               clock=clock, **P.dev)

    storeA, storeB, storeC = store(), store(), store()
    faultsA = M.ScriptedFaults([(("put", "stage."), "torn")])
    storeA_pub = store(faultsA)
    platforms = [P.Platform("arm", max_triplets=WARM["max_triplets"])
                 for _ in range(3)]
    platformA, platformB, platformC = platforms
    fp = platformA.pool_fingerprint()
    assert platformB.fingerprint() == fp == platformC.fingerprint()

    # -- warm start across the shared backend ------------------------------
    opts = [M.optimise("edge_cnn", p, store=s, executable=True,
                       max_iters=WARM["max_iters"], **P.dev)
            for p, s in zip(platforms, (storeA, storeB, storeC))]
    optA, optB, optC = opts
    assert optA.warm_models and not optA.warm_selection
    for warm in (optB, optC):
        assert warm.warm_models and warm.warm_selection and warm.warm
        assert warm.assignment == optA.assignment
        assert warm.predicted_cost_s == optA.predicted_cost_s

    prof = M.layer_profile(optA)
    n_cfg = len({tuple(map(int, r)) for r in prof.feats})
    assert n_cfg > 0

    def mk_server(opt, store, host):
        return _fleet_server(
            P, clock, opt.predicted_cost_s,
            max_batch=4, latency_budget_ms=1e9,
            drift_threshold=1.5, drift_alpha=0.5, drift_calib_obs=2,
            recalibrate=M.make_recalibrator(store=store, sample_n=n_cfg,
                                            mode="factor", pool=True,
                                            host=host, **P.dev))

    servers = {"A": mk_server(optA, storeA_pub, "A"),
               "B": mk_server(optB, storeB, "B"),
               "C": mk_server(optC, storeC, "C")}
    for srv, opt in zip(servers.values(), opts):
        srv.register(opt)
    serverA, serverB, serverC = servers.values()
    net = optA.net
    tickets = {"A": [], "B": [], "C": []}
    generations, out = [], {"n_cfg": n_cfg, "assignment0": optA.assignment}

    try:
        # -- healthy phase: A and B serve (compile + clean); C stays idle --
        for i in range(5):
            _pump_batch(serverA, net, _requests(optA.spec, 4, seed=i),
                        tickets["A"])
            _pump_batch(serverB, net, _requests(optB.spec, 4, seed=i),
                        tickets["B"])
            generations.append(serverA.stats(net)["generation"])
        assert serverA.stats(net)["observed_dispatches"] >= 2
        assert serverA.stats(net)["recalibrations"] == 0

        # -- host A drifts 4x and self-recalibrates from served evidence --
        platformA.time_scale = 4.0
        platformA.invalidate_datasets()
        for i in range(10):
            _pump_batch(serverA, net, _requests(optA.spec, 4, seed=10 + i),
                        tickets["A"])
            generations.append(serverA.stats(net)["generation"])
            _wait_recal(serverA)
            if serverA.stats(net)["recalibrations"]:
                break
        out["bursts_to_trigger"] = i + 1
        stA = serverA.stats(net)
        assert stA["recalibrations"] == 1 and stA["generation"] == 1
        assert stA["last_recal_error"] is None
        assert stA["recal_sample"]["fresh_rows"] == 0     # served covered all
        assert faultsA.pending == 0
        assert [f[2] for f in faultsA.fired] == ["torn"]
        assert [m["fields"]["host"] for m in storeB.drift_entries(fp)] == ["A"]

        # -- host D crashes between staged upload and manifest commit ------
        dsB = serverB.served_sample(net)
        assert dsB is not None
        storeD = store(M.ScriptedFaults([(("put", "manifest.json"), "raise")]))
        with pytest.raises(M.BackendError):
            storeD.put_dataset({"artifact": "drift_pool", "platform": fp,
                                "host": "D", "seq": 0,
                                "data": dsB.fingerprint()},
                               dsB, category="drift_pool")
        assert {m["fields"]["host"] for m in storeB.drift_entries(fp)} == {"A"}

        # -- host B pool-polls: hot-swap from A's evidence, zero profiling --
        callsB = _count_profiles(platformB)
        assert serverB.poll_pool(storeB, host="B") == 1
        _wait_recal(serverB)
        stB = serverB.stats(net)
        assert stB["recalibrations"] == 1 and stB["generation"] == 1
        assert stB["last_recal_error"] is None
        assert stB["recal_sample"]["fresh_rows"] == 0
        assert stB["recal_sample"]["pooled_sources"] == 1
        assert stB["recal_sample"]["served_rows"] > 0
        assert callsB == [], "pool recalibration profiled fresh configs"
        assert {m["fields"]["host"]
                for m in storeC.drift_entries(fp)} == {"A", "B"}

        # -- host C never served: fleet evidence alone, zero profiling -----
        callsC = _count_profiles(platformC)
        assert serverC.served_sample(net) is None
        assert serverC.poll_pool(storeC, host="C") == 1
        _wait_recal(serverC)
        stC = serverC.stats(net)
        assert stC["recalibrations"] == 1 and stC["generation"] == 1
        assert stC["last_recal_error"] is None
        assert stC["recal_sample"]["fresh_rows"] == 0
        assert stC["recal_sample"]["pooled_sources"] == 2
        assert callsC == [], "evidence-only recalibration profiled configs"

        # -- a second poll with nothing new schedules nothing --------------
        assert serverB.poll_pool(storeB, host="B") == 0
        assert serverC.poll_pool(storeC, host="C") == 0

        # -- post-swap traffic observes the new generation everywhere ------
        for key, srv in servers.items():
            for i in (0, 1):
                _pump_batch(srv, net, _requests(optA.spec, 4, seed=30 + i),
                            tickets[key])
            assert srv.stats(net)["generation"] == 1
        generations.append(serverA.stats(net)["generation"])
        for key, srv in servers.items():
            st = srv.stats(net)
            with srv._cond:
                swapped = srv._nets[net].opt
            out[key] = {"sample": _sample(st), "generation": st["generation"],
                        "recalibrations": st["recalibrations"],
                        "assignment": swapped.assignment,
                        "images": st["images"]}
        out["profiled"] = (callsB, callsC)
    finally:
        for srv in servers.values():
            srv.stop(timeout=60.0)
        platformA.time_scale = 1.0

    # -- zero lost, zero duplicated tickets on every host ------------------
    for key, srv in servers.items():
        ts = tickets[key]
        assert ts and all(t.wait(30.0) for t in ts)
        assert all(t.done and not t.rejected and t.error is None
                   and t.result is not None for t in ts)
        assert srv.stats(net)["images"] == len(ts)
    assert generations == sorted(generations)
    out["generations"] = generations
    out["results"] = {k: np.stack([t.result for t in ts])
                      for k, ts in tickets.items()}

    # -- sweep collects D's orphan; committed entries stay intact ----------
    def entries():
        by_entry = {}
        for k in shared.list("drift_pool/"):
            if not k.endswith("/"):
                by_entry.setdefault(k.rsplit("/", 1)[0], []).append(k)
        return by_entry
    orphans = [e for e, ks in entries().items()
               if not any(k.endswith("manifest.json") for k in ks)]
    assert len(orphans) == 1
    storeB.sweep(category="drift_pool", grace_s=-1.0)
    left = entries()
    assert orphans[0] not in left
    assert all(sorted(k.rsplit("/", 1)[1] for k in ks)[0] == "manifest.json"
               and len(ks) == 2 for ks in left.values())
    out["pool_hosts"] = sorted(m["fields"]["host"]
                               for m in storeB.drift_entries(fp))
    assert out["pool_hosts"] == ["A", "B"]
    out["pool_entries"] = len(left)
    return out


def test_fleet_soak_pooled_recalibration():
    port = _run_fleet("t")
    ref = _run_fleet("j")
    for key in ("n_cfg", "assignment0", "bursts_to_trigger", "generations",
                "profiled", "pool_hosts", "pool_entries"):
        assert port[key] == ref[key], key
    for host in ("A", "B", "C"):
        assert port[host] == ref[host], host
        np.testing.assert_allclose(port["results"][host], ref["results"][host],
                                   **RESULT_TOL)
