"""The port's serving fleet, health leases, autoscaler and cache fabric
(``swiftly_tpu_torch.serve`` fleet/health/autoscale, ``swiftly_tpu_torch.cache``
and ``vis.FleetRowSource``), against the JAX package's ``tests/test_fleet.py``
and ``tests/test_vis.py:422``.

Held to the JAX package: ``preferred_replica`` routes every column to the
same replica for 2 to 5 replicas (rendezvous hashing is integer arithmetic).
The port's own contracts are the JAX package's cases, on stub services and
injected clocks (no sleeping): lease grading and revival, shed hints, the
shared OOM classifier, rendezvous routing, zero-loss failover, hedging,
structured sheds, the fleet-wide admission cap, the brownout ladder, the
fabric's L1/L2 views, patch gate, version pin, roll and single-flight dedup,
the autoscaler's hysteresis, and scale-out/drain; then real replicas
(planar f64, threads): a kill mid-workload stays bit-identical, a facet
update through the fabric rolls once and every replica serves the patched
rows, and visibilities served through `FleetRowSource` equal a direct
degrid of a fresh forward's rows bit for bit.

Torch runs on one intra-op thread.
"""

import functools
import random
import time

import numpy as np
import pytest
import torch

import swiftly_tpu_torch as T
from swiftly_tpu_torch.cache import SharedStreamTier
from swiftly_tpu_torch.resilience.breaker import OPEN
from swiftly_tpu_torch.resilience.retry import is_oom
from swiftly_tpu_torch.serve import service as serve_service
from swiftly_tpu_torch.serve.autoscale import FleetAutoscaler
from swiftly_tpu_torch.serve.fleet import ServeFleet, _rendezvous_score
from swiftly_tpu_torch.serve.health import (
    LIVE,
    REVOKED,
    SUSPECT,
    HealthLease,
    HealthMonitor,
)
from swiftly_tpu_torch.serve.queue import (
    STATUS_OK,
    STATUS_SHED,
    AdmissionQueue,
    RequestResult,
    SubgridRequest,
)
from swiftly_tpu_torch.utils.spill import SpillCache


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# Health leases + monitor
# ---------------------------------------------------------------------------


def test_lease_grades_by_missed_beats():
    clk = _Clock()
    lease = HealthLease("r", interval_s=0.1, miss_suspect=2,
                        miss_revoke=5, clock=clk)
    lease.beat(100.0)
    assert lease.state(100.15) == LIVE
    assert lease.state(100.25) == SUSPECT
    assert lease.state(100.45) == SUSPECT
    assert lease.state(100.55) == REVOKED


def test_lease_revival_race_is_a_non_event():
    """A suspect replica that beats again goes back to live — no
    failover; but once REVOKED latches, late (zombie) beats are
    counted and ignored until an explicit revive."""
    clk = _Clock()
    lease = HealthLease("r", interval_s=0.1, miss_suspect=2,
                        miss_revoke=5, clock=clk)
    lease.beat(100.0)
    assert lease.state(100.3) == SUSPECT
    assert lease.beat(100.3) is True      # the race: beat wins
    assert lease.state(100.35) == LIVE
    lease.revoke()
    assert lease.state(100.35) == REVOKED
    assert lease.beat(100.36) is False    # zombie beat ignored
    assert lease.zombie_beats == 1
    assert lease.state(100.4) == REVOKED  # still revoked
    lease.revive(100.5)
    assert lease.state(100.5) == LIVE
    assert lease.beat(100.55) is True


def test_monitor_probe_revives_slow_but_alive_replica():
    clk = _Clock()
    lease = HealthLease("r", interval_s=0.1, miss_suspect=2,
                        miss_revoke=50, clock=clk)
    mon = HealthMonitor(probe=lambda key: True, clock=clk)
    mon.register("r", lease)
    lease.beat(100.0)
    clk.t = 100.3  # suspect; probe says alive -> lease renewed
    assert mon.check() == []
    assert lease.state(100.35) == LIVE


def test_monitor_probe_failure_revokes_suspect_immediately():
    clk = _Clock()
    lease = HealthLease("r", interval_s=0.1, miss_suspect=2,
                        miss_revoke=50, clock=clk)
    mon = HealthMonitor(probe=lambda key: False, clock=clk)
    mon.register("r", lease)
    lease.beat(100.0)
    clk.t = 100.3  # suspect (far from miss_revoke); probe fails
    assert mon.check() == [("r", LIVE, REVOKED)]
    assert lease.revoked
    assert mon.stats()["transitions"][0]["to"] == REVOKED


# ---------------------------------------------------------------------------
# Shed hints + the shared OOM classifier (satellites)
# ---------------------------------------------------------------------------


class _Cfg:
    # mask-less by default: the cache-fabric feed's `_masks_match`
    # reads these like a real SubgridConfig's
    mask0 = None
    mask1 = None

    def __init__(self, off0, off1=0, size=16):
        self.off0 = off0
        self.off1 = off1
        self.size = size


def test_retry_after_hint_prices_backlog_at_drain_rate():
    q = AdmissionQueue(max_depth=100)
    assert q.retry_after_hint() == 0.05  # no drain observed yet
    for i in range(20):
        q.offer(SubgridRequest(_Cfg(0, i)), now=100.0)
    q.take(0, limit=10, now=100.0)
    q.take(0, limit=10, now=101.0)  # 10 requests/s observed
    for i in range(10):
        q.offer(SubgridRequest(_Cfg(0, i)), now=101.0)
    # depth 10 at ~10 rps -> ~1.1s hint
    assert 0.5 <= q.retry_after_hint() <= 2.0
    # clamped at the top for a huge backlog over a trickle rate
    q2 = AdmissionQueue(max_depth=10000)
    for i in range(2000):
        q2.offer(SubgridRequest(_Cfg(0, i)), now=100.0)
    q2.take(0, limit=1, now=100.0)
    q2.take(0, limit=1, now=110.0)  # 0.1 rps
    assert q2.retry_after_hint() == 5.0


def test_is_oom_is_the_one_shared_classifier():
    assert is_oom(MemoryError())
    assert is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert is_oom(RuntimeError("CUDA error: out of memory"))
    assert not is_oom(ValueError("shape mismatch"))
    assert not is_oom(IOError("disk gone"))
    # the service delegates to it, not to a private fork
    assert serve_service._is_oom is is_oom


# ---------------------------------------------------------------------------
# Fleet logic (stub services — routing, failover, hedge, brownout)
# ---------------------------------------------------------------------------


class _StubSched:
    def __init__(self):
        self.max_batch = 8


class _StubService:
    """The SubgridService surface the fleet touches, minus the engine:
    submissions queue, `pump()` serves everything with a payload that
    names the serving replica."""

    def __init__(self, rid, max_depth=64):
        self.rid = rid
        self.queue = AdmissionQueue(max_depth=max_depth)
        self.scheduler = _StubSched()
        self.served = 0
        self.journeys = (0.0, 0.0)

    def submit(self, config, priority=0, deadline_s=None):
        req = SubgridRequest(config, priority=priority,
                             deadline_s=deadline_s)
        ok, reason = self.queue.offer(req)
        if not ok:
            req._complete(
                RequestResult(
                    STATUS_SHED, shed_reason=reason,
                    retry_after_s=self.queue.retry_after_hint(),
                )
            )
        return req

    def pump(self):
        for col in list(self.queue.columns()):
            for r in self.queue.take(col.off0):
                self.served += 1
                r._complete(
                    RequestResult(STATUS_OK,
                                  data=(self.rid, r.config.off0))
                )

    def recent_journey_totals(self, window=256):
        return self.journeys

    def stats(self):
        return {"n_served": self.served, "n_requests": self.served,
                "n_shed": 0, "p99_ms": 1.0}


def _stub_fleet(clk, n=3, **kw):
    kw.setdefault("lease_interval_s", 0.1)
    kw.setdefault("miss_suspect", 2)
    kw.setdefault("miss_revoke", 4)
    kw.setdefault("seed", 7)
    fleet = ServeFleet(
        lambda rid: _StubService(rid), n, clock=clk, **kw
    )
    for r in fleet.replicas.values():
        r.lease.beat(clk.t)
    return fleet


def _beat(fleet, clk, exclude=()):
    for rid, r in fleet.replicas.items():
        if rid not in exclude:
            r.lease.beat(clk.t)


def test_fleet_routing_is_column_stable_and_spread():
    clk = _Clock()
    fleet = _stub_fleet(clk)
    # same column -> same replica, every time
    for off0 in range(8):
        rids = {
            fleet.submit(_Cfg(off0, i), priority=1).replica_trail[-1]
            for i in range(3)
        }
        assert len(rids) == 1
        assert rids.pop() == fleet.preferred_replica(off0)
    # many columns spread over more than one replica
    owners = {fleet.preferred_replica(off0) for off0 in range(32)}
    assert len(owners) >= 2
    for r in fleet.replicas.values():
        r.service.pump()
    fleet.tick(clk.t)
    assert fleet.stats()["served"] == 24


def test_fleet_failover_reroutes_admitted_work_zero_loss():
    clk = _Clock()
    fleet = _stub_fleet(clk)
    victim = fleet.preferred_replica(5)
    freq = fleet.submit(_Cfg(5), priority=1)
    assert freq.replica_trail == [victim]
    fleet.replica(victim).dead = True
    clk.t += 0.5
    _beat(fleet, clk, exclude={victim})
    fleet.tick(clk.t)   # probe fails -> revoked -> queue stranded
    clk.t += 0.5
    _beat(fleet, clk, exclude={victim})
    fleet.tick(clk.t)   # past the backoff gate: rerouted to a survivor
    for rid, r in fleet.replicas.items():
        if rid != victim:
            r.service.pump()
    fleet.tick(clk.t)
    assert freq.done and freq.result.ok
    assert freq.result.data[0] != victim
    st = fleet.stats()
    assert st["failovers"] >= 1 and st["served"] == 1
    assert fleet.replica(victim).breaker.state == OPEN
    assert any(
        h["owner"] == victim and h["to"] == REVOKED
        for h in st["health"]["transitions"]
    )


def test_fleet_already_completed_request_is_not_failed_over():
    """The failover edge case: a request whose result landed before
    the supervisor noticed its replica died must complete from that
    result — never be re-issued."""
    clk = _Clock()
    fleet = _stub_fleet(clk)
    freq = fleet.submit(_Cfg(1), priority=1)
    rid = freq.replica_trail[-1]
    fleet.replica(rid).service.pump()     # served; scan hasn't run yet
    fleet.replica(rid).dead = True        # ...and now the replica dies
    clk.t += 0.5
    _beat(fleet, clk, exclude={rid})
    fleet.tick(clk.t)
    assert freq.done and freq.result.ok
    st = fleet.stats()
    assert st["failovers"] == 0 and st["reroutes"] == 0
    assert st["served"] == 1
    total_submitted = sum(
        r.service.served + len(r.service.queue)
        for r in fleet.replicas.values()
    )
    assert total_submitted == 1  # no duplicate send ever left the door


def test_fleet_hedge_first_completion_wins():
    clk = _Clock()
    fleet = _stub_fleet(clk, n=2, hedge_budget_s=0.2,
                        lease_interval_s=10.0)
    freq = fleet.submit(_Cfg(3), priority=1)
    primary = freq.replica_trail[-1]
    clk.t += 0.5  # pending past the budget
    fleet.tick(clk.t)
    st = fleet.stats()
    assert st["hedges"] == 1
    other = next(r for r in fleet.replicas if r != primary)
    fleet.replica(other).service.pump()   # the hedge lands first
    fleet.tick(clk.t)
    assert freq.done and freq.result.ok
    assert freq.result.data[0] == other
    assert fleet.stats()["hedge_wins"] == 1
    # the primary's (loser) completion cannot overwrite the winner
    fleet.replica(primary).service.pump()
    fleet.tick(clk.t)
    assert freq.result.data[0] == other
    assert fleet.stats()["served"] == 1


def test_fleet_all_replicas_shed_returns_structured_shed():
    clk = _Clock()
    fleet = _stub_fleet(clk, n=2)
    for rid, r in fleet.replicas.items():
        r.service.queue = AdmissionQueue(max_depth=1)
    a = fleet.submit(_Cfg(0), priority=1)
    b = fleet.submit(_Cfg(0), priority=1)  # preferred replica full
    assert a.result is None
    # b overflowed its preferred replica and fell to the other one
    assert not b.done or b.result.ok
    c = fleet.submit(_Cfg(0), priority=1)  # both full now
    assert c.done and c.result.status == STATUS_SHED
    assert c.result.shed_reason == "fleet"
    assert c.result.retry_after_s is not None


def test_fleet_hbm_admission_cap_prices_and_sheds():
    """The fleet-wide admission cap consumes the plan compiler's serve
    pricing (`plan.compile_plan(...).serve`): pending requests price
    ``request_bytes`` each plus ``column_bytes`` per distinct pending
    column per replica; a submission whose projection crosses the cap
    sheds at the fleet door, and draining the backlog re-admits."""
    clk = _Clock()
    fleet = _stub_fleet(clk, n=2, hbm_budget_bytes=3_300,
                        request_bytes=1_000, column_bytes=100)
    a = fleet.submit(_Cfg(0), priority=1)   # projects 1100: admitted
    b = fleet.submit(_Cfg(0), priority=1)   # column already priced
    assert not a.done and not b.done
    assert fleet.projected_fleet_bytes() == 2_100
    c = fleet.submit(_Cfg(0), priority=1)   # 3100 <= cap: admitted
    assert not c.done
    d = fleet.submit(_Cfg(1), priority=1)   # 4200 (new column): shed
    assert d.done and d.result.status == STATUS_SHED
    assert d.result.shed_reason == "hbm"
    st = fleet.stats()
    assert st["admission"]["hbm_sheds"] == 1
    assert st["admission"]["projected_bytes"] == 3_100
    # draining the backlog frees the projection; the retry is admitted
    for r in fleet.replicas.values():
        r.service.pump()
    assert fleet.projected_fleet_bytes() == 0
    assert not fleet.submit(_Cfg(1), priority=1).done


def test_fleet_brownout_ladder_and_recovery():
    clk = _Clock()
    fleet = _stub_fleet(clk, n=2, lease_interval_s=10.0,
                        brownout_share=0.5, brownout_min_depth=1,
                        brownout_escalate_s=0.1)
    for r in fleet.replicas.values():
        r.service.journeys = (9.0, 10.0)  # queue share 0.9
    held = fleet.submit(_Cfg(2), priority=1)  # creates queued depth
    fleet.tick(clk.t)
    assert fleet.brownout_level == 1
    low = fleet.submit(_Cfg(2), priority=0)
    assert low.done and low.result.status == STATUS_SHED
    assert low.result.shed_reason == "brownout"
    assert low.result.retry_after_s is not None
    high = fleet.submit(_Cfg(2), priority=1)  # above the floor: admitted
    assert high.result is None
    clk.t += 0.2
    fleet.tick(clk.t)
    assert fleet.brownout_level == 2  # rung 2: per-request dispatch
    assert all(
        r.service.scheduler.max_batch == 1
        for r in fleet.replicas.values()
    )
    # pressure clears -> hysteresis steps down one rung per tick and
    # restores the coalescing batch size
    for r in fleet.replicas.values():
        r.service.journeys = (0.0, 10.0)
        r.service.pump()
    fleet.tick(clk.t)
    fleet.tick(clk.t)
    assert fleet.brownout_level == 0
    assert all(
        r.service.scheduler.max_batch == 8
        for r in fleet.replicas.values()
    )
    assert fleet.stats()["brownout"]["sheds"] == 1
    for fr in (held, high):
        fleet.tick(clk.t)
        assert fr.done and fr.result.ok


# ---------------------------------------------------------------------------
# Cache fabric: one shared L2, per-replica L1 views, single-flight dedup
# ---------------------------------------------------------------------------


def _mini_fabric(n_cols=3, rows=4, l1_rows=64):
    """A hand-filled recorded stream (n_cols entries x rows subgrids,
    entry k's rows uniformly 100k + s) under a `SharedStreamTier`."""
    spill = SpillCache(budget_bytes=1e9)
    spill.begin_fill(tag="fabric-test")
    cols = {}
    for k in range(n_cols):
        col = [_Cfg(16 * k, 8 * s) for s in range(rows)]
        arr = np.stack(
            [np.full((5,), 100.0 * k + s, np.float32)
             for s in range(rows)]
        )[None]
        assert spill.put([list(enumerate(col))], arr)
        cols[k] = col
    assert spill.end_fill()
    return SharedStreamTier(spill, l1_rows=l1_rows), spill, cols


def test_fabric_views_share_one_l2_and_own_their_l1():
    fabric, spill, cols = _mini_fabric()
    v0 = fabric.view(0)
    assert fabric.view(0) is v0  # stable per replica
    v1 = fabric.view(1)
    cfg = cols[0][0]
    row = v0.lookup(cfg)  # L2 read + promotion into v0's L1
    np.testing.assert_array_equal(row, np.full((5,), 0.0, np.float32))
    assert v0.l2_hits == 1 and v0.l1_hits == 0 and v0.promotions == 1
    np.testing.assert_array_equal(v0.lookup(cfg), row)  # L1 hit
    assert v0.l1_hits == 1
    # the other replica's L1 is its own: its first lookup hits the L2
    assert v1.lookup(cfg) is not None and v1.l2_hits == 1
    # L1 hits never touch the shared spill — exactly two L2 row reads
    assert spill.stats()["ram_reads"] == 2
    # a config outside the recorded cover is a miss, not an error
    assert v0.lookup(_Cfg(999)) is None and v0.misses == 1
    st = fabric.stats()
    assert st["resident_stream_copies"] == 1
    assert st["views"] == 2 and st["stream_entries"] == 3
    assert st["l1_hits"] == 1 and st["l2_hits"] == 2
    assert st["hit_ratio"] == 0.75  # 3 served / 4 lookups
    assert {r["replica"] for r in st["per_view"]} == {0, 1}


def test_fabric_l1_is_bounded_and_retired_views_keep_counters():
    fabric, _spill, cols = _mini_fabric(n_cols=1, rows=4, l1_rows=2)
    v = fabric.view(7)
    for cfg in cols[0]:
        v.lookup(cfg)
    assert v.l1_evictions == 2 and v.stats()["l1_len"] == 2
    # the two hottest (most recent) rows answer from L1
    assert v.lookup(cols[0][-1]) is not None
    assert v.l1_hits == 1
    # a drained replica's view folds into the retired ledger so
    # fabric-wide stats survive scale-in
    fabric.drop_view(7)
    st = fabric.stats()
    assert st["views"] == 0 and st["retired_views"] == 1
    assert st["l2_hits"] == 4 and st["l1_hits"] == 1
    assert st["l1_evictions"] == 2


def test_fabric_gate_mid_patch_version_pin_and_roll():
    fabric, spill, cols = _mini_fabric()
    v = fabric.view(0)
    cfg = cols[0][0]
    assert v.lookup(cfg) is not None  # now L1-resident
    # mid-patch: even the L1-resident row refuses — an L1 hit must
    # never bypass the patch window
    spill.begin_patch()
    try:
        with pytest.raises(LookupError):
            v.lookup(cfg)
    finally:
        spill.end_patch()
    assert v.stale == 1
    assert v.lookup(cfg) is not None  # serving resumes after end_patch
    # version pin: a landed facet update re-stamps the spill; the view
    # refuses at its old pin until the fabric rolls it forward
    spill.stream_version += 1
    with pytest.raises(LookupError):
        v.lookup(cfg)
    assert v.stale == 2
    assert fabric.roll({"mode": "patch"}) == 1
    assert fabric.stream_version == 1 and v.stream_version == 1
    # patch mode rewrites payloads in place: row coordinates — and the
    # shared index — survive, so no re-scan; but the L1 rows were
    # recorded under the superseded stack and are dropped
    assert fabric.index_builds == 1 and fabric.rolls == 1
    assert v.stats()["l1_len"] == 0
    assert v.lookup(cfg) is not None
    # a replay re-recorded the stream: the index is rebuilt once and
    # every live view re-points at it
    v2 = fabric.view(1)
    spill.stream_version += 1
    fabric.roll({"mode": "replay"})
    assert fabric.index_builds == 2
    assert v._index is fabric.index and v2._index is fabric.index
    assert v.stream_version == v2.stream_version == 2


def test_fabric_single_flight_dedups_concurrent_misses():
    import threading

    fabric, _spill, _cols = _mini_fabric()
    release = threading.Event()
    calls, results = [], []

    def slow_compute():
        calls.append(threading.get_ident())
        assert release.wait(timeout=10.0)
        return "payload"

    leader = threading.Thread(
        target=lambda: results.append(
            fabric.single_flight("col-9", slow_compute)
        )
    )
    leader.start()
    deadline = time.time() + 10.0
    while "col-9" not in fabric._inflight and time.time() < deadline:
        time.sleep(0.001)  # leadership is registered: followers dedup
    followers = [
        threading.Thread(
            target=lambda: results.append(
                fabric.single_flight("col-9", lambda: "follower")
            )
        )
        for _ in range(3)
    ]
    for t in followers:
        t.start()
    time.sleep(0.02)
    release.set()
    for t in [leader, *followers]:
        t.join(timeout=10.0)
    # ONE compute; every caller got the leader's result
    assert len(calls) == 1
    assert results == ["payload"] * 4
    assert fabric.dedup_computes == 1 and fabric.dedup_hits == 3


def test_fabric_single_flight_leader_failure_does_not_fan_out():
    import threading

    fabric, _spill, _cols = _mini_fabric()
    release = threading.Event()
    errors, follower_out = [], []

    def failing_leader():
        def fail():
            assert release.wait(timeout=10.0)
            raise RuntimeError("leader died")

        try:
            fabric.single_flight("col-3", fail)
        except RuntimeError as exc:
            errors.append(exc)

    t_lead = threading.Thread(target=failing_leader)
    t_lead.start()
    deadline = time.time() + 10.0
    while "col-3" not in fabric._inflight and time.time() < deadline:
        time.sleep(0.001)
    t_follow = threading.Thread(
        target=lambda: follower_out.append(
            fabric.single_flight("col-3", lambda: "independent")
        )
    )
    t_follow.start()
    time.sleep(0.02)
    release.set()
    t_lead.join(timeout=10.0)
    t_follow.join(timeout=10.0)
    # the failure re-raised to the leader ONLY; the follower computed
    # independently — dedup never converts one failure into N
    assert len(errors) == 1
    assert follower_out == ["independent"]


def test_fabric_request_key_separates_masked_configs():
    key = SharedStreamTier.request_key
    assert key(_Cfg(0, 8)) == key(_Cfg(0, 8))
    assert key(_Cfg(0, 8)) != key(_Cfg(0, 16))
    masked = _Cfg(0, 8)
    masked.mask0 = np.zeros(masked.size)
    assert key(masked) != key(_Cfg(0, 8))  # masks are part of the result


# ---------------------------------------------------------------------------
# Autoscaler policy (stub fleet): hysteresis, cooldown, band, drain pick
# ---------------------------------------------------------------------------


def test_autoscaler_scale_out_needs_held_streak_then_cooldown_band():
    clk = _Clock()
    fleet = _stub_fleet(clk, n=2)
    auto = FleetAutoscaler(
        fleet, min_replicas=1, max_replicas=3, up_share=0.6,
        down_share=0.15, min_queue_depth=2, hold_ticks=3,
        cooldown_s=0.5, clock=clk,
    )
    fleet.autoscaler = auto
    for r in fleet.replicas.values():
        r.service.journeys = (9.0, 10.0)  # queue share 0.9
    for i in range(4):
        fleet.submit(_Cfg(i), priority=1)  # backlog >= depth floor
    assert auto.tick(clk.t) is None  # streak 1
    assert auto.tick(clk.t) is None  # streak 2
    assert auto.tick(clk.t) == "scale_out"  # streak held -> act
    assert len(fleet.replicas) == 3
    assert auto.events[0]["action"] == "scale_out"
    # cooldown holds the next decisions even under sustained pressure
    assert auto.tick(clk.t) is None
    assert auto.tick(clk.t) is None
    assert auto.stats()["held_by_cooldown"] == 2
    # past the cooldown the streak is held again — but the band caps
    # the fleet at max_replicas
    clk.t += 1.0
    assert auto.tick(clk.t) is None
    assert auto.stats()["held_by_band"] == 1
    assert len(fleet.replicas) == 3
    assert auto.stats()["scale_outs"] == 1


def test_autoscaler_dead_zone_resets_streaks():
    clk = _Clock()
    fleet = _stub_fleet(clk, n=2)
    auto = FleetAutoscaler(
        fleet, min_replicas=1, max_replicas=4, up_share=0.6,
        down_share=0.15, min_queue_depth=2, hold_ticks=2,
        cooldown_s=0.0, clock=clk,
    )
    for r in fleet.replicas.values():
        r.service.journeys = (9.0, 10.0)
    fleet.submit(_Cfg(0), priority=1)
    fleet.submit(_Cfg(1), priority=1)
    assert auto.tick(clk.t) is None  # up streak 1
    # the signal dips into the dead zone: BOTH streaks reset —
    # hysteresis demands an unbroken one-sided signal
    for r in fleet.replicas.values():
        r.service.journeys = (4.0, 10.0)  # share 0.4
    assert auto.tick(clk.t) is None
    for r in fleet.replicas.values():
        r.service.journeys = (9.0, 10.0)
    assert auto.tick(clk.t) is None  # streak restarted at 1, not 2
    assert auto.tick(clk.t) == "scale_out"
    assert len(fleet.replicas) == 3


def test_autoscaler_drains_idlest_replica_and_fleet_retires_it():
    clk = _Clock()
    fleet = _stub_fleet(clk, n=2)
    auto = FleetAutoscaler(
        fleet, min_replicas=1, max_replicas=4, up_share=0.6,
        down_share=0.15, min_queue_depth=4, hold_ticks=2,
        cooldown_s=0.0, clock=clk,
    )
    fleet.autoscaler = auto
    # scale out first (hot signal + backlog)
    for r in fleet.replicas.values():
        r.service.journeys = (9.0, 10.0)
    reqs = [fleet.submit(_Cfg(i), priority=1) for i in range(6)]
    auto.tick(clk.t)
    assert auto.tick(clk.t) == "scale_out"
    newcomer = max(fleet.replicas)
    fleet.replica(newcomer).lease.beat(clk.t)
    # load fades: queues drain, the journey share drops to idle
    for r in fleet.replicas.values():
        r.service.pump()
        r.service.journeys = (0.0, 10.0)
    assert auto.tick(clk.t) is None  # down streak 1
    assert auto.tick(clk.t) == "drain"
    # the candidate is the idlest replica, ties to the HIGHEST rid —
    # later scale-outs drain first, the core fleet keeps warm forwards
    assert auto.events[-1]["replica"] == newcomer
    assert newcomer in fleet.draining
    # a second policy hit cannot double-pick the draining replica
    assert auto._drain_candidate() != newcomer
    # the supervision pass retires it (queue empty, nothing in flight)
    _beat(fleet, clk)
    fleet.tick(clk.t)
    assert newcomer not in fleet.replicas
    st = fleet.stats()
    assert st["scale_outs"] == 1 and st["drains"] == 1
    assert st["retired"][0]["id"] == newcomer
    assert st["retired"][0]["reason"] == "drained"
    assert st["autoscale"]["scale_outs"] == 1
    assert st["autoscale"]["drains"] == 1
    # park the signal in the dead zone so the remaining supervision
    # ticks (fleet.tick drives the attached autoscaler too) hold still
    for r in fleet.replicas.values():
        r.service.journeys = (4.0, 10.0)
    for fr in reqs:
        fleet.tick(clk.t)
        assert fr.done and fr.result.ok  # zero loss through the cycle


# ---------------------------------------------------------------------------
# Fleet elasticity: add_replica / begin_drain lifecycle
# ---------------------------------------------------------------------------


def test_fleet_add_replica_joins_routing():
    clk = _Clock()
    fleet = _stub_fleet(clk, n=2)
    rid = fleet.add_replica()
    assert rid == 2 and len(fleet.replicas) == 3
    fleet.replica(rid).lease.beat(clk.t)
    # rendezvous hands the newcomer a share of columns, and submits
    # to those columns admit there
    off0 = next(
        o for o in range(256) if fleet.preferred_replica(o) == rid
    )
    freq = fleet.submit(_Cfg(off0), priority=1)
    assert freq.replica_trail[-1] == rid
    fleet.replica(rid).service.pump()
    fleet.tick(clk.t)
    assert freq.done and freq.result.data[0] == rid
    assert fleet.stats()["scale_outs"] == 1


def test_fleet_begin_drain_stops_routing_and_retires_zero_loss():
    clk = _Clock()
    fleet = _stub_fleet(clk)
    victim = fleet.preferred_replica(7)
    freq = fleet.submit(_Cfg(7), priority=1)
    assert freq.replica_trail[-1] == victim
    fleet.begin_drain(victim)
    fleet.begin_drain(victim)  # idempotent
    assert victim in fleet.draining
    with pytest.raises(KeyError):
        fleet.begin_drain(999)
    # routing skips a draining replica immediately...
    rerouted = fleet.submit(_Cfg(7), priority=1)
    assert rerouted.replica_trail[-1] != victim
    # ...but its already-admitted request completes THERE (zero loss)
    for r in fleet.replicas.values():
        r.service.pump()
    _beat(fleet, clk)
    fleet.tick(clk.t)
    assert freq.done and freq.result.ok
    assert freq.result.data[0] == victim
    assert victim not in fleet.replicas  # retired once its work drained
    st = fleet.stats()
    assert st["drains"] == 1 and st["draining"] == []
    assert st["retired"][0]["reason"] == "drained"
    assert st["retired"][0]["served"] >= 1


def test_fleet_forced_drain_falls_back_to_failover():
    clk = _Clock()
    fleet = _stub_fleet(clk, drain_timeout_s=0.5,
                        failover_backoff_s=0.01)
    victim = fleet.preferred_replica(3)
    freq = fleet.submit(_Cfg(3), priority=1)
    fleet.begin_drain(victim)
    # the laggard never drains: past drain_timeout_s the fleet revokes
    # its lease, forcing the zero-loss failover path
    clk.t += 1.0
    _beat(fleet, clk)
    fleet.tick(clk.t)
    assert fleet.replica(victim).lease.revoked
    clk.t += 0.5
    _beat(fleet, clk, exclude={victim})
    fleet.tick(clk.t)  # monitor sees the revocation: queue strands
    clk.t += 0.5
    _beat(fleet, clk, exclude={victim})
    fleet.tick(clk.t)  # past the backoff: rerouted to a survivor
    for rid, r in fleet.replicas.items():
        if rid != victim:
            r.service.pump()
    fleet.tick(clk.t)
    assert freq.done and freq.result.ok
    assert freq.result.data[0] != victim
    st = fleet.stats()
    assert st["failovers"] >= 1
    assert any(
        row["reason"] == "dead_during_drain" for row in st["retired"]
    )
    assert victim not in fleet.replicas


# ---------------------------------------------------------------------------
# Routing against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_preferred_replica_equals_the_jax_package(n):
    from swiftly_tpu.serve.fleet import ServeFleet as JFleet
    from swiftly_tpu.serve.fleet import _rendezvous_score as jscore

    clk = _Clock()
    fleet = _stub_fleet(clk, n=n)
    jfleet = JFleet(lambda rid: _StubService(rid), n, clock=clk)
    cols = list(range(0, 32768, 448)) + list(range(-64, 64))
    assert ([fleet.preferred_replica(c) for c in cols]
            == [jfleet.preferred_replica(c) for c in cols])
    assert all(_rendezvous_score(c, r) == jscore(c, r)
               for c in cols[:40] for r in range(n))


# ---------------------------------------------------------------------------
# Real replicas: threaded fleet, kill, facet update, visibilities
# ---------------------------------------------------------------------------

TEST_PARAMS = {  # tests/test_fleet.py:947
    "W": 13.5625,
    "fov": 1.0,
    "N": 1024,
    "yB_size": 416,
    "yN_size": 512,
    "xA_size": 228,
    "xM_size": 256,
}
SOURCES = [(1, 1, 0), (0.5, -30, 40)]


@functools.cache
def _setup():
    config = T.SwiftlyConfig(backend="planar", dtype=torch.float64,
                             device="cpu", **TEST_PARAMS)
    fcs = T.make_full_facet_cover(config)
    sgs = T.make_full_subgrid_cover(config)
    tasks = [(fc, T.make_facet(config.image_size, fc, SOURCES)) for fc in fcs]
    return config, tasks, sgs


@pytest.fixture
def cover():
    return _setup()


def _real_fleet(cover, n=3, **kw):
    config, facet_tasks, _sgs = cover

    def factory(rid):
        fwd = T.SwiftlyForward(config, facet_tasks, lru_forward=2,
                               queue_size=50)
        return T.SubgridService(
            fwd, scheduler=T.serve.CoalescingScheduler(max_batch=8))

    kw.setdefault("lease_interval_s", 0.05)
    kw.setdefault("miss_suspect", 2)
    kw.setdefault("miss_revoke", 5)
    kw.setdefault("breaker_reopen_s", 0.2)
    kw.setdefault("seed", 11)
    return ServeFleet(factory, n, **kw)


def test_fleet_kill_failover_stays_bit_identical(cover):
    config, facet_tasks, sgs = cover
    fleet = _real_fleet(cover)
    try:
        fleet.start()
        victim = fleet.preferred_replica(sgs[0].off0)
        workload = [sg for sg in sgs
                    if fleet.preferred_replica(sg.off0) == victim]
        assert len(workload) >= 3
        reqs = [fleet.submit(sg, priority=1) for sg in workload]
        fleet.kill_replica(victim)
        assert fleet.drain(timeout=180.0)
        for r in reqs:
            res = r.wait(timeout=60.0)
            assert res is not None and res.ok, res
        st = fleet.stats()
        assert fleet.replica(victim).dead
        assert st["failovers"] + st["hedges"] >= 1
        assert any(h["owner"] == victim and h["to"] == REVOKED
                   for h in st["health"]["transitions"])
        assert fleet.replica(victim).breaker.state == OPEN
    finally:
        fleet.stop()
    fwd_ref = T.SwiftlyForward(config, facet_tasks, lru_forward=2,
                               queue_size=50)
    for sg, req in zip(workload, reqs):
        assert torch.equal(req.result.data, fwd_ref.get_subgrid_task(sg))


def test_fabric_facet_update_rolls_once_every_replica_observes(cover):
    config, facet_tasks, sgs = cover
    engine = T.IncrementalForward(config, facet_tasks,
                                  SpillCache(budget_bytes=2**30))
    engine.record(sgs)
    fabric = engine.fabric(l1_rows=8)

    def factory(rid, feed):
        fwd = T.SwiftlyForward(config, facet_tasks, lru_forward=2,
                               queue_size=50)
        return T.SubgridService(
            fwd, scheduler=T.serve.CoalescingScheduler(max_batch=8),
            cache_feed=feed)

    fleet = ServeFleet(factory, 3, fabric=fabric, lease_interval_s=10.0,
                       seed=11)
    for r in fleet.replicas.values():
        r.lease.beat(fleet._clock())

    def serve_all(configs):
        reqs = [fleet.submit(sg, priority=1) for sg in configs]
        for r in fleet.replicas.values():
            while r.service.pump_once():
                pass
        fleet.tick()
        for fr in reqs:
            assert fr.done and fr.result.ok
            assert fr.result.path == "cache"
        return reqs

    probe = sgs[:6]
    serve_all(probe)
    v_before = fabric.stream_version
    fills_before = engine.spill.stats()["fills"]
    mags = [float(np.abs(np.asarray(d)).max()) for _fc, d in facet_tasks]
    hot = int(np.argmax(mags))
    assert mags[hot] > 0
    new_tasks = [(fc, np.asarray(d) * (1.75 if i == hot else 1.0))
                 for i, (fc, d) in enumerate(facet_tasks)]
    report = fleet.post_facet_update(engine, new_tasks, use_plan=False)
    assert report["mode"] == "patch"
    assert report["stream_version"] == v_before + 1
    assert fabric.stream_version == v_before + 1
    assert fabric.rolls == 1
    for r in fleet.replicas.values():
        assert r.service.stream_version == v_before + 1
        assert r.service.cache_feed.stream_version == v_before + 1
        assert r.service.cache_feed is fabric.view(r.rid)
    assert engine.spill.stats()["fills"] == fills_before
    assert fabric.index_builds == 1
    reqs2 = serve_all(probe)
    fresh = T.IncrementalForward(config, new_tasks,
                                 SpillCache(budget_bytes=2**30))
    fresh.record(sgs)
    fresh_feed = fresh.feed()
    for sg, fr in zip(probe, reqs2):
        np.testing.assert_allclose(np.asarray(fr.result.data),
                                   fresh_feed.lookup(sg),
                                   rtol=1e-4, atol=1e-8)
    st = fabric.stats()
    assert st["resident_stream_copies"] == 1 and st["rolls"] == 1
    assert fleet.stats()["stream_copies"] == 1


def test_fleet_row_source_serves_bit_identical(cover):
    """tests/test_vis.py:422: samples served through a real 2-replica
    fleet equal a direct degrid of a fresh forward's rows, bit for bit."""
    from swiftly_tpu_torch import vis as tvis

    config, facet_tasks, sgs = cover
    kernel = tvis.vis_kernel()
    fleet = _real_fleet(cover, n=2)
    index = tvis.VisCoverIndex(sgs, kernel.support, config.image_size)
    rng = np.random.default_rng(12)
    uv = []
    while len(uv) < 16:
        sg = sgs[rng.integers(len(sgs))]
        half = sg.size / 2.0 - kernel.support - 1
        p = np.array([[sg.off0 + rng.uniform(-half, half),
                       sg.off1 + rng.uniform(-half, half)]])
        if not index.map_samples(p)[1]:
            uv.append(p[0])
    uv = np.asarray(uv)
    try:
        fleet.start()
        svc = tvis.VisibilityService(
            subgrid_configs=sgs, N=config.image_size, kernel=kernel,
            row_source=tvis.FleetRowSource(fleet, priority=1), device="cpu")
        handle = svc.serve(uv).wait(timeout=120)
        assert handle.status == "ok", handle
    finally:
        fleet.stop()
    fwd_ref = T.SwiftlyForward(config, facet_tasks, lru_forward=2,
                               queue_size=64)
    owners, shed = index.map_samples(uv)
    assert not shed
    for (off0, off1), e in owners.items():
        row = fwd_ref.get_subgrid_task(index.config(off0, off1))
        ref = tvis.degrid_batch(
            row, e["iu0"], e["iv0"],
            kernel.weights(e["fu"], dtype=np.float64),
            kernel.weights(e["fv"], dtype=np.float64), device="cpu")
        np.testing.assert_array_equal(handle.data[e["idx"]], ref)
