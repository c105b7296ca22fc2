"""The port's plan compiler (`swiftly_tpu_torch.plan`) against the JAX
package's, and against the port's own executors.

With equal explicit coefficients and margins, both packages' ``compile_plan``
give the same backward plan, spill mode, serve plan, mesh layout and
per-stage FLOPs, bytes, dispatches and walls at catalogue rows from 1k to
128k, at several budgets, fold groups and device counts, with default and
with calibrated coefficients; and so do ``refit`` / ``refit_from_ledger``
over one synthetic history, ``price_vis``, ``plan_delta``,
``price_cache_tier``, the serve buckets, the admission byte projections
and the queue's ``"hbm"`` sheds. The port's B1 body prices under
``.kernel`` where the JAX package's Pallas body prices under ``.pallas``;
the two have the same FLOP shape, so the stage tables are compared with
that one name mapped.

The port's own rules: its default coefficients share no value with the JAX
package's TPU table; its margins come from `plan_margins` on the inputs'
geometry; a TPU record never calibrates the card; the forward grouping it
plans is the one `StreamedForward(residency="device")` executes; and a
default plan equals the hand-composed partition of phase 11.
"""

import json

import numpy as np
import pytest
import torch

import swiftly_tpu_torch as T
from swiftly_tpu import plan as jplan
from swiftly_tpu.serve import AdmissionQueue as JQueue
from swiftly_tpu_torch import plan as tplan
from swiftly_tpu_torch.plan import model as tmodel
from swiftly_tpu_torch.serve import AdmissionQueue

# the JAX package's default margins, passed to both packages explicitly
FWD_MIN, RESERVE = 3.3e9, 1.2e9
ROWS = ["1k[1]-n512-256", "4k[1]-n2k-512", "16k[1]-n8k-512",
        "32k[1]-n16k-512", "64k[1]-n32k-512", "128k[1]-n32k-512",
        "128k[1]-n64k-1k"]
BUDGETS = [None, 16e9, 40e9, 80e9]
FLOPS = {"fwd": 2.0e13, "bwd": 1.0e13, "fwd.sampled_facet_pass": 3.1e13,
         "fwd.column_pass": 2.5e13, "fwd.column_pass.B1": 2.9e13,
         "bwd.column_pass": 1.5e13, "bwd.column_pass.B1": 1.9e13,
         "bwd.sampled_fold": 1.2e13, "vis.degrid": 1.0e11,
         "vis.grid": 5.0e10}
BYTES = {"spill.h2d": 1.0e10, "spill.write": 4.0e9, "spill.read": 8.0e9,
         "cache.l1": 2.0e10, "bwd.feed_group": 3.0e9, "mesh.psum": 1.0e11,
         "mesh.ring_step": 1.2e11, "vis.degrid": 5.0e10, "vis.grid": 4.0e10}
SUFFIX = {"jax": ".pallas", "port": ".kernel"}


def _coeffs(pkg, source="default"):
    """Each package's `CostCoefficients` with the same rates; B1's stages
    under each package's name."""
    cls = (jplan if pkg == "jax" else tplan).CostCoefficients
    flops = {k.replace(".B1", SUFFIX[pkg]): v for k, v in FLOPS.items()}
    return cls(flops_per_s=flops, bytes_per_s=dict(BYTES), dispatch_s=1e-4,
               source=source)


def _unify(obj):
    """A JSON-ready copy with the JAX package's ``.pallas`` / ``pallas``
    names as the port's ``.kernel`` / ``kernel``."""
    text = json.dumps(obj, sort_keys=True, default=str)
    return json.loads(text.replace(".pallas", ".kernel")
                      .replace('"pallas"', '"kernel"'))


@pytest.fixture(params=["einsum", "kernel"])
def body(request, monkeypatch):
    """The column-pass bodies both packages price alike: the operator
    einsums, or the fused triple product (B1 / Pallas)."""
    if request.param == "einsum":
        monkeypatch.setenv("SWIFTLY_COLPASS", "einsum")
        monkeypatch.setenv("SWIFTLY_COLPASS_BWD", "einsum")
    else:
        monkeypatch.setenv("SWIFTLY_COLPASS", "pallas")
        monkeypatch.setenv("SWIFTLY_COLPASS_BWD", "pallas")
    return request.param


def _plans(name, budget, source, **kw):
    extra = {k: kw.pop(k) for k in ("n_devices", "fold_group", "planar",
                                    "dtype_bytes", "real_facets")
             if k in kw}
    out = {}
    for pkg, mod in (("jax", jplan), ("port", tplan)):
        inputs = mod.PlanInputs.from_config(name, hbm_budget=budget, **extra)
        out[pkg] = mod.compile_plan(
            inputs, coeffs=_coeffs(pkg, source), fwd_min=FWD_MIN,
            reserve=RESERVE, spill_budget=kw.get("spill_budget", 48e9),
            spill_dir=kw.get("spill_dir"), **{
                k: v for k, v in kw.items()
                if k not in ("spill_budget", "spill_dir")})
    return out


def _assert_same_plan(plans):
    got, want = plans["port"], plans["jax"]
    assert got.backward.parts == want.backward.parts
    assert got.backward.as_dict() == want.backward.as_dict()
    assert got.spill.as_dict() == want.spill.as_dict()
    assert got.serve.as_dict() == want.serve.as_dict()
    assert _unify(got.mesh.as_dict()) == _unify(want.mesh.as_dict())
    for key in ("wall_s", "hbm_peak_bytes", "stages"):
        assert _unify(got.predicted[key]) == _unify(want.predicted[key]), key
    assert _unify(got.alternatives) == _unify(want.alternatives)
    assert got.coeffs_source == want.coeffs_source


@pytest.mark.parametrize("name", ROWS)
@pytest.mark.parametrize("source", ["default", "measured"])
def test_compile_plan_equals_jax(name, source, body):
    """Every budget and fold group, both planar and complex cores, real
    facets or not: the same plan and the same priced stages."""
    for budget in BUDGETS:
        for fold_group in (2, 4):
            for planar, real in ((True, True), (True, False), (False, False)):
                kw = dict(fold_group=fold_group, planar=planar,
                          real_facets=real)
                if not planar:
                    kw["dtype_bytes"] = 8
                _assert_same_plan(_plans(name, budget, source, **kw))


@pytest.mark.parametrize("name", ["1k[1]-n512-256", "32k[1]-n16k-512",
                                  "128k[1]-n32k-512"])
def test_compile_plan_equals_jax_with_overrides(name, body):
    """Operator overrides, a disk tier, forced replay, four devices, the
    forward-only mode: still the same plan."""
    cases = [
        dict(n_facet_env=3, n_row_env=3, feed_env=3),
        dict(n_facet_env=9, n_row_env=2),
        dict(spill_budget=1e6, spill_dir="/spill"),
        dict(spill_budget=1e6),
        dict(allow_spill=False),
        dict(n_devices=4),
        dict(mode="streamed"),
    ]
    for kw in cases:
        for budget in (None, 40e9):
            _assert_same_plan(_plans(name, budget, "measured", **dict(kw)))
            _assert_same_plan(_plans(name, budget, "default", **dict(kw)))


@pytest.mark.parametrize("name", ["4k[1]-n2k-512", "32k[1]-n16k-512"])
def test_stage_pricing_equals_jax(name, body):
    """`price_forward`, `price_backward` and the colpass and collective
    candidates, stage by stage."""
    jin = jplan.PlanInputs.from_config(name, n_devices=4)
    tin = tplan.PlanInputs.from_config(name, n_devices=4)
    from swiftly_tpu.plan import model as jmodel

    jc, tc = _coeffs("jax", "measured"), _coeffs("port", "measured")
    parts = [(0, 3, 0, 100), (3, 9, 100, jin.yB)]
    assert _unify([s.as_dict() for s in jmodel.price_forward(jin, jc)]) == \
        _unify([s.as_dict() for s in tmodel.price_forward(tin, tc)])
    for spill_fed in (True, False):
        for feed in (1, 2):
            want = jmodel.price_backward(jin, parts, 4, jc, spill_fed,
                                         feed_group=feed)
            got = tmodel.price_backward(tin, parts, 4, tc, spill_fed,
                                        feed_group=feed)
            assert _unify([(s.name, s.as_dict()) for s in got]) == \
                _unify([(s.name, s.as_dict()) for s in want])
    jcand = {c["colpass"]: c for c in jmodel.price_colpass_candidates(jin, jc)}
    tcand = {c["colpass"]: c for c in tmodel.price_colpass_candidates(tin, tc)}
    assert _unify(jcand) == _unify(tcand)
    assert jmodel.price_collective_candidates(jin, jc) == \
        tmodel.price_collective_candidates(tin, tc)


def test_default_coefficients_share_nothing_with_the_tpu_table():
    """No rate, dispatch cost or overlap discount of the port's defaults is
    a value of the JAX package's TPU table."""
    from swiftly_tpu.plan import model as jmodel

    tpu_values = (set(jmodel._DEFAULT_FLOPS_PER_S.values())
                  | set(jmodel._DEFAULT_BYTES_PER_S.values())
                  | {jmodel._DEFAULT_DISPATCH_S,
                     jmodel.RING_OVERLAP_DISCOUNT})
    ours = (set(tmodel._DEFAULT_FLOPS_PER_S.values())
            | set(tmodel._DEFAULT_BYTES_PER_S.values())
            | {tmodel._DEFAULT_DISPATCH_S, tmodel.RING_OVERLAP_DISCOUNT})
    assert not ours & tpu_values
    # every stage the JAX table prices has a port default, the kernel
    # stages under their port names
    for key in list(jmodel._DEFAULT_FLOPS_PER_S):
        key = key.replace(".pallas", ".kernel")
        if key in ("fwd.column_pass.kernel", "bwd.column_pass.kernel",
                   "bwd.sampled_fold", "fwd", "bwd", "vis.degrid",
                   "vis.grid"):
            assert key in tmodel._DEFAULT_FLOPS_PER_S, key
    assert set(jmodel._DEFAULT_BYTES_PER_S) == set(tmodel._DEFAULT_BYTES_PER_S)
    c = tplan.CostCoefficients()
    assert c.source == "default" and not c.calibrated


def _history(platforms):
    """Synthetic artifact records: per stage flops/bytes and walls."""
    out = []
    for k, plat in enumerate(platforms):
        out.append({
            "manifest": {"device": {"platform": plat}},
            "telemetry": {"stages": {
                "fwd.column_pass": {"total_s": 0.5 + 0.1 * k,
                                    "flops": 2.0e12},
                "bwd.sampled_fold": {"total_s": 0.25, "flops": 1.0e12},
                "spill.write": {"total_s": 0.5, "bytes": 4.0e9},
                "fwd.d2h": {"total_s": 0.1},
            }},
        })
    return out


def test_refit_equals_jax():
    history = _history(["cpu", "cpu", "cpu"])
    want = jplan.autotune.refit(history)
    got = tplan.refit(history)
    assert got.source == want.source == "measured"
    assert got.flops_per_s == want.flops_per_s
    assert got.bytes_per_s == want.bytes_per_s
    assert (got.n_records, got.platform) == (want.n_records, want.platform)
    for name in ("32k[1]-n16k-512", "128k[1]-n32k-512"):
        for budget in (None, 40e9):
            plans = {}
            for pkg, mod, h in (("jax", jplan, want), ("port", tplan, got)):
                inputs = mod.PlanInputs.from_config(name, hbm_budget=budget)
                plans[pkg] = mod.compile_plan(
                    inputs, history=history, fwd_min=FWD_MIN,
                    reserve=RESERVE, spill_budget=48e9, spill_dir=None)
            assert plans["port"].backward.as_dict() == \
                plans["jax"].backward.as_dict()


def test_refit_from_ledger_equals_jax(monkeypatch):
    from swiftly_tpu.obs import ledger as jledger
    from swiftly_tpu_torch.obs import ledger as tledger

    monkeypatch.setenv("SWIFTLY_CALIBRATION_HISTORY", "0")
    monkeypatch.setenv("SWIFTLY_COLPASS", "einsum")  # one stage vocabulary
    monkeypatch.setenv("SWIFTLY_COLPASS_BWD", "einsum")
    inputs = tplan.PlanInputs.from_config("4k[1]-n2k-512")
    plan = tplan.compile_plan(inputs, coeffs=_coeffs("port"),
                              fwd_min=FWD_MIN, reserve=RESERVE)
    blocks = []
    for k in range(3):
        telem = {"stages": {
            "fwd.sampled_facet_pass": {"count": 1, "total_s": 0.2 + 0.01 * k},
            "fwd.column_pass": {"count": 7, "total_s": 0.4},
            "bwd.column_pass": {"count": 7, "total_s": 0.3 - 0.01 * k},
        }}
        blocks.append(tledger.plan_accuracy_block(
            plan.artifact_block(), telem,
            {"device": {"platform": "cpu"}, "git_sha": "x"}))
    got = tplan.refit_from_ledger(blocks)
    want = jplan.refit_from_ledger(blocks)
    assert got.source == want.source == "ledger"
    assert got.flops_per_s == want.flops_per_s
    assert got.bytes_per_s == want.bytes_per_s
    assert tplan.ledger_readiness(blocks) == jplan.ledger_readiness(blocks)
    assert tledger.stage_accuracy(plan.artifact_block(), telem) == \
        jledger.stage_accuracy(plan.artifact_block(), telem)


def test_refit_never_lets_a_tpu_record_calibrate_the_card():
    """The repository's artifacts are TPU records. One TPU record and one
    card record, the TPU record first: only the card's counts, in `refit`
    and in ``compile_plan(history=...)``, which passes no platform."""
    tpu, gpu = _history(["tpu", "gpu"])
    gpu["telemetry"]["stages"]["fwd.column_pass"]["total_s"] = 1.0
    coeffs = tplan.refit([tpu, gpu])
    assert coeffs.source == "measured"
    assert coeffs.platform == "gpu" and coeffs.n_records == 1
    assert coeffs.flops_per_s["fwd.column_pass"] == pytest.approx(2.0e12)
    # the JAX package's refit takes the first record's platform: the TPU's
    assert jplan.autotune.refit([tpu, gpu]).platform == "tpu"
    # TPU records alone calibrate nothing
    assert tplan.refit([tpu, tpu]).source == "default"
    inputs = tplan.PlanInputs.from_config("4k[1]-n2k-512")
    plan = tplan.compile_plan(inputs, history=[tpu, gpu], fwd_min=FWD_MIN,
                              reserve=RESERVE)
    assert plan.coeffs_source == "measured"
    assert tplan.compile_plan(inputs, history=[tpu]).coeffs_source == \
        "default"


@pytest.mark.parametrize("hit", [0.0, 0.7])
@pytest.mark.parametrize("grid", [False, True])
def test_price_vis_equals_jax(hit, grid):
    for n, xA, W in ((2**16, 448, 8), (1000, 160, 6)):
        got = tplan.price_vis(n, xA, support=W, cache_hit_rate=hit,
                              include_grid=grid, coeffs=_coeffs("port"))
        want = jplan.price_vis(n, xA, support=W, cache_hit_rate=hit,
                               include_grid=grid, coeffs=_coeffs("jax"))
        assert got.as_dict() == want.as_dict()
        assert got.explain() == want.explain()


@pytest.mark.parametrize("name", ["1k[1]-n512-256", "32k[1]-n16k-512"])
def test_plan_delta_and_cache_tier_equal_jax(name, body):
    jin = jplan.PlanInputs.from_config(name)
    tin = tplan.PlanInputs.from_config(name)
    for k in range(1, jin.n_facets + 1):
        got = tplan.plan_delta(tin, k, coeffs=_coeffs("port"))
        want = jplan.plan_delta(jin, k, coeffs=_coeffs("jax"))
        assert got.as_dict() == want.as_dict()
    for replicas, rows in ((1, None), (3, 64), (5, None)):
        got = tplan.price_cache_tier(tin, coeffs=_coeffs("port"),
                                     replicas=replicas, l1_rows=rows)
        want = jplan.price_cache_tier(jin, coeffs=_coeffs("jax"),
                                      replicas=replicas, l1_rows=rows)
        assert got.as_dict() == want.as_dict()
    with pytest.raises(ValueError):
        tplan.plan_delta(tin, 0)
    with pytest.raises(ValueError):
        tplan.price_cache_tier(tin, replicas=0)


def test_buckets_equal_jax():
    for n in range(0, 300):
        assert tplan.bucket_shape(n) == jplan.bucket_shape(n)
    for cap in (1, 2, 5, 8, 64, 100):
        assert tplan.bucket_sizes(cap) == jplan.bucket_sizes(cap)
    from swiftly_tpu_torch.serve import scheduler

    assert scheduler.bucket_shape is tplan.bucket_shape


@pytest.mark.parametrize("backend", ["planar", "torch"])
def test_projected_bytes_equal_jax(backend):
    import jax.numpy as jnp

    import swiftly_tpu as J

    params = T.SWIFT_CONFIGS["1k[1]-n512-256"]
    jconf = J.SwiftlyConfig(
        backend="planar" if backend == "planar" else "jax",
        dtype=jnp.float64 if backend == "planar" else jnp.complex128,
        **params)
    tconf = T.SwiftlyConfig(
        backend=backend,
        dtype=torch.float64 if backend == "planar" else torch.complex128,
        device="cpu", **params)
    jf = J.SwiftlyForward(jconf, [(fc, None) for fc in
                                  J.make_full_facet_cover(jconf)])
    tf = T.SwiftlyForward(tconf, [(fc, None) for fc in
                                  T.make_full_facet_cover(tconf)])
    assert tplan.projected_request_bytes(tconf) == \
        jplan.projected_request_bytes(jconf)
    assert tplan.projected_column_bytes(tf) == \
        jplan.projected_column_bytes(jf)


def test_hbm_sheds_equal_jax():
    """The same offers through both queues: the same admissions and
    ``"hbm"`` sheds, and the same projected bytes after each."""
    from swiftly_tpu.serve import SubgridRequest as JReq
    from swiftly_tpu_torch.serve import SubgridRequest

    params = T.SWIFT_CONFIGS["1k[1]-n512-256"]
    cfg = T.SwiftlyConfig(backend="torch", device="cpu", **params)
    sgs = T.make_full_subgrid_cover(cfg)
    rng = np.random.default_rng(3)
    picks = [sgs[i] for i in rng.integers(0, len(sgs), 40)]
    outcomes = []
    for Queue, Req in ((JQueue, JReq), (AdmissionQueue, SubgridRequest)):
        q = Queue(max_depth=30, hbm_budget_bytes=5000, request_bytes=100,
                  column_bytes=1000)
        seen = []
        for k, sg in enumerate(picks):
            seen.append((q.offer(Req(sg)), q.projected_bytes()))
            if k % 7 == 6:
                cols = q.columns()
                q.take(cols[0].off0, limit=2)
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1]
    assert any(r == (False, "hbm") for (r, _) in outcomes[1])


def test_default_plan_keeps_the_seed_fold_group_and_the_hand_plan():
    """Default coefficients keep the inputs' fold group, and the plan's
    grid and feed group are the ones phase 11 composes by hand
    (`plan_backward_passes` / `plan_backward_feed` with `plan_margins`)."""
    inputs = tplan.PlanInputs.from_config(
        "32k[1]-n16k-512", fold_group=4, real_facets=True, hbm_budget=80e9)
    plan = tplan.compile_plan(inputs, n_facet_env=3, n_row_env=3,
                              feed_env=3, spill_budget=48e9)
    assert plan.coeffs_source == "default"
    assert plan.backward.fold_group == 4
    fwd_min, reserve = tplan.plan_margins(inputs.base(), inputs.xA, 4)
    assert plan.predicted["fwd_min_bytes"] == int(fwd_min)
    assert plan.predicted["reserve_bytes"] == int(reserve)
    parts, resident = tplan.plan_backward_passes(
        9, inputs.yB, inputs.per_facet_acc_bytes, inputs.per_facet_row_bytes,
        4, 80e9, fwd_min, reserve, n_facet_env=3, n_row_env=3)
    q = tplan.plan_backward_feed(parts, resident, 80e9, fwd_min, reserve,
                                 feed_env=3)
    assert plan.backward.parts == parts
    assert plan.backward.resident_bytes == resident
    assert plan.backward.feed_group == q == 3
    assert plan.spill.mode == "ram"  # 3 feeds; the stream fits the RAM budget
    assert plan.forward["hbm_headroom"] == int(3 * resident + reserve)
    # calibrated coefficients may pick another fold group
    cal = tplan.compile_plan(inputs, coeffs=tplan.CostCoefficients(
        flops_per_s={"bwd.sampled_fold": 1e9}, source="ledger"))
    chosen = [a for a in cal.alternatives if a.get("chosen")]
    assert len(chosen) == 1 and cal.backward.fold_group in (1, 2, 4, 8)


def test_margins_come_from_the_geometry_unless_given():
    inputs = tplan.PlanInputs.from_config("128k[1]-n32k-512", fold_group=4,
                                          real_facets=True, hbm_budget=84e9)
    plan = tplan.compile_plan(inputs, spill_budget=48e9)
    fwd_min, reserve = tplan.plan_margins(inputs.base(), inputs.xA, 4)
    assert plan.predicted["fwd_min_bytes"] == int(fwd_min)
    assert plan.predicted["reserve_bytes"] == int(reserve)
    given = tplan.compile_plan(inputs, spill_budget=48e9, fwd_min=1e9,
                               reserve=2e9)
    assert given.predicted["fwd_min_bytes"] == int(1e9)
    assert given.predicted["reserve_bytes"] == int(2e9)
    # the 128k round trip: single-facet passes, fed in groups
    assert plan.backward.n_facet_passes == 9
    assert plan.spill.mode == "replay"  # the stream is over the RAM budget
    assert tplan.compile_plan(inputs, spill_budget=48e9,
                              spill_dir="/spill").spill.mode == "disk"


def _small_forward(budget=None):
    params = T.SWIFT_CONFIGS["1k[1]-n512-256"]
    cfg = T.SwiftlyConfig(backend="planar", dtype=torch.float64,
                          device="cpu", **params)
    fcs = T.make_full_facet_cover(cfg)
    sgcs = T.make_full_subgrid_cover(cfg)
    facets = [T.make_real_facet(cfg.image_size, fc, [(1.0, 3, -5)])
              for fc in fcs]
    fwd = T.StreamedForward(cfg, list(zip(fcs, facets)), residency="device")
    return cfg, fcs, sgcs, fwd


@pytest.mark.parametrize("budget", [None, 3.2e9, 3.05e9, 2.0e9, 0.9e9])
def test_planned_forward_is_the_executed_one(budget, monkeypatch):
    """The forward grouping `compile_plan` predicts is the one
    `StreamedForward(residency="device")` executes under the same budget
    (here given to the executor through its budget hook: on the CPU the
    executors are unlimited), with the plan's headroom, resident facets
    or facet slabs."""
    cfg, fcs, sgcs, fwd = _small_forward()
    inputs = tplan.PlanInputs.from_cover(cfg, fcs, sgcs, hbm_budget=budget,
                                         real_facets=True, fold_group=2)
    plan = tplan.compile_plan(inputs, spill_budget=1e12)
    fwd.hbm_headroom = plan.forward["hbm_headroom"]
    if budget is not None:
        monkeypatch.setattr(type(fwd), "_hbm_budget",
                            lambda self: budget - self.hbm_headroom)
    for _ in fwd.stream_column_groups(sgcs):
        pass
    executed = fwd.last_plan
    assert executed["mode"] == plan.forward["mode"]
    assert executed["col_group"] == plan.forward["col_group"]
    assert executed["colpass"] == plan.forward["colpass"]
    if executed["mode"] == "grouped":
        assert executed["facet_group"] == plan.forward["facet_group"]
        assert executed["slab_depth"] == plan.forward["slab_depth"]


def test_plan_artifact_block_validates_and_explains():
    from swiftly_tpu_torch.obs import validate_plan_artifact

    inputs = tplan.PlanInputs.from_config("32k[1]-n16k-512",
                                          hbm_budget=40e9, real_facets=True)
    plan = tplan.compile_plan(inputs, n_facet_env=3, feed_env=2,
                              spill_budget=48e9)
    block = plan.artifact_block(measured_wall_s=12.5)
    assert validate_plan_artifact({"plan_compiled": block}) == []
    assert block["predicted_vs_measured"] > 0
    text = plan.explain()
    assert "feed schedule" in text and "predicted wall" in text
    cache = plan.spill.make_cache()
    assert cache.stats()["policy"] == plan.spill.as_dict()
    assert tplan.plan_mesh_layout(inputs.replace(n_devices=4)).facet_shards \
        == 4
