"""Two-level collectives in the port's cost model and planner, against the
reference's (``tests/test_hierarchical.py``, one counterpart a test):
level-split bytes, the Ballard-Knight-Rouse communication lower bound, the
mesh-mapping enumeration and the bandwidth-optimality certification.  Pure
plan metadata, no mesh or process (the executed path is
``tests/test_torch_dist_levels.py``).

Byte counts and bounds are constant-free: they equal the reference's at
``rel=1e-12``.  A plan's choices (flat or hierarchical a node, the schedule,
the winning mapping) depend on the bandwidth constants: the port's H100
links put NVLink at 18x the node-crossing rate, the reference's TPU links
ICI at 4x DCN.  Where a test's outcome depends on them it is held twice:
with the reference's constants patched into the port's cost model (the
same plan as the reference's, row for row), and with the H100 constants
(the port's own invariant, the test saying which).
"""

import math

import pytest

import repro.analysis.roofline as jroof
import repro.plan as jplan
import repro_torch.plan as tplan
import repro_torch.plan.cost as tcost

# the reference's CI mesh: 2 nodes x 4 devices, "device" the fast intra-node axis
AXIS_SIZES = {"node": 2, "device": 4}
INTRA = ("device",)
MAPPINGS = [{0: "node", 2: "device"}, {1: "node", 2: "device"}, {2: "node", 0: "device"}]
MAPPING_IDS = ["0n2d", "1n2d", "2n0d"]
REL = 1e-12


def _problem(mod, mode_axes, shape=(8, 6, 4, 5), rank=7, intra=INTRA, **kw):
    return mod.Problem(shape=shape, rank=rank, mode_axes=mode_axes, axis_sizes=AXIS_SIZES,
                       intra_axes=intra, **kw)


@pytest.fixture
def reference_constants(monkeypatch):
    """Price the port's plans with the reference's four roofline constants
    (``NVLINK_BW`` takes ``ICI_BW``, ``INFINIBAND_BW`` takes ``DCN_BW``)."""
    monkeypatch.setattr(tcost, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(tcost, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(tcost, "NVLINK_BW", jroof.ICI_BW)
    monkeypatch.setattr(tcost, "INFINIBAND_BW", jroof.DCN_BW)


def _plan_rows(d: dict) -> tuple:
    """What a two-level plan chose, in a form both packages share."""
    return (
        d["executor"], d["schedule"], d["certified"], d["lower_bound_bytes"],
        [(n["node"], n["algorithm"], n["collective"], n["lower_bound_bytes"]) for n in d["nodes"]],
        [(r["mode_axes"], r["executor"], r["schedule"], r["inter_bytes_per_node"],
          r["lower_bound_bytes"], r["certified"], r["collectives"], r["selected"])
         for r in d["mappings"]],
    )


# ------------------------------------------------------- level-split bytes
def test_flat_problem_level_split_matches_legacy_ring():
    """A problem without intra_axes prices the single-level ring, all of it
    on the fast links, as the reference does."""
    b = 1000.0
    for mod in (jplan, tplan):
        prob = mod.Problem(shape=(8, 6, 4, 5), rank=7, mode_axes={0: "node", 2: "device"},
                           axis_sizes=AXIS_SIZES)
        coll, inter = mod.collective_level_bytes(prob, b, ("node", "device"))
        assert coll == mod.ring_allreduce_bytes(b, 8) and inter == 0.0
    tp = tplan.Problem(shape=(8, 6, 4, 5), rank=7, mode_axes={0: "node", 2: "device"},
                       axis_sizes=AXIS_SIZES)
    assert tplan.collective_level_bytes(tp, b, ("node", "device"), "hierarchical") == (
        tplan.ring_allreduce_bytes(b, 8), 0.0)


PROBLEMS = [
    ((8, 6, 4, 5), 7, {0: "node", 2: "device"}, ("node", "device")),
    ((8, 6, 4, 5), 7, {1: "node", 2: "device"}, ("node",)),
    ((8, 6, 4, 5), 7, {2: "node", 0: "device"}, ("device",)),
    ((12, 8, 8), 3, {0: "node", 1: "device"}, ("node", "device")),
    ((16, 8, 12), 5, {2: "device", 1: "node"}, ()),
]


@pytest.mark.parametrize("shape,rank,mode_axes,axes", PROBLEMS)
@pytest.mark.parametrize("collective", ["flat", "hierarchical"])
@pytest.mark.parametrize("block", [1000.0, 3.0 * 7 * 4])
def test_collective_level_bytes_equal_the_reference(shape, rank, mode_axes, axes, collective,
                                                    block):
    j = jplan.collective_level_bytes(_problem(jplan, mode_axes, shape, rank), block, axes,
                                     collective)
    t = tplan.collective_level_bytes(_problem(tplan, mode_axes, shape, rank), block, axes,
                                     collective)
    assert t == pytest.approx(j, rel=REL)
    assert tplan.hierarchical_applicable(_problem(tplan, mode_axes, shape, rank), axes) == \
        jplan.hierarchical_applicable(_problem(jplan, mode_axes, shape, rank), axes)


def test_hierarchical_level_split_prices_shard_crossing():
    """Hierarchical: the ring within the node (k devices) plus a ring of the
    1/k shard across nodes; only the shard ring crosses the slow level."""
    prob = _problem(tplan, {0: "node", 2: "device"})
    b = 1000.0
    coll, inter = tplan.collective_level_bytes(prob, b, ("node", "device"), "hierarchical")
    expect_inter = tplan.ring_allreduce_bytes(b / 4, 2)
    assert inter == pytest.approx(expect_inter, rel=REL)
    assert coll == pytest.approx(tplan.ring_allreduce_bytes(b, 4) + expect_inter, rel=REL)
    coll_f, inter_f = tplan.collective_level_bytes(prob, b, ("node", "device"))
    assert coll_f == tplan.ring_allreduce_bytes(b, 8) and inter_f == coll_f
    assert inter < inter_f


def test_hierarchical_applicable_needs_both_levels():
    prob = _problem(tplan, {0: "node", 2: "device"})
    assert tplan.hierarchical_applicable(prob, ("node", "device"))
    assert not tplan.hierarchical_applicable(prob, ("device",))
    assert not tplan.hierarchical_applicable(prob, ("node",))
    assert not tplan.hierarchical_applicable(prob, ())


@pytest.mark.parametrize("algorithm", ["1step", "2step", "fused", "matrix_free", "dimtree"])
@pytest.mark.parametrize("executor", ["sharded", "overlapping", "compressed"])
def test_mode_cost_inter_bytes_never_exceed_collective_bytes(algorithm, executor):
    """Every mode's split under both collectives equals the reference's byte
    for byte (flops and HBM bytes too), and the inter share never exceeds
    the whole."""
    jp, tp = _problem(jplan, {0: "node", 2: "device"}), _problem(tplan, {0: "node", 2: "device"})
    for n in range(4):
        for coll in ("flat", "hierarchical"):
            t = tplan.executor_mode_cost(tp, n, algorithm, executor, collective=coll)
            j = jplan.executor_mode_cost(jp, n, algorithm, executor, collective=coll)
            assert 0.0 <= t.inter_bytes <= t.collective_bytes + 1e-9
            assert t.intra_bytes == pytest.approx(t.collective_bytes - t.inter_bytes, rel=REL)
            for key in ("collective_bytes", "inter_bytes", "intra_bytes", "flops", "bytes"):
                assert getattr(t, key) == pytest.approx(getattr(j, key), rel=REL, abs=1e-9), key


@pytest.mark.parametrize("name", ["flat", "binary", "chain"])
def test_node_costs_split_levels_as_the_reference(name):
    """Every node of every schedule shape, both collectives and all three
    sharded executors: the reference's bytes."""
    jp, tp = _problem(jplan, {0: "node", 2: "device"}), _problem(tplan, {0: "node", 2: "device"})
    jsched = {"flat": jplan.flat_schedule, "binary": jplan.binary_schedule,
              "chain": jplan.chain_schedule}[name](jp)
    tsched = {"flat": tplan.flat_schedule, "binary": tplan.binary_schedule,
              "chain": tplan.chain_schedule}[name](tp)
    for jn, tn in zip(jsched.walk(), tsched.walk()):
        for ex in ("sharded", "overlapping", "compressed"):
            for coll in ("flat", "hierarchical"):
                j = jplan.node_cost(jp, jn, ex, collective=coll)
                t = tplan.node_cost(tp, tn, ex, collective=coll)
                for key in ("collective_bytes", "inter_bytes", "bytes", "flops"):
                    assert getattr(t, key) == pytest.approx(getattr(j, key), rel=REL), key


# ------------------------------------------------------------- lower bound
def test_lower_bound_is_grid_minimum():
    """The bound is the least per-grid volume over the integer node grids:
    recomputed by brute force, and equal to the reference's."""
    shape, rank, P, s = (8, 6, 4, 5), 7, 8, 4.0

    def grid_volume(grid):
        return sum(2.0 * (shape[n] / grid[n]) * rank * s * (1.0 - grid[n] / P)
                   for n in range(len(shape)))

    def grids(n_modes, p):
        if n_modes == 1:
            yield (p,)
            return
        for d in range(1, p + 1):
            if p % d == 0:
                for rest in grids(n_modes - 1, p // d):
                    yield (d,) + rest

    brute = min(grid_volume(g) for g in grids(4, P))
    bound = tplan.mttkrp_comm_lower_bound(shape, rank, P, itemsize=s)
    assert bound == pytest.approx(brute, rel=REL)
    total, terms, grid = tplan.mttkrp_comm_lower_bound(shape, rank, P, itemsize=s, per_mode=True)
    assert total == pytest.approx(bound, rel=REL)
    assert sum(terms) == pytest.approx(total, rel=REL)
    assert math.prod(grid) == P


@pytest.mark.parametrize("shape,rank", [((8, 6, 4, 5), 7), ((12, 8, 8), 3),
                                        ((225, 59, 200, 200), 10), ((16, 9, 25), 4)])
@pytest.mark.parametrize("nodes", [1, 2, 3, 4, 6, 8, 12, (2, 4), (3, 2, 2)])
def test_lower_bound_equals_the_reference(shape, rank, nodes):
    jt = jplan.mttkrp_comm_lower_bound(shape, rank, nodes, per_mode=True)
    tt = tplan.mttkrp_comm_lower_bound(shape, rank, nodes, per_mode=True)
    assert tt[0] == pytest.approx(jt[0], rel=REL)
    assert tt[1] == pytest.approx(jt[1], rel=REL)
    assert tt[2] == jt[2]


def test_lower_bound_trivial_cases():
    assert tplan.mttkrp_comm_lower_bound((8, 6, 4), 7, 1) == 0.0
    assert tplan.mttkrp_comm_lower_bound((8, 6, 4, 5), 7, (2, 4)) == pytest.approx(
        tplan.mttkrp_comm_lower_bound((8, 6, 4, 5), 7, 8), rel=REL)
    with pytest.raises(ValueError, match="node count"):
        tplan.mttkrp_comm_lower_bound((8, 6), 2, 0)
    with pytest.raises(ValueError, match="at least one mode"):
        tplan.mttkrp_comm_lower_bound((), 2, 2)


# ------------------------------------------------------------- certification
@pytest.mark.parametrize("mode_axes", MAPPINGS, ids=MAPPING_IDS)
def test_bound_below_modeled_inter_volume_of_every_candidate(mode_axes):
    """The certification invariant, under the H100 constants: the bound
    (the reference's, byte for byte) never exceeds the modeled node-crossing
    volume of any enumerated mapping."""
    d = tplan.plan_sweep(_problem(tplan, mode_axes), executor="auto").describe()
    jd = jplan.plan_sweep(_problem(jplan, mode_axes), executor="auto").describe()
    assert d["lower_bound_bytes"] == pytest.approx(jd["lower_bound_bytes"], rel=REL)
    assert d["lower_bound_bytes"] > 0 and d["mappings"]
    for row in d["mappings"]:
        assert row["lower_bound_bytes"] == pytest.approx(d["lower_bound_bytes"], rel=REL)
        assert row["inter_bytes_per_node"] >= row["lower_bound_bytes"] - 1e-9


@pytest.mark.parametrize("mode_axes", MAPPINGS, ids=MAPPING_IDS)
@pytest.mark.parametrize("eps", [0.25, 0.0, 1e9])
def test_plans_are_the_reference_plans_under_its_constants(reference_constants, mode_axes, eps):
    """With the reference's bandwidths the port plans exactly what the
    reference plans: executor, schedule, per-node algorithm, collective and
    bound stamp, and every mapping row."""
    t = tplan.plan_sweep(_problem(tplan, mode_axes), executor="auto", certify_eps=eps)
    j = jplan.plan_sweep(_problem(jplan, mode_axes), executor="auto", certify_eps=eps)
    assert _plan_rows(t.describe()) == _plan_rows(j.describe())
    assert t.problem.mode_axes == j.problem.mode_axes


def test_certification_on_known_optimal_mapping():
    """{0: node, 2: device} on (8, 6, 4, 5) reaches the bound exactly: the
    plan certifies at once without enumerating, the leaves carry the
    bound's terms, and a node runs the hierarchical collective.  The
    outcome holds under both constant sets (the given mapping's inter
    volume is the bound either way)."""
    for mod in (tplan, jplan):
        plan = mod.plan_sweep(_problem(mod, {0: "node", 2: "device"}), executor="auto")
        d = plan.describe()
        assert d["certified"] is True and plan.certified_bandwidth_optimal
        rows = d["mappings"]
        assert len(rows) == 1 and rows[0]["selected"] and rows[0]["certified"]
        assert rows[0]["inter_bytes_per_node"] == pytest.approx(d["lower_bound_bytes"], rel=REL)
        leaf_bounds = [np_.lower_bound_bytes for np_ in plan.nodes if np_.node.is_leaf]
        assert all(b is not None for b in leaf_bounds)
        assert sum(leaf_bounds) == pytest.approx(d["lower_bound_bytes"], rel=REL)
        assert any(np_.collective == "hierarchical" for np_ in plan.nodes)


def test_enumeration_stops_early_at_certified_mapping():
    """A bad given mapping fails certification; the planner enumerates,
    stops at a mapping within eps of the bound and selects it -- under the
    H100 constants as under the reference's (the same rows: the certified
    candidate is also the cheapest by either set)."""
    d = tplan.plan_sweep(_problem(tplan, {2: "node", 0: "device"}), executor="auto").describe()
    jd = jplan.plan_sweep(_problem(jplan, {2: "node", 0: "device"}), executor="auto").describe()
    rows = d["mappings"]
    assert len(rows) >= 2 and rows[0]["certified"] is False
    assert d["certified"] is True
    winner = [r for r in rows if r["selected"]]
    assert len(winner) == 1 and winner[0]["certified"]
    assert winner[0]["inter_bytes_per_node"] < rows[0]["inter_bytes_per_node"]
    assert [r["mode_axes"] for r in rows] == [r["mode_axes"] for r in jd["mappings"]]


def test_certify_eps_gates_enumeration():
    """An infinite epsilon certifies the given mapping outright (no
    enumeration); epsilon 0 demands the bound exactly, which the known
    optimal mapping meets."""
    lax = tplan.plan_sweep(_problem(tplan, {2: "node", 0: "device"}), executor="auto",
                           certify_eps=1e9)
    assert lax.certified_bandwidth_optimal and len(lax.mappings) == 1
    strict = tplan.plan_sweep(_problem(tplan, {0: "node", 2: "device"}), executor="auto",
                              certify_eps=0.0)
    assert strict.certified_bandwidth_optimal


def test_h100_constants_pick_the_bound_mapping_at_eps_zero():
    """Where the choice depends on the constants: at ``certify_eps=0`` on the
    bad mapping {2: node, 0: device} the enumeration reaches the mapping
    that meets the bound ({2: device, 0: node}, 420 B a node).  The
    reference's 4x link ratio selects the cheaper-computing {0: device,
    1: node} (476 B a node, not certified); the port's 18x ratio charges the
    extra node-crossing bytes more and selects the certified one.  The
    port's invariant: the winner is the cheapest row by predicted seconds."""
    d = tplan.plan_sweep(_problem(tplan, {2: "node", 0: "device"}), executor="auto",
                         certify_eps=0.0).describe()
    winner = next(r for r in d["mappings"] if r["selected"])
    assert winner["predicted_s"] == min(r["predicted_s"] for r in d["mappings"])
    assert winner["certified"] and winner["mode_axes"] == {"2": "device", "0": "node"}
    jd = jplan.plan_sweep(_problem(jplan, {2: "node", 0: "device"}), executor="auto",
                          certify_eps=0.0).describe()
    assert next(r for r in jd["mappings"] if r["selected"])["certified"] is False


def test_single_level_problem_has_no_bound_or_mappings():
    """Without intra_axes the describe surface is the single-level one: no
    bound, no mapping rows, never certified, every collective flat."""
    prob = tplan.Problem(shape=(8, 6, 4, 5), rank=7, mode_axes={0: "node", 2: "device"},
                         axis_sizes=AXIS_SIZES)
    plan = tplan.plan_sweep(prob, executor="auto")
    d = plan.describe()
    assert d["lower_bound_bytes"] is None and d["certified"] is False and d["mappings"] == []
    assert all(np_.collective == "flat" for np_ in plan.nodes)
    one_node = tplan.Problem(shape=(8, 6, 4, 5), rank=7, mode_axes={0: "node", 2: "device"},
                             axis_sizes={"node": 1, "device": 1}, intra_axes=INTRA)
    d1 = tplan.plan_sweep(one_node, executor="auto").describe()
    assert d1["lower_bound_bytes"] is None and d1["certified"] is False
    assert {n["collective"] for n in d1["nodes"]} == {"flat"}


def test_describe_totals_split_levels():
    d = tplan.plan_sweep(_problem(tplan, {0: "node", 2: "device"}), executor="auto").describe()
    tot = d["totals"]
    assert tot["inter_bytes"] <= tot["collective_bytes"] + 1e-9
    assert tot["intra_bytes"] + tot["inter_bytes"] == pytest.approx(tot["collective_bytes"],
                                                                    rel=REL)
    for row in d["nodes"]:
        assert "collective" in row and "inter_bytes" in row


def test_node_cost_collective_choice_is_cheaper_or_equal():
    """A node planned hierarchical is never priced slower than flat."""
    prob = _problem(tplan, {0: "node", 2: "device"})
    plan = tplan.plan_sweep(prob, executor="auto")
    assert any(np_.collective == "hierarchical" for np_ in plan.nodes)
    for np_ in plan.nodes:
        if np_.collective != "hierarchical":
            continue
        flat = tplan.node_cost(prob, np_.node, plan.executor,
                               **({"algorithm": np_.algorithm} if np_.node.is_leaf else {}))
        assert np_.cost.predicted_s <= flat.predicted_s + 1e-12


# ------------------------------------------------------------- sharded PP prices
@pytest.mark.parametrize("mode_axes,batch", [({0: "node", 1: "device"}, 1),
                                             ({0: "node", 2: "device"}, 1),
                                             ({1: "device"}, 3)])
def test_sharded_pp_prices_equal_the_reference(mode_axes, batch):
    """The pair build's and the correction sweep's terms on a sharded
    problem (pair reductions, the corrections' sums over mapped modes):
    the reference's, byte for byte."""
    kw = dict(shape=(12, 8, 8), rank=3, mode_axes=mode_axes, axis_sizes=AXIS_SIZES, pp_tol=0.05)
    if batch > 1:
        kw["batch"] = batch
    jp, tp = jplan.Problem(**kw), tplan.Problem(**kw)
    for fn in ("pp_build_cost", "pp_correction_cost"):
        j, t = getattr(jplan, fn)(jp).as_dict(), getattr(tplan, fn)(tp).as_dict()
        for key in ("flops", "bytes", "collective_bytes", "inter_bytes"):
            assert t[key] == pytest.approx(j[key], rel=REL), (fn, key)
    assert tplan.pp_build_cost(tp).collective_bytes > 0
    plan = tplan.plan_sweep(tp, "pp")
    assert plan.pp and plan.describe()["pp"]["tol"] == 0.05
