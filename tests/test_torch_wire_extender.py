"""The port's TAS extender with the native wire path on, held against the
JAX extender with it on.

Both extenders take the same cache writes and the same bodies (from the
golden fixtures and numpy seeds), in both nodeCacheCapable modes, over
sequences that walk every layer of the wire path: a response-cache hit,
a refresh, a miss; a host-only policy served from an interned span; a
universe cache of one (eviction) and interning off.  Every response must
carry the same status, headers and bytes, and the partition counters
(native / native_host / exact, hit / miss / bypass, the intern counters)
must move alike.  The port's native answers are also held against its
own exact path (the extension switched off), on a refresh that adds,
removes or renames nodes while a policy's rule rows stay as they were,
where a stale cache key would show.  Skips without a C compiler."""

import json

import numpy as np
import pytest

from platform_aware_scheduling_tpu.extender.server import HTTPRequest as JaxRequest
from platform_aware_scheduling_tpu.extender.types import Args as JaxArgs
from platform_aware_scheduling_tpu.native import get_wirec as get_jax_wirec
from platform_aware_scheduling_tpu.tas import degraded as jax_degraded
from platform_aware_scheduling_tpu.tas import fastpath as jax_fastpath
from platform_aware_scheduling_tpu.tas import telemetryscheduler as jax_ts
from platform_aware_scheduling_tpu.testing.builders import rule
from platform_aware_scheduling_tpu.utils import trace as jax_trace
from platform_aware_scheduling_tpu_torch import native
from platform_aware_scheduling_tpu_torch.extender import server
from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest
from platform_aware_scheduling_tpu_torch.extender.types import Args
from platform_aware_scheduling_tpu_torch.kube.objects import Pod
from platform_aware_scheduling_tpu_torch.tas import degraded
from platform_aware_scheduling_tpu_torch.tas import fastpath
from platform_aware_scheduling_tpu_torch.tas import telemetryscheduler
from platform_aware_scheduling_tpu_torch.utils import decisions, trace

from test_torch_extender import GOLDEN_CASES, Stacks, planned_stacks, policy_body, read_fixture, request_body

HEADERS = {"Content-Type": "application/json"}
PARTITION = (
    "pas_prioritize_native_total",
    "pas_prioritize_native_host_total",
    "pas_prioritize_exact_total",
    "pas_prioritize_host_fallback_total",
    "pas_fastpath_response_hit_total",
    "pas_fastpath_response_miss_total",
    "pas_filter_cache_hit_total",
    "pas_filter_cache_miss_total",
    "pas_filter_cache_bypass_total",
    "pas_wire_intern_hits_total",
    "pas_wire_intern_misses_total",
    "pas_wire_intern_evictions_total",
)
NAMES = [f"n{i}" for i in range(12)]


@pytest.fixture(autouse=True)
def _native_wire(monkeypatch):
    """Both extensions on (skip without a compiler)."""
    monkeypatch.delenv("PAS_TPU_NO_NATIVE", raising=False)
    if native.get_wirec() is None or get_jax_wirec() is None:
        pytest.skip("no C toolchain for the wire extensions")


def port_counters():
    return {name: trace.COUNTERS.get(name) for name in PARTITION}


def counters():
    return port_counters(), {name: jax_trace.COUNTERS.get(name) for name in PARTITION}


#: the port counters' moves made by the exact-path controls, which the
#: partitions below leave out (the JAX side has no control)
CONTROL_MOVES = dict.fromkeys(PARTITION, 0)


class Partition:
    """The partition counters' moves on both packages since creation, the
    controls' left out."""

    def __init__(self):
        self.before = counters()
        self.control_before = dict(CONTROL_MOVES)

    def moved(self):
        port_now, jax_now = counters()
        port_before, jax_before = self.before
        return (
            {k: port_now[k] - port_before[k] - (CONTROL_MOVES[k] - self.control_before[k]) for k in PARTITION},
            {k: jax_now[k] - jax_before[k] for k in PARTITION},
        )

    def assert_equal(self):
        port, jax = self.moved()
        assert port == jax
        return port


def exact(stacks, verb, body, monkeypatch):
    """The port's answer with its wire extension switched off."""
    before = port_counters()
    with monkeypatch.context() as m:
        m.setattr(telemetryscheduler, "get_wirec", lambda: None)
        response = getattr(stacks.port, verb)(HTTPRequest("POST", f"/scheduler/{verb}", HEADERS, body))
    for name, value in port_counters().items():
        CONTROL_MOVES[name] += value - before[name]
    return response


def post(stacks, verb, body, monkeypatch):
    """The port's native answer after checking it equals the JAX
    extender's native answer and the port's own exact answer."""
    got = stacks.post(verb, body)
    want = exact(stacks, verb, body, monkeypatch)
    assert (got.status, got.body) == (want.status, want.body)
    return got


def seeded_values(rng, names, high=100):
    return {n: int(v) for n, v in zip(names, rng.integers(0, high, size=len(names)))}


def ranked_world(node_cache_capable=True):
    stacks = Stacks(node_cache_capable=node_cache_capable)
    stacks.policy(
        "pol",
        {
            "scheduleonmetric": [rule("m", "LessThan", 0)],
            "dontschedule": [rule("m", "GreaterThan", 60), rule("s", "LessThan", 5)],
        },
    )
    stacks.policy("rank", {"scheduleonmetric": [rule("s", "GreaterThan", 0)], "dontschedule": [rule("s", "GreaterThan", 90)]})
    rng = np.random.default_rng(11)
    stacks.metric("m", seeded_values(rng, NAMES))
    stacks.metric("s", seeded_values(rng, NAMES))
    return stacks, rng


MODES = pytest.mark.parametrize("node_cache_capable", [True, False], ids=["ncc", "legacy"])


@pytest.mark.parametrize("verb,request_file,golden", GOLDEN_CASES)
def test_golden_fixture_native(verb, request_file, golden, monkeypatch):
    """Each golden body three times (a first sighting, its interning, a
    hit): the golden bytes every time, on both stacks, counted alike."""
    from test_torch_extender import golden_stacks

    stacks = golden_stacks()
    partition = Partition()
    for _ in range(3):
        got = post(stacks, verb, read_fixture(request_file), monkeypatch)
        assert got.body == read_fixture(golden)
    moved = partition.assert_equal()
    if verb == "prioritize":
        assert moved["pas_prioritize_native_total"] == 3
    else:
        assert moved["pas_filter_cache_hit_total"] + moved["pas_filter_cache_miss_total"] == 3


@MODES
def test_hit_refresh_miss(node_cache_capable, monkeypatch):
    """A body served three times, then a refresh of the rule's metric, then
    the same body (a miss: the violation set and ranking are new
    objects), then a list never seen before; Nodes and NodeNames bodies."""
    stacks, rng = ranked_world(node_cache_capable)
    partition = Partition()
    bodies = [policy_body(p, NAMES[:9], nodes=nodes) for p in ("pol", "rank") for nodes in (False, True)]
    for _round in range(2):
        for body in bodies:
            for verb in ("filter", "prioritize"):
                for _ in range(3):
                    post(stacks, verb, body, monkeypatch)
        stacks.metric("m", seeded_values(rng, NAMES))  # the refresh
        stacks.metric("s", seeded_values(rng, NAMES))
    for body in (policy_body("pol", NAMES[3:], nodes=False), policy_body("pol", NAMES[::-1], nodes=True)):
        for verb in ("filter", "prioritize"):
            post(stacks, verb, body, monkeypatch)
    moved = partition.assert_equal()
    if node_cache_capable:
        assert moved["pas_filter_cache_hit_total"] > 0 and moved["pas_filter_cache_miss_total"] > 0
        assert moved["pas_fastpath_response_hit_total"] > 0 and moved["pas_wire_intern_hits_total"] > 0
        assert moved["pas_prioritize_exact_total"] == 0


@MODES
def test_host_only_policy_over_an_interned_span(node_cache_capable, monkeypatch):
    """A sub-milli metric makes the policy host-only: Prioritize answers on
    ``native_host`` and Filter, once its span is interned, runs the exact
    flow on Args from the wire view (a bypass)."""
    stacks = Stacks(node_cache_capable=node_cache_capable)
    stacks.policy("fine-pol", {"scheduleonmetric": [rule("fine", "LessThan", 0)], "dontschedule": [rule("fine", "GreaterThan", 1)]})
    stacks.metric("fine", {"n1": "100500u", "n2": "2", "n3": "1500m", "n4": "999u"})
    assert stacks.port.mirror.metric_host_only("fine")
    partition = Partition()
    calls = []
    original = telemetryscheduler.MetricsExtender._host_filter_shortcut

    def spy(self, *args):
        result = original(self, *args)
        calls.append(result is not None)
        return result

    monkeypatch.setattr(telemetryscheduler.MetricsExtender, "_host_filter_shortcut", spy)
    for nodes in (False, True):
        body = policy_body("fine-pol", ["n1", "n2", "n3", "n4", "n9"], nodes=nodes)
        for _ in range(3):
            for verb in ("filter", "prioritize"):
                post(stacks, verb, body, monkeypatch)
    moved = partition.assert_equal()
    if node_cache_capable:
        assert moved["pas_prioritize_native_host_total"] == 6
        assert moved["pas_filter_cache_bypass_total"] == 6
        assert True in calls  # the shortcut served once the span was interned


@MODES
@pytest.mark.parametrize("capacity", [1, 0], ids=["one_universe", "interning_off"])
def test_universe_eviction_and_interning_off(node_cache_capable, capacity, monkeypatch):
    """Two candidate lists in turn through a universe cache of one (each
    sighting evicts the other) and with interning off: the span caches
    serve alone, with the same bytes."""
    monkeypatch.setattr(fastpath.PrioritizeFastPath, "UNIVERSE_CACHE_SIZE", capacity)
    monkeypatch.setattr(jax_fastpath.PrioritizeFastPath, "UNIVERSE_CACHE_SIZE", capacity)
    stacks, rng = ranked_world(node_cache_capable)
    partition = Partition()
    lists = [NAMES[:8], NAMES[4:]]
    for i in range(8):
        for verb in ("filter", "prioritize"):
            post(stacks, verb, policy_body("pol", lists[(i // 2) % 2], nodes=False), monkeypatch)
        if i == 5:
            stacks.metric("m", seeded_values(rng, NAMES))
    moved = partition.assert_equal()
    if node_cache_capable and capacity == 1:
        assert moved["pas_wire_intern_evictions_total"] > 0
    if capacity == 0:
        assert moved["pas_wire_intern_hits_total"] == moved["pas_wire_intern_misses_total"] == 0
        assert stacks.port.fastpath.wire_debug()["enabled"] is False


@MODES
def test_seeded_request_sequence(node_cache_capable, monkeypatch):
    """300 requests drawn from numpy seeds over a churning world: policy,
    verb, carrier and candidate subset (repeats make hits), with a
    refresh of a random metric every 25 requests."""
    stacks, rng = ranked_world(node_cache_capable)
    subsets = [list(rng.choice(NAMES + ["ghost"], size=int(rng.integers(1, 13)), replace=False)) for _ in range(6)]
    partition = Partition()
    for i in range(300):
        if i % 25 == 24:
            stacks.metric(str(rng.choice(["m", "s"])), seeded_values(rng, NAMES))
        body = policy_body(
            str(rng.choice(["pol", "rank", "absent"])),
            subsets[int(rng.integers(0, len(subsets)))],
            nodes=bool(rng.random() < 0.3),
            pod=f"p{int(rng.integers(0, 3))}",
        )
        post(stacks, str(rng.choice(["filter", "prioritize"])), body, monkeypatch)
    partition.assert_equal()


def test_planned_node_reaches_the_native_answer(monkeypatch):
    """The batch plan is promoted to rank 1 on the native path, in both
    carriers, as the exact path promotes it."""
    stacks, pods = planned_stacks()
    partition = Partition()
    for raw in pods:
        planned = stacks.planner.planned_node(Pod(raw))
        for nodes in (False, True):
            body = policy_body("plan-pol", ["n4", "n3", "n2", "n1"], nodes=nodes, pod=raw["metadata"]["name"])
            for _ in range(3):
                ranked = json.loads(post(stacks, "prioritize", body, monkeypatch).body)
                assert ranked[0] == {"Host": planned, "Score": 10}
    assert partition.assert_equal()["pas_prioritize_native_total"] == 18


class _Degraded:
    def __init__(self, module, prioritize, filter_):
        self._prioritize = getattr(module, prioritize)
        self._filter = getattr(module, filter_)

    def prioritize_decision(self):
        return self._prioritize, "test"

    def filter_decision(self):
        return self._filter, "test"


@pytest.mark.parametrize(
    "prioritize,filter_",
    [("ACTION_LAST_KNOWN_GOOD", "ACTION_FAIL_OPEN"), ("ACTION_NEUTRAL", "ACTION_FAIL_CLOSED")],
    ids=["last_known_good", "neutral"],
)
def test_degraded_verbs(prioritize, filter_, monkeypatch):
    """A degraded Filter skips the cache probe (a bypass); a neutral
    Prioritize never takes the native path, a last-known-good one does."""
    stacks, _rng = ranked_world()
    body = policy_body("pol", NAMES[:9], nodes=False)
    for verb in ("filter", "prioritize", "filter", "prioritize"):
        post(stacks, verb, body, monkeypatch)  # warm the caches first
    stacks.port.degraded = _Degraded(degraded, prioritize, filter_)
    stacks.jax.degraded = _Degraded(jax_degraded, prioritize, filter_)
    partition = Partition()
    for verb in ("filter", "prioritize"):
        post(stacks, verb, body, monkeypatch)
    moved = partition.assert_equal()
    assert moved["pas_filter_cache_bypass_total"] == 1
    assert moved["pas_prioritize_native_total"] == (prioritize == "ACTION_LAST_KNOWN_GOOD")


# -- stale keys ------------------------------------------------------------------


@pytest.mark.parametrize("change", ["added", "removed", "renamed", "violation"])
def test_no_stale_body_after_a_node_change(change, monkeypatch):
    """Every body is cached first (served three times, so its span is
    interned and its skeleton kept); then one refresh changes a node's
    name, presence or verdict while the Filter policy's rule rows (metric
    ``m``) stay as they were, or, for ``violation``, changes a verdict.
    Every later answer equals the exact path's on the new state: the keys
    (the violation set's and ranking's identities, the name table's, the
    policy, the span or universe) cover everything the bytes depend on."""
    stacks = Stacks()
    stacks.policy("pol", {"scheduleonmetric": [rule("s", "GreaterThan", 0)], "dontschedule": [rule("m", "GreaterThan", 50)]})
    stacks.metric("m", {"n1": 90, "n2": 10, "n3": 70})
    stacks.metric("s", {"n1": 5, "n2": 7, "n3": 9})
    bodies = [
        policy_body("pol", names, nodes=nodes)
        for names in (["n1", "n2", "n3", "n4"], ["n4", "n3", "n9", "n1"])
        for nodes in (False, True)
    ]

    def serve_all():
        return [post(stacks, verb, body, monkeypatch).body for body in bodies for verb in ("filter", "prioritize")]

    for _ in range(3):
        before = serve_all()
    fp = stacks.port.fastpath
    assert fp._filter_skeletons and fp._prioritize_skeletons and fp._filter_responses
    if change == "added":  # n4 appears, in the ranked metric only
        stacks.metric("s", {"n1": 5, "n2": 7, "n3": 9, "n4": 11})
    elif change == "removed":  # n3 leaves the ranked metric
        stacks.metric("s", {"n1": 5, "n2": 7})
    elif change == "renamed":  # n2 comes back as n9
        stacks.metric("s", {"n1": 5, "n9": 7, "n3": 9})
    else:  # n2 now violates
        stacks.metric("m", {"n1": 90, "n2": 60, "n3": 70})
    partition = Partition()
    after = serve_all()
    assert after == serve_all()  # and again, from the caches
    assert after != before
    moved = partition.assert_equal()
    assert moved["pas_filter_cache_hit_total"] > 0 and moved["pas_fastpath_response_hit_total"] > 0


def test_policies_sharing_rules_keep_their_own_reasons(monkeypatch):
    """Two policies with the same rules share one violation set; their
    FailedNodes reasons name each policy.  The port keys its Filter caches
    on the policy too, so each answer equals its exact path.  The JAX
    extender's native path keys on the set alone and serves the first
    policy's reasons to the second: a fault in the reference, kept out of
    the port."""
    stacks = Stacks()
    for name in ("pa", "pb"):
        stacks.policy(name, {"scheduleonmetric": [rule("m", "GreaterThan", 0)], "dontschedule": [rule("m", "GreaterThan", 50)]})
    stacks.metric("m", {"n1": 10, "n2": 90, "n3": 60})
    jax_answers = {}
    for name in ("pa", "pb", "pa", "pb"):
        body = policy_body(name, ["n1", "n2", "n3"], nodes=False)
        got = stacks.port.filter(HTTPRequest("POST", "/scheduler/filter", HEADERS, body))
        assert got.body == exact(stacks, "filter", body, monkeypatch).body
        assert f"policy {name}: metric m=90".encode() in got.body
        jax_answers[name] = stacks.jax.filter(JaxRequest("POST", "/scheduler/filter", HEADERS, body)).body
    with monkeypatch.context() as m:
        m.setattr(jax_ts, "get_wirec", lambda: None)
        jax_exact = stacks.jax.filter(
            JaxRequest("POST", "/scheduler/filter", HEADERS, policy_body("pb", ["n1", "n2", "n3"], nodes=False))
        ).body
    assert b"policy pb:" in jax_exact and b"policy pa:" in jax_answers["pb"]


# -- pieces ----------------------------------------------------------------------


@pytest.mark.parametrize("index", range(6))
def test_args_from_parsed_equals_jax(index):
    rng = np.random.default_rng(index)
    labels = {"telemetry-policy": "pol"} if index % 3 else {}
    names = [NAMES[i] for i in rng.integers(0, len(NAMES), size=int(rng.integers(1, 8)))]
    body = request_body(names, labels, nodes=False, namespace=["default", ""][index % 2])
    parsed, jax_parsed = native.get_wirec().parse_prioritize(body), get_jax_wirec().parse_prioritize(body)
    got = Args.from_parsed(parsed, tuple(names))
    want = JaxArgs.from_parsed(jax_parsed, tuple(names))
    assert (got.pod.raw, got.nodes, got.node_names) == (want.pod.raw, want.nodes, want.node_names)
    assert got.pod.get_labels() == Args.from_json(body).pod.get_labels()


@pytest.mark.parametrize("raw", ["", "7", "0", "-3", "x", "1"])
@pytest.mark.parametrize("which", ["_response_cache_size", "_universe_cache_size"])
def test_cache_sizes_from_the_environment(raw, which, monkeypatch):
    monkeypatch.setenv("PAS_TPU_RESPONSE_CACHE", raw)
    monkeypatch.setenv("PAS_TPU_UNIVERSE_CACHE", raw)
    assert getattr(fastpath, which)() == getattr(jax_fastpath, which)()


def test_debug_wire_serves_the_caches(monkeypatch):
    stacks, _rng = ranked_world()
    body = policy_body("pol", NAMES[:9], nodes=False)
    for _ in range(3):
        for verb in ("filter", "prioritize"):
            post(stacks, verb, body, monkeypatch)
    srv = server.Server(stacks.port)
    got = srv.route(HTTPRequest("GET", "/debug/wire", {}, b""))
    assert got.status == 200 and got.headers == HEADERS
    payload = json.loads(got.body)
    want = stacks.jax.fastpath.wire_debug()
    for key in ("enabled", "capacity", "occupancy"):
        assert payload[key] == want[key]
    assert [{k: v for k, v in u.items() if k != "uid"} for u in payload["universes"]] == [
        {k: v for k, v in u.items() if k != "uid"} for u in want["universes"]
    ]
    assert len(payload["skeletons"]["filter"]) == len(want["skeletons"]["filter"]) > 0
    assert len(payload["skeletons"]["prioritize"]) == len(want["skeletons"]["prioritize"]) > 0
    assert {e["policy"] for e in payload["skeletons"]["filter"]} <= {"pol", "rank"}
    assert srv.route(HTTPRequest("POST", "/debug/wire", {}, b"")).status == 405


def test_native_filter_records_its_decision(monkeypatch):
    stacks, _rng = ranked_world()
    body = policy_body("pol", NAMES[:9], nodes=False, pod="rec")
    for _ in range(3):
        post(stacks, "filter", body, monkeypatch)
    records = json.loads(decisions.DECISIONS.to_json(pod="rec", verb="filter", limit=8))["records"]
    assert {r["path"] for r in records} >= {"native", "cache_hit"}


def test_warm_pairs_ranks_without_pruning():
    """``warm_pairs`` ranks (row, op) pairs against a view that is not the
    mirror's current one (the refresh pruned its rankings), as the JAX
    fastpath's does, and leaves the current state's rankings in place."""
    stacks, rng = ranked_world()
    fp, jax_fp = stacks.port.fastpath, stacks.jax.fastpath
    old, jax_old = stacks.port.mirror.device_view(), stacks.jax.mirror.device_view()
    compiled = stacks.port.mirror.policy("default", "rank")
    pair = (compiled.scheduleonmetric_row, compiled.scheduleonmetric_op)
    stacks.metric("s", seeded_values(rng, NAMES))  # a refresh prunes the old view's ranking
    key, jax_key = (old.row_version(pair[0]), *pair), (jax_old.row_version(pair[0]), *pair)
    assert key not in fp._rank and jax_key not in jax_fp._rank
    current = dict(fp._rank)
    fp.warm_pairs(old, [pair])
    jax_fp.warm_pairs(jax_old, [pair])
    np.testing.assert_array_equal(fp._rank[key], jax_fp._rank[jax_key])
    assert all(k in fp._rank for k in current)


def test_rankings_handed_to_the_encoders_are_contiguous_int64(monkeypatch):
    """The wire encoders read a ranking as a raw buffer: every cached
    ranking is a C-contiguous int64 array that owns its data."""
    stacks, _rng = ranked_world()
    post(stacks, "prioritize", policy_body("pol", NAMES, nodes=False), monkeypatch)
    assert stacks.port.fastpath._rank
    for ranked in stacks.port.fastpath._rank.values():
        assert ranked.dtype == np.int64 and ranked.flags["C_CONTIGUOUS"] and ranked.flags["OWNDATA"]
