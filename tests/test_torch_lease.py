"""The port's leader election (``kube/lease.py``) and the lease verbs of
its fake API server and fault-tolerant client, held against the JAX
package's: every case of ``tests/test_lease.py`` runs on twin fakes and
FakeClocks stepped alike, and roles, fencing tokens, counters, retry
schedules, ``/debug/leader`` answers and the lease objects themselves
(as JSON) must be equal."""

import json
from types import SimpleNamespace

import pytest

from platform_aware_scheduling_tpu.extender import server as jax_server
from platform_aware_scheduling_tpu.kube import client as jax_client
from platform_aware_scheduling_tpu.kube import lease as jax_lease
from platform_aware_scheduling_tpu.kube import retry as jax_retry
from platform_aware_scheduling_tpu.testing import fake_kube as jax_fake
from platform_aware_scheduling_tpu.testing import faults as jax_faults
from platform_aware_scheduling_tpu.utils import trace as jax_trace
from platform_aware_scheduling_tpu_torch.extender import server
from platform_aware_scheduling_tpu_torch.kube import client, lease, retry
from platform_aware_scheduling_tpu_torch.testing import fake_kube, faults
from platform_aware_scheduling_tpu_torch.utils import trace

from test_torch_extender import Stacks


def package(jax: bool) -> SimpleNamespace:
    if jax:
        return SimpleNamespace(client=jax_client, lease=jax_lease, retry=jax_retry, fake=jax_fake,
                               faults=jax_faults, trace=jax_trace, server=jax_server)
    return SimpleNamespace(client=client, lease=lease, retry=retry, fake=fake_kube, faults=faults,
                           trace=trace, server=server)


SIDES = (True, False)


def both(run):
    """``run(pkg)`` on each package; the port's result, after checking it
    equals the JAX one."""
    want, got = (run(package(jax)) for jax in SIDES)
    assert got == want
    return got


def lease_obj(name="l", holder="x", rv=None, transitions=1):
    obj = {
        "apiVersion": "coordination.k8s.io/v1",
        "kind": "Lease",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"holderIdentity": holder, "leaseDurationSeconds": 10.0, "renewTime": 0.0,
                 "leaseTransitions": transitions},
    }
    if rv is not None:
        obj["metadata"]["resourceVersion"] = rv
    return obj


def faulty(pkg, fake, clock):
    """The fake behind a FaultyClient: the port's fake has no fault hook of
    its own, so both sides take their plan through the wrapper."""
    plan = pkg.faults.FaultPlan()
    return pkg.faults.FaultyClient(fake, plan, clock), plan


def elector(pkg, kube, identity, clock, **kw):
    kw.setdefault("lease_name", "l")
    return pkg.lease.LeaseElector(kube, identity, clock=clock.now, **kw)


# -- the fake's optimistic concurrency ----------------------------------------------------


class TestFakeLeaseSemantics:
    def test_get_missing_is_404(self):
        def run(pkg):
            with pytest.raises(pkg.client.NotFoundError) as err:
                pkg.fake.FakeKubeClient().get_lease("default", "nope")
            return err.value.status

        assert both(run) == 404

    def test_create_existing_is_409(self):
        def run(pkg):
            fake = pkg.fake.FakeKubeClient()
            created = fake.create_lease(lease_obj())
            with pytest.raises(pkg.client.ConflictError):
                fake.create_lease(lease_obj())
            return created

        assert both(run)["metadata"]["resourceVersion"] == "1"

    def test_update_with_stale_resource_version_is_409(self):
        def run(pkg):
            fake = pkg.fake.FakeKubeClient()
            stale_rv = fake.create_lease(lease_obj())["metadata"]["resourceVersion"]
            fresh = fake.update_lease(lease_obj(rv=stale_rv, holder="y"))
            with pytest.raises(pkg.client.ConflictError):
                fake.update_lease(lease_obj(rv=stale_rv, holder="z"))
            return fresh, fake.get_lease("default", "l")

        fresh, stored = both(run)
        assert fresh == stored and stored["spec"]["holderIdentity"] == "y"

    def test_update_missing_is_404(self):
        def run(pkg):
            with pytest.raises(pkg.client.NotFoundError):
                pkg.fake.FakeKubeClient().update_lease(lease_obj(rv="1"))
            return True

        assert both(run)

    def test_concurrent_acquirers_exactly_one_winner(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            electors = [elector(pkg, fake, f"r{i}", clock) for i in range(5)]
            outcomes = [e.tick() for e in electors]
            clock.advance(1000.0)  # the grant expires; the followers race a takeover
            winners = [e.tick() for e in electors if not e.is_leader()]
            return outcomes, winners, fake.get_lease("default", "l")

        outcomes, winners, stored = both(run)
        # the lapsed holder renews first under its old token; the rest follow
        assert sum(outcomes) == 1 and sum(winners) == 1 and stored["spec"]["holderIdentity"] == "r0"

    def test_configmap_conflict_semantics_match(self):
        def run(pkg):
            fake = pkg.fake.FakeKubeClient()
            cm = {"metadata": {"name": "j", "namespace": "default"}, "data": {"state": "{}"}}
            stale = fake.create_configmap(dict(cm))["metadata"]["resourceVersion"]
            with pytest.raises(pkg.client.ConflictError):
                fake.create_configmap(dict(cm))
            fake.update_configmap({"metadata": {"name": "j", "namespace": "default", "resourceVersion": stale},
                                   "data": {"state": "1"}})
            with pytest.raises(pkg.client.ConflictError):
                fake.update_configmap({"metadata": {"name": "j", "namespace": "default", "resourceVersion": stale},
                                       "data": {}})
            return fake.get_configmap("default", "j")

        assert both(run)["data"] == {"state": "1"}


# -- the elector ----------------------------------------------------------------------------


class TestLeaseElector:
    def test_acquire_renew_keeps_token(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            e = elector(pkg, fake, "a", clock, lease_duration_s=10.0)
            out = [(e.tick(), e.fencing_token())]
            for _ in range(5):
                clock.advance(3.0)
                out.append((e.tick(), e.fencing_token(), fake.get_lease("default", "l")))
            return out

        out = both(run)
        assert [o[:2] for o in out] == [(True, 1)] * 6

    def test_takeover_after_expiry_bumps_fencing_token(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            a = elector(pkg, fake, "a", clock, lease_duration_s=10.0)
            b = elector(pkg, fake, "b", clock, lease_duration_s=10.0)
            out = [a.tick(), b.tick()]
            clock.advance(10.0)
            out += [b.tick(), b.fencing_token(), a.is_leader(), a.fencing_token()]
            return out, fake.get_lease("default", "l"), b.status()

        out, stored, status = both(run)
        assert out == [True, False, True, 2, False, None]
        assert stored["spec"]["holderIdentity"] == "b" and status["lease"]["transitions"] == 2

    def test_local_expiry_during_api_outage(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            kube, plan = faulty(pkg, fake, clock)
            e = elector(pkg, kube, "a", clock, lease_duration_s=10.0)
            e.tick()
            plan.outage("get_lease", status=503)
            plan.outage("update_lease", status=503)
            clock.advance(5.0)
            out = [e.tick(), e.is_leader()]
            clock.advance(5.0)  # the grant lapses with no API contact
            out.append(e.is_leader())
            return out, e.status()

        out, status = both(run)
        assert out == [True, True, False] and "injected fault" in status["last_error"]

    def test_check_fencing_rejects_deposed_leader(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            a = elector(pkg, fake, "a", clock, lease_duration_s=100.0)
            b = elector(pkg, fake, "b", clock, lease_duration_s=100.0)
            out = [a.tick(), a.check_fencing()]
            # expired on the server only: a's local deadline is 100 s out
            with fake._lock:
                fake._leases[("default", "l")]["spec"]["renewTime"] = -1e9
            out += [b.tick(), a.is_leader(), a.check_fencing(), a.is_leader()]
            return out

        assert both(run) == [True, True, True, True, False, False]

    def test_check_fencing_fails_safe_on_api_error(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            kube, plan = faulty(pkg, fake, clock)
            e = elector(pkg, kube, "a", clock)
            e.tick()
            plan.outage("get_lease", status=503)
            return e.check_fencing(), e.is_leader()

        assert both(run) == (False, True)

    def test_renew_conflict_demotes(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            a = elector(pkg, fake, "a", clock, lease_duration_s=10.0)
            a.tick()
            current = fake.get_lease("default", "l")
            current["spec"]["holderIdentity"] = "b"
            current["spec"]["leaseTransitions"] = 2
            fake.update_lease(current)
            return a.tick(), a.fencing_token(), a.readiness_condition()

        assert both(run) == (False, None, (True, "follower (holder: b)"))

    def test_leader_gauge_and_transition_counter(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            counters = pkg.trace.COUNTERS
            before = counters.get("pas_leader_transitions_total")
            e = elector(pkg, fake, "gauge-rep", clock, lease_duration_s=10.0)
            e.tick()
            gauge = lambda: counters.get("pas_leader", labels={"replica": "gauge-rep"}, kind="gauge")  # noqa: E731
            out = [gauge(), counters.get("pas_leader_transitions_total") - before]
            clock.advance(20.0)  # lapses without renew: self-demotion
            out += [e.is_leader(), gauge(), counters.get("pas_leader_transitions_total") - before]
            return out

        assert both(run) == [1, 1, False, 0, 2]

    @pytest.mark.parametrize("start", [1_000.0, 1_723_456_789.123456, 0.5])
    def test_lease_spec_uses_real_api_wire_types(self, start):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock(start=start)
            e = elector(pkg, fake, "a", clock, lease_duration_s=10.0)
            e.tick()
            spec = fake.get_lease("default", "l")["spec"]
            parse, fmt = pkg.lease.parse_lease_time, pkg.lease.format_micro_time
            parsed = [parse(v) for v in (spec["renewTime"], fmt(1234.5), "2026-08-04T12:00:00Z",
                                         "2026-08-04T12:00:00.123456Z", 42, "not-a-time", None)]
            clock.advance(3.0)
            return spec, parsed, e.tick(), fake.get_lease("default", "l")

        spec, parsed, renewed, stored = both(run)
        assert isinstance(spec["leaseDurationSeconds"], int) and isinstance(spec["renewTime"], str)
        assert parsed[0] == pytest.approx(start, abs=1e-5) and parsed[1] == pytest.approx(1234.5, abs=1e-5)
        assert parsed[2] > 0 and parsed[3] > 0 and parsed[4:] == [42.0, 0.0, 0.0]
        assert renewed is True and stored["spec"]["acquireTime"] == spec["acquireTime"]

    def test_status_payload(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            e = elector(pkg, fake, "a", clock)
            e.tick()
            return e.status(), e.readiness_condition(), e.role(), e.to_json()

        status, ready, role, body = both(run)
        assert status["role"] == role == "leader" and status["fencing_token"] == 1
        assert status["lease"]["holder"] == "a" and ready == (True, "leader (fencing token 1)")
        assert json.loads(body) == status

    def test_background_loop_ticks_on_the_jittered_schedule_until_stopped(self):
        def run(pkg):
            import threading

            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            stop, slept = threading.Event(), []

            def sleep(seconds):
                slept.append(seconds)
                if len(slept) == 6:
                    stop.set()

            e = pkg.lease.LeaseElector(fake, "loop-rep", lease_name="l", lease_duration_s=9.0, clock=clock.now,
                                       sleep=sleep)
            thread = e.start(stop)
            thread.join(10)
            assert not thread.is_alive()
            return slept, e.status()["ticks"], e.is_leader()

        slept, ticks, leader = both(run)
        assert ticks == 6 and leader and all(1.5 <= s < 3.0 for s in slept)


# -- the lease verbs in the fault-tolerant client ------------------------------------------


class TestLeaseVerbRetryClassification:
    def test_verb_classes(self):
        assert (retry.READ_VERBS, retry.FENCED_WRITE_VERBS, retry.WRITE_VERBS) == (
            jax_retry.READ_VERBS, jax_retry.FENCED_WRITE_VERBS, jax_retry.WRITE_VERBS,
        )
        assert retry.FENCED_WRITE_VERBS == {"create_lease", "update_lease"}

    def test_update_lease_retries_on_deterministic_schedule(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            kube, plan = faulty(pkg, fake, clock)
            created = fake.create_lease(lease_obj())
            plan.fail("update_lease", 2, status=503)
            slept = []
            api = pkg.retry.FaultTolerantClient(
                kube,
                policy=pkg.retry.RetryPolicy(max_attempts=4, base_delay_s=0.1, max_delay_s=5.0, deadline_s=30.0, seed=11),
                breakers=pkg.retry.CircuitBreakerRegistry(clock=clock.now),
                clock=clock.now,
                sleep=lambda s: (slept.append(s), clock.advance(s)),
            )
            labels = {"verb": "update_lease", "reason": "server_error"}
            before = pkg.trace.COUNTERS.get("pas_kube_retry_total", labels=labels)
            updated = api.update_lease(lease_obj(rv=created["metadata"]["resourceVersion"], holder="y"))
            return updated, slept, pkg.trace.COUNTERS.get("pas_kube_retry_total", labels=labels) - before

        updated, slept, retries = both(run)
        assert updated["spec"]["holderIdentity"] == "y" and retries == 2
        assert slept == [retry.backoff_delay(n, 0.1, 5.0, seed=11 ^ retry.stable_hash("update_lease")) for n in (1, 2)]

    def test_conflict_is_never_retried(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            kube, plan = faulty(pkg, fake, clock)
            fake.create_lease(lease_obj())
            slept = []
            api = pkg.retry.FaultTolerantClient(
                kube, policy=pkg.retry.RetryPolicy(max_attempts=4),
                breakers=pkg.retry.CircuitBreakerRegistry(clock=clock.now), clock=clock.now, sleep=slept.append,
            )
            with pytest.raises(pkg.client.ConflictError):
                api.update_lease(lease_obj(rv="stale-rv"))
            return slept, plan.call_count("update_lease")

        assert both(run) == ([], 1)

    def test_elector_caps_lease_verb_deadlines_at_lease_duration(self):
        def run(pkg):
            clock = pkg.faults.FakeClock()
            policy = pkg.retry.RetryPolicy(deadline_s=30.0, verb_deadlines={"create_lease": 2.0})
            api = pkg.retry.FaultTolerantClient(
                pkg.fake.FakeKubeClient(), policy=policy,
                breakers=pkg.retry.CircuitBreakerRegistry(clock=clock.now), clock=clock.now, sleep=clock.sleep,
            )
            elector(pkg, api, "a", clock, lease_duration_s=10.0)
            return [policy.deadline_for(v) for v in ("get_lease", "update_lease", "create_lease", "list_nodes")]

        assert both(run) == [10.0, 10.0, 2.0, 30.0]

    def test_elector_rides_the_fault_tolerant_client(self):
        def run(pkg):
            fake, clock = pkg.fake.FakeKubeClient(), pkg.faults.FakeClock()
            kube, plan = faulty(pkg, fake, clock)
            api = pkg.retry.FaultTolerantClient(
                kube, policy=pkg.retry.RetryPolicy(max_attempts=3, base_delay_s=0.01, max_delay_s=0.1),
                breakers=pkg.retry.CircuitBreakerRegistry(clock=clock.now), clock=clock.now, sleep=clock.sleep,
            )
            e = elector(pkg, api, "a", clock, lease_duration_s=10.0)
            e.tick()
            plan.fail("update_lease", 1, status=503)
            clock.advance(3.0)
            return e.tick(), e.fencing_token(), plan.call_count("update_lease"), clock.now()

        assert both(run)[:3] == (True, 1, 2)  # the failed attempt, then the retry


# -- /debug/leader ----------------------------------------------------------------------------


def test_debug_leader_codes_and_payload():
    """Unwired: the plane-off 404, listed in the /debug index; wired: 200
    with the elector's state, equal to the JAX server's answer; a POST is
    405 either way."""
    stacks = Stacks()
    servers = (jax_server.Server(stacks.jax), server.Server(stacks.port))
    extenders = (stacks.jax, stacks.port)

    def route(method, path):
        answers = [
            srv.route(package(jax).server.HTTPRequest(method, path, {}, b"{}" if method == "POST" else b""))
            for jax, srv in zip(SIDES, servers)
        ]
        want, got = ((a.status, a.headers, a.body) for a in answers)
        assert got == want
        return got

    assert route("GET", "/debug/leader")[0] == 404
    index = servers[1].route(server.HTTPRequest("GET", "/debug", {}, b"")).body
    assert "/debug/leader" in [e["path"] for e in json.loads(index)["endpoints"]]
    for jax, ext in zip(SIDES, extenders):
        pkg = package(jax)
        ext.leadership = elector(pkg, pkg.fake.FakeKubeClient(), "r0", pkg.faults.FakeClock())
        ext.leadership.tick()
    status, headers, body = route("GET", "/debug/leader")
    snap = json.loads(body)
    assert status == 200 and headers == {"Content-Type": "application/json"}
    assert (snap["role"], snap["fencing_token"], snap["lease"]["holder"]) == ("leader", 1, "r0")
    assert body == stacks.port.leadership.to_json()
    assert route("POST", "/debug/leader")[0] == 405
    # a server built over a wired extender lists its condition last
    servers = (jax_server.Server(stacks.jax), server.Server(stacks.port))
    ready = route("GET", "/readyz")[2]
    assert [c["name"] for c in json.loads(ready)["conditions"]][-1] == "leadership"
