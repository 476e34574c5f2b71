"""TAS scheduling logic: the Prioritize/Filter/Bind verbs over policy rules.

The port's counterpart of
``platform_aware_scheduling_tpu/tas/telemetryscheduler.py``.  Wire
behaviour is reproduced quirk for quirk, as the JAX package does after
the reference:

  * decode failures and empty node lists return an empty 200 body;
  * a pod without the ``telemetry-policy`` label gets status 400 but the
    handler still answers, with ``[]``;
  * a nil filter result is 404 with body ``null``;
  * FailedNodes values carry the concrete violation reason ("policy P:
    metric cpu=93 > threshold 80"), byte-identical on both paths;
  * in the legacy Nodes branch FilterResult.NodeNames is built by
    splitting "n1 n2 " on spaces and so carries a trailing empty string;
    the nodeCacheCapable branch emits exactly the passing names;
  * Bind is 404 — TAS does not bind.

Two execution paths give identical wire bytes:

  * **device path**: ``ops/scoring.py`` on the mirror's device, through
    ``tas/fastpath.py`` (rankings and violation sets warmed off the
    request path);
  * **host path**: exact-semantics Python (``tas/strategies``), for
    policies and metrics the mirror marks host-only, with no mirror at
    all, and as the control in tests.

In front of both sits the native wire path, as in the JAX extender: with
a mirror and the ``_wirec_torch`` extension (``native/``), Prioritize is
scanned and encoded in C (``path`` ``native``, or ``native_host`` for a
host-only policy; ``pas_prioritize_{native,native_host,exact}_total``
partition the requests), and Filter is answered from the response cache
or encoded in C (``pas_filter_cache_{hit,miss,bypass}_total`` partition
them; a Nodes-mode miss builds its body on the exact flow and stores it).
A body the scanner rejects, and every request while
``PAS_TPU_NO_NATIVE=1`` or without a compiler, takes the exact flow, with
the same bytes.

The verbs keep the reference's contract that they never fail: device
trouble falls back to the host path.  The fallback is never silent: each
verb's span carries ``path`` (``device`` or ``host``), and a fallback
counts on ``pas_prioritize_host_fallback_total`` or
``pas_filter_host_fallback_total``; a warm pass that raises clears the
``kernels_warmed`` readiness condition until one succeeds.

With a degraded-mode controller attached (``degraded``), the verbs
degrade as the JAX extender's do while telemetry is stale or a circuit is
open: Prioritize serves last-known-good scores (its span tagged
``degraded``) and then neutral ones, every candidate scored 0; Filter
fails open or closed per ``--degradedMode``.  With a forecaster attached
(``forecaster``, ``--forecast=on``), scheduleonmetric ranks on the
predicted values of the forecaster's view, on the native, device and host
paths alike (span ``ranking`` ``forecast``), and decision records carry
the prediction's provenance.  A leader elector
(``leadership``) adds its ``/readyz`` condition and ``/debug/leader``;
every replica serves the verbs alike.

The JAX extender's other optional planes (shards, admission, gangs,
SLOs, control, flight recorder, solve observatory, rebalancer)
are not ported yet; with them unset the JAX verbs answer with the same
bytes as this module.  One difference is kept on purpose: the Filter
response cache keys on the policy's name beside its violation set, since
two policies with the same rules share the set but not the reasons.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest, HTTPResponse
from platform_aware_scheduling_tpu_torch.extender.types import (
    Args,
    BindingArgs,
    FilterResult,
    HostPriority,
    encode_host_priority_list,
)
from platform_aware_scheduling_tpu_torch.kube.objects import Node, Pod
from platform_aware_scheduling_tpu_torch.native import get_wirec
from platform_aware_scheduling_tpu_torch.ops.state import (
    CompiledPolicy,
    DeviceView,
    TensorStateMirror,
)
from platform_aware_scheduling_tpu_torch.tas import degraded as degraded_mode
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache, CacheMissError
from platform_aware_scheduling_tpu_torch.tas.fastpath import PrioritizeFastPath
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy, TASPolicyRule
from platform_aware_scheduling_tpu_torch.tas.strategies import core, dontschedule
from platform_aware_scheduling_tpu_torch.utils import decisions, events, klog, trace
from platform_aware_scheduling_tpu_torch.utils.tracing import LatencyRecorder

TAS_POLICY_LABEL = "telemetry-policy"


class _HostArgsShortcut:
    """Probe result for a host-only-policy Filter whose candidate span is
    interned: the exact flow runs on these Args, built from the wire view
    and the universe's name tuple, instead of decoding the body again.
    The Args hold every field the Filter path reads, so the bytes are the
    exact path's."""

    __slots__ = ("args",)

    def __init__(self, args: Args):
        self.args = args


class MetricsExtender:
    """extender.Scheduler implementation for TAS."""

    def __init__(
        self,
        cache: AutoUpdatingCache,
        mirror: Optional[TensorStateMirror] = None,
        planner=None,
        node_cache_capable: bool = False,
    ):
        """``mirror``: the tensor mirror whose device runs the scoring;
        None serves every request on the host path.  ``planner``: an
        optional ``tas.planner.BatchPlanner`` whose plan Prioritize
        promotes to rank 1.  ``node_cache_capable``: serve Prioritize and
        Filter from ``Args.NodeNames`` when ``Args.Nodes`` is absent (the
        ``nodeCacheCapable: true`` registration); off, such a body gets
        the reference's empty-200 quirk."""
        self.cache = cache
        self.mirror = mirror
        self.node_cache_capable = node_cache_capable
        self.recorder = LatencyRecorder()
        self.planner = planner
        # the tas.degraded.DegradedModeController, set by assembly: while
        # telemetry is stale or a circuit is open, Filter fails open or
        # closed and Prioritize serves last-known-good, then neutral,
        # scores.  None keeps the exact behaviour
        self.degraded = None
        # the kube.lease.LeaseElector under --leaderElect: its role shows
        # on /readyz and /debug/leader; the verbs do not depend on it
        self.leadership = None
        # the forecast.Forecaster under --forecast=on, set by assembly:
        # scheduleonmetric ranks on predicted-at-bind values through the
        # same fastpath and host machinery (the forecaster publishes a
        # DeviceView of predicted milli values), decision records carry
        # "predicted cpu=93 (slope +2.1/s)", and /debug/forecast is served.
        # None keeps snapshot ranking byte for byte
        self.forecaster = None
        # request-independent ranking/violation caches + byte encoder
        self.fastpath = PrioritizeFastPath() if mirror is not None else None
        # /readyz "kernels_warmed": whether the latest warm pass completed
        self._warmed = False
        if mirror is not None:
            # every mirror publish warms the fastpath in the publishing
            # (state-refresh) thread, so no request pays the device pass
            mirror.on_state_change.append(self.warm_fastpath)
            self.warm_fastpath()  # cover state written before construction

    # -- fastpath warming ------------------------------------------------------

    def warm_fastpath(self) -> None:
        """Precompute the request-time caches for the mirror's current
        state: one batched ranking of every in-use (metric row, op) pair
        whose row moved, one violation set per device-eligible policy
        whose rule rows moved, one readback, then the decoded reasons."""
        fastpath = self.fastpath
        if fastpath is None:
            return
        try:
            policies, view, host_only_map = self.mirror.policies_snapshot()

            def host_only(name: str) -> bool:
                return host_only_map.get(name, False)

            pairs = {
                (compiled.scheduleonmetric_row, compiled.scheduleonmetric_op)
                for compiled in policies.values()
                if self._prioritize_device_eligible(compiled, host_only)
            }
            filter_ok = {
                key: self._filter_device_eligible(compiled, host_only) for key, compiled in policies.items()
            }
            wirec = get_wirec()
            fastpath.precompute(view, pairs, [policies[key] for key, ok in filter_ok.items() if ok], wirec=wirec)
            for (ns, name), compiled in policies.items():
                if filter_ok[ns, name]:
                    # the violation set is warm; this decodes its reasons
                    fastpath.violation_reasons(compiled, view, name)
                # every interned universe's bodies at the new state, so the
                # first request of the period finds its body
                fastpath.warm_skeletons(
                    wirec, compiled, view, name,
                    filter_ok=filter_ok[ns, name],
                    prioritize_ok=self._prioritize_device_eligible(compiled, host_only),
                )
            if self.forecaster is not None:
                # after precompute, whose pruning keeps only the real
                # view's rankings; the forecast view's negative version
                # markers never collide with them
                self.warm_forecast_rankings()
            self._warmed = True
        except Exception as exc:  # warming must never break the writer
            self._warmed = False
            klog.error("fastpath warm failed: %s", exc)

    def warm_forecast_rankings(self) -> None:
        """Warm the ranking cache of every device-eligible policy against
        the CURRENT forecast view.  Called from :meth:`warm_fastpath` and,
        decisively, from the cache's refresh-pass hook AFTER the
        forecaster's refit (assembly registers it there): warm_fastpath
        fires mid-pass, before the refit replaces the forecast view, so
        without this pass every fresh fit would go cold to its first
        request.  Never raises."""
        fastpath = self.fastpath
        if self.forecaster is None or fastpath is None:
            return
        try:
            policies, _view, host_only_map = self.mirror.policies_snapshot()

            def host_only(name: str) -> bool:
                return host_only_map.get(name, False)

            for compiled in policies.values():
                if not self._prioritize_device_eligible(compiled, host_only):
                    continue
                fview = self._forecast_rank_view(compiled)
                if fview is not None:
                    fastpath.warm_pairs(fview, [(compiled.scheduleonmetric_row, compiled.scheduleonmetric_op)])
        except Exception as exc:  # noqa: BLE001 — warming must never break the refresher
            klog.error("forecast ranking warm failed: %s", exc)

    # -- readiness and metrics --------------------------------------------------

    def readiness_conditions(self):
        """The /readyz conditions: kernels warmed (the fastpath's warm
        pass completed) and telemetry freshness, then, when attached, the
        degraded-mode controller's and the elector's (the latter always
        ok: a follower serves at full quality)."""
        conditions = [
            ("kernels_warmed", self._warm_status),
            ("telemetry_fresh", self.cache.telemetry_freshness),
        ]
        if self.degraded is not None:
            conditions.append(("degraded_mode", self.degraded.readiness_condition))
        if self.leadership is not None:
            conditions.append(("leadership", self.leadership.readiness_condition))
        return conditions

    def _warm_status(self):
        if self.fastpath is None:
            return True, "host-only mode (no device path to warm)"
        if self._warmed:
            return True, "fastpath warmed"
        return False, "fastpath warm has not completed"

    def metrics_text(self) -> str:
        """The /metrics provider: verb latency histograms, the cache's
        refresh counters and the process-wide counters."""
        return trace.exposition(recorders=[self.recorder], counter_sets=[self.cache.counters])

    # -- verbs ----------------------------------------------------------------

    def prioritize(self, request: HTTPRequest) -> HTTPResponse:
        start = time.perf_counter()
        span = trace.of(request)
        span.set("verb", "prioritize")
        try:
            if self.degraded is not None:
                action, reason = self.degraded.prioritize_decision()
                if action == degraded_mode.ACTION_NEUTRAL:
                    # too stale even for last-known-good: every candidate
                    # scored alike keeps the scheduler unblocked without a
                    # stale ranking mis-ordering placements
                    span.set("degraded", reason)
                    span.set("path", "neutral")
                    return self._neutral_prioritize(request, span)
                if action == degraded_mode.ACTION_LAST_KNOWN_GOOD:
                    span.set("degraded", reason)  # serving retained scores
            # the native path counts itself (native or native_host)
            response = self._prioritize_native(request)
            if response is not None:
                return response
            trace.COUNTERS.inc("pas_prioritize_exact_total")
            span.set("path", "exact")
            klog.v(2).info_s("Received prioritize request", component="extender")
            decoded = self._decode_prioritize_args(request, span)
            if isinstance(decoded, HTTPResponse):
                return decoded
            args, names, status = decoded
            pod_key = f"{args.pod.namespace}/{args.pod.name}"
            span.set("pod", pod_key)
            body = self._prioritize_body(args, names, span=span)
            events.JOURNAL.publish(
                "verdict",
                "prioritize",
                request_id=span.trace_id,
                pod=pod_key,
                data={"candidates": len(names), "path": str(span.attrs.get("path", "exact"))},
            )
            return HTTPResponse.json(body, status=status)
        finally:
            self.recorder.observe("prioritize", time.perf_counter() - start, trace_id=span.trace_id)

    def _decode_prioritize_args(self, request: HTTPRequest, span):
        """The exact path's decode quirks, shared with the neutral path:
        a decode failure or an empty candidate list -> empty 200; a pod
        without the policy label -> 400, and the verb still answers.
        Returns ``(args, names, status)`` or the quirk's response."""
        with span.stage("decode"):
            args = self._decode(request)
        if args is None:
            return HTTPResponse()
        names = self._candidate_names(args)
        if not names:
            klog.v(2).info_s("bad extender arguments. No nodes in list", component="extender")
            return HTTPResponse()
        status = 200
        if TAS_POLICY_LABEL not in args.pod.get_labels():
            klog.v(2).info_s("no policy associated with pod", component="extender")
            status = 400  # and still prioritize
        return args, names, status

    def _neutral_prioritize(self, request: HTTPRequest, span) -> HTTPResponse:
        """Degraded Prioritize: every candidate scored 0.  With a mirror the
        body is joined from the fastpath's pre-rendered name fragments: the
        same bytes, without the generic encoder's object per candidate."""
        decoded = self._decode_prioritize_args(request, span)
        if isinstance(decoded, HTTPResponse):
            return decoded
        args, names, status = decoded
        with span.stage("encode"):
            if self.fastpath is not None:
                body = self.fastpath.neutral_bytes(self.mirror.device_view(), names)
            else:
                body = encode_host_priority_list([HostPriority(host=name, score=0) for name in names])
        self._record_prioritize(
            span, args.pod.namespace, args.pod.name,
            args.pod.get_labels().get(TAS_POLICY_LABEL, ""),
            "neutral", None, len(names),
        )
        return HTTPResponse.json(body, status=status)

    def filter(self, request: HTTPRequest) -> HTTPResponse:
        start = time.perf_counter()
        span = trace.of(request)
        span.set("verb", "filter")
        try:
            klog.v(2).info_s("Filter request received", component="extender")
            degraded_action = None
            if self.degraded is not None:
                action, reason = self.degraded.filter_decision()
                if action in (degraded_mode.ACTION_FAIL_OPEN, degraded_mode.ACTION_FAIL_CLOSED):
                    degraded_action = action
                    span.set("degraded", reason)
            probe = None
            if degraded_action is None:
                # a degraded answer never comes from the cache (its entries
                # were keyed on healthy state): the probe is skipped
                with span.stage("cache_probe"):
                    probe = self._filter_cache_probe(request)
            # the probe counts hit and miss where it answers or hands back
            # a key; every None (not cacheable, or trouble) is a bypass, so
            # hit + miss + bypass count each request once
            if isinstance(probe, HTTPResponse):
                return probe
            args_override = None
            if isinstance(probe, _HostArgsShortcut):
                # host-only policy over an interned span: the exact flow on
                # Args from the wire view (still a bypass: the caches cannot
                # serve host verdicts)
                args_override = probe.args
                probe = None
            if probe is None:
                span.set("filter_cache", "bypass")
                trace.COUNTERS.inc("pas_filter_cache_bypass_total")
            with span.stage("decode"):
                args = args_override if args_override is not None else self._decode(request)
            if args is None:
                return HTTPResponse()
            with span.stage("kernel"):
                result = self._filter_nodes(args, span, degraded=degraded_action)
            if result is None:
                klog.v(2).info_s("No filtered nodes returned", component="extender")
                return HTTPResponse.json(b"null\n", status=404)
            pod_key = f"{args.pod.namespace}/{args.pod.name}"
            span.set("pod", pod_key)
            with span.stage("encode"):
                body = result.to_json()
            if probe is not None:
                parsed, violations, policy_name, use_node_names, universe = probe
                self.fastpath.filter_store(
                    violations, policy_name, use_node_names, parsed, body, len(result.failed_nodes),
                    universe=universe,
                )
            path = str(span.attrs.get("filter_cache", "exact"))
            if decisions.DECISIONS.enabled:
                record_path, reason_code = path, decisions.CODE_RULE_VIOLATION
                if degraded_action == degraded_mode.ACTION_FAIL_CLOSED:
                    record_path, reason_code = "fail_closed", decisions.CODE_FAIL_CLOSED
                elif degraded_action == degraded_mode.ACTION_FAIL_OPEN:
                    record_path = "fail_open"
                decisions.DECISIONS.record_filter(
                    request_id=span.trace_id,
                    pod_namespace=args.pod.namespace,
                    pod_name=args.pod.name,
                    policy=args.pod.get_labels().get(TAS_POLICY_LABEL, ""),
                    path=record_path,
                    candidates=len(self._candidate_names(args)),
                    filtered=len(result.failed_nodes),
                    violating=dict(result.failed_nodes),
                    violating_scope="request",
                    reason_code=reason_code,
                )
            events.JOURNAL.publish(
                "verdict",
                "filter",
                request_id=span.trace_id,
                pod=pod_key,
                data={"failed": len(result.failed_nodes), "path": path},
            )
            return HTTPResponse.json(body)
        finally:
            self.recorder.observe("filter", time.perf_counter() - start, trace_id=span.trace_id)

    def _filter_cache_probe(self, request: HTTPRequest):
        """Filter response reuse: an HTTPResponse on a hit or a native
        encode; a ``(parsed, violations, policy name, use_node_names,
        universe)`` key when the request is cacheable but its body must
        come from the exact flow (Nodes mode), which stores it; a
        :class:`_HostArgsShortcut` for a host-only policy over an interned
        span; None when the request is not cacheable (no mirror, no
        extension, host-only policy, odd shapes) or on trouble.

        The key pairs the request's raw candidate span (memcmp) or interned
        universe with the identity of the policy's violation set and the
        policy's name: any change of state that moves a verdict makes a new
        set, so stale bytes never match."""
        if self.fastpath is None:
            return None
        wirec = get_wirec()
        if wirec is None:
            return None
        span = trace.of(request)
        try:
            parsed = wirec.parse_prioritize(request.body)
            use_node_names = False
            if not parsed.nodes_present or parsed.num_nodes == 0:
                if self.node_cache_capable and parsed.node_names_present and parsed.num_node_names > 0:
                    use_node_names = True
                else:
                    return None
            policy_name = parsed.policy_label
            if policy_name is None:
                return None
            try:
                policy = self.cache.read_policy(parsed.pod_namespace or "", policy_name)
            except CacheMissError:
                return None
            compiled, view = self._device_policy(policy)
            if compiled is None or not self._device_filter_ok(compiled):
                # host-only policy: the caches cannot serve a host verdict,
                # but an interned span spares the exact flow its decode
                return self._host_filter_shortcut(wirec, parsed, use_node_names, span)
            explained = self.fastpath.violation_reasons(compiled, view, policy.name)
            if explained is None:
                return None
            violations, reasons, _indexes = explained
            with span.stage("intern"):
                universe = self.fastpath.universe_probe(wirec, parsed, use_node_names)
            candidates = parsed.num_node_names if use_node_names else parsed.num_nodes
            cached = self.fastpath.filter_lookup(violations, policy.name, use_node_names, parsed, universe=universe)
            if cached is not None:
                body, n_failed = cached
                span.set("filter_cache", "hit")
                span.set("path", "native")
                trace.COUNTERS.inc("pas_filter_cache_hit_total")
                self._record_device_filter(span, parsed, policy_name, "cache_hit", candidates, n_failed, reasons)
                return HTTPResponse.json(body)
            if use_node_names:
                # NodeNames miss: the body is built natively (row lookup,
                # verdict split and assembly in C) and seeds the cache.  The
                # miss counts only once the encode succeeded: a raise lands
                # below as a bypass, never miss and bypass both
                with span.stage("encode"):
                    body, n_failed = self.fastpath.filter_parsed(
                        wirec, compiled, view, parsed, violations, policy.name, universe=universe
                    )
                self.fastpath.filter_store(
                    violations, policy.name, use_node_names, parsed, body, n_failed, universe=universe
                )
                span.set("filter_cache", "miss")
                span.set("path", "native")
                trace.COUNTERS.inc("pas_filter_cache_miss_total")
                self._record_device_filter(span, parsed, policy_name, "native", candidates, n_failed, reasons)
                return HTTPResponse.json(body)
            # Nodes mode: the exact flow builds the body (it echoes the node
            # objects) and stores it under this key
            span.set("filter_cache", "miss")
            trace.COUNTERS.inc("pas_filter_cache_miss_total")
            return parsed, violations, policy.name, use_node_names, universe
        except (ValueError, TypeError):
            return None  # the scanner refused the body: the exact flow owns it
        except Exception as exc:  # noqa: BLE001 — device trouble must never fail the verb
            klog.error("filter cache probe failed, exact path: %s", exc)
            return None

    def _host_filter_shortcut(self, wirec, parsed, use_node_names: bool, span) -> Optional[_HostArgsShortcut]:
        """Args for a host-only-policy Filter over an interned span, or
        None (the exact decode serves).  Only NodeNames bodies qualify: a
        Nodes-mode answer echoes node objects, which the wire view does
        not keep."""
        if not use_node_names:
            return None
        with span.stage("intern"):
            universe = self.fastpath.universe_probe(wirec, parsed, use_node_names)
        if universe is None:
            return None
        return _HostArgsShortcut(Args.from_parsed(parsed, universe.names()))

    def _record_device_filter(self, span, parsed, policy_name, path, candidates, n_failed, reasons) -> None:
        """The decision record of a native Filter answer, O(1): the
        per-node detail is the shared per-state reason map."""
        if not decisions.DECISIONS.enabled:
            return
        decisions.DECISIONS.record_filter(
            request_id=span.trace_id,
            pod_namespace=parsed.pod_namespace or "",
            pod_name=parsed.pod_name or "",
            policy=policy_name,
            path=path,
            candidates=int(candidates),
            filtered=int(n_failed),
            violating=reasons,
            violating_scope="policy_state",
        )

    def bind(self, request: HTTPRequest) -> HTTPResponse:
        """TAS does not bind: always 404.  The body (kube-scheduler POSTs
        BindingArgs regardless) is outcome feedback that closes the pod's
        open decision records; with the decision log off it is not read."""
        if decisions.DECISIONS.enabled and request.body:
            try:
                args = BindingArgs.from_json(request.body)
                if args.pod_name and args.node:
                    span = trace.of(request)
                    span.set("verb", "bind")
                    span.set("pod", f"{args.pod_namespace}/{args.pod_name}")
                    span.set("node", args.node)
                    decisions.DECISIONS.observe_bind(args.pod_namespace, args.pod_name, args.node)
                    events.JOURNAL.publish(
                        "verdict",
                        "bind observed",
                        request_id=span.trace_id,
                        pod=f"{args.pod_namespace}/{args.pod_name}",
                        node=args.node,
                    )
            except Exception:
                pass  # feedback is best-effort; the verb stays a 404
        return HTTPResponse(status=404)

    # -- native wire path ------------------------------------------------------

    def _prioritize_native(self, request: HTTPRequest) -> Optional[HTTPResponse]:
        """Prioritize through the wire extension's scanner when the body
        has the usual well-formed shape; None hands it to the exact path,
        which owns every decode-failure and empty-list quirk.  A ValueError
        (decode, UTF-8, a lone surrogate the scan could not reject) or
        TypeError anywhere on the way does the same."""
        if self.fastpath is None:
            return None
        wirec = get_wirec()
        if wirec is None:
            return None
        try:
            return self._prioritize_native_inner(wirec, request)
        except (ValueError, TypeError):
            return None

    def _prioritize_native_inner(self, wirec, request: HTTPRequest) -> Optional[HTTPResponse]:
        span = trace.of(request)
        with span.stage("decode"):
            parsed = wirec.parse_prioritize(request.body)
        use_node_names = False
        if not parsed.nodes_present or parsed.num_nodes == 0:
            if self.node_cache_capable and parsed.node_names_present and parsed.num_node_names > 0:
                use_node_names = True
            else:
                return None  # the empty-200 quirks belong to the exact path
        status = 200
        policy_name = parsed.policy_label
        if policy_name is None:
            status = 400  # no label: 400, and still an (empty) answer
            trace.COUNTERS.inc("pas_prioritize_native_total")
            return HTTPResponse.json(encode_host_priority_list([]), status)
        namespace = parsed.pod_namespace or ""
        try:
            policy = self.cache.read_policy(namespace, policy_name)
        except CacheMissError:
            trace.COUNTERS.inc("pas_prioritize_native_total")
            return HTTPResponse.json(encode_host_priority_list([]), status)
        rule = self._scheduling_rule(policy)
        if rule is None:
            trace.COUNTERS.inc("pas_prioritize_native_total")
            return HTTPResponse.json(encode_host_priority_list([]), status)
        pod = Pod({"metadata": {"name": parsed.pod_name or "", "namespace": namespace}})
        pod_key = f"{namespace}/{parsed.pod_name or ''}"
        span.set("pod", pod_key)
        # the batch plan (the greedy kernel's) is promoted here, as on the
        # exact path
        planned = self.planner.planned_node(pod) if self.planner is not None else None
        compiled, view = self._device_policy(policy)
        candidates = parsed.num_node_names if use_node_names else parsed.num_nodes
        with span.stage("intern"):
            universe = self.fastpath.universe_probe(wirec, parsed, use_node_names)
        if compiled is not None and self._device_prioritize_ok(compiled):
            try:
                rank_view = self._forecast_rank_view(compiled) or view
                body = self.fastpath.prioritize_parsed(
                    wirec, compiled, rank_view, parsed, planned, use_node_names, span=span, universe=universe
                )
                span.set("path", "native")
                if rank_view is not view:
                    span.set("ranking", "forecast")
                trace.COUNTERS.inc("pas_prioritize_native_total")
                self._record_prioritize(
                    span, namespace, parsed.pod_name or "", policy_name,
                    "native", rule, int(candidates), planned, compiled=compiled, view=rank_view,
                    forecast=rank_view is not view,
                )
                events.JOURNAL.publish(
                    "verdict",
                    "prioritize",
                    request_id=span.trace_id,
                    pod=pod_key,
                    data={"candidates": int(candidates), "path": "native"},
                )
                return HTTPResponse.json(body, status)
            except Exception as exc:  # noqa: BLE001 — device trouble must never fail the verb
                trace.COUNTERS.inc("pas_prioritize_host_fallback_total")
                klog.error("native prioritize failed, host fallback: %s", exc)
        # host-only policy or metric: exact host semantics over the parsed
        # names, the universe's interned tuple when there is one
        span.set("path", "native_host")
        if universe is not None:
            names = universe.names()
        else:
            names = parsed.node_names_list() if use_node_names else parsed.node_names()
        with span.stage("kernel"):
            result = self._apply_plan(pod, self._prioritize_host(rule, names))
        with span.stage("encode"):
            body = encode_host_priority_list(result)
        # counted once the answer exists: a raise above goes to the exact
        # path, which counts itself
        trace.COUNTERS.inc("pas_prioritize_native_host_total")
        self._record_prioritize(
            span, namespace, parsed.pod_name or "", policy_name,
            "native_host", rule, int(candidates), planned, result=result,
        )
        events.JOURNAL.publish(
            "verdict",
            "prioritize",
            request_id=span.trace_id,
            pod=pod_key,
            data={"candidates": int(candidates), "path": "native_host"},
        )
        return HTTPResponse.json(body, status)

    def _record_prioritize(
        self,
        span,
        namespace: str,
        pod_name: str,
        policy_name: str,
        path: str,
        rule: Optional[TASPolicyRule],
        candidates: int,
        planned: Optional[str] = None,
        compiled: Optional[CompiledPolicy] = None,
        view: Optional[DeviceView] = None,
        result: Optional[List[HostPriority]] = None,
        forecast: bool = False,
    ) -> None:
        """One Prioritize decision record: device-path records reference
        the shared per-state score head and ranking, host-path records
        copy the top of their own result.  ``forecast`` marks a ranking
        served from predicted values: the record's detail then carries the
        forecast provenance of the top node ("predicted cpu=93 (slope
        +2.1/s)").  Never raises into the verb."""
        if not decisions.DECISIONS.enabled:
            return
        try:
            head: List = []
            ranked = None
            node_index = None
            if compiled is not None and view is not None:
                head, ranked, node_index = self.fastpath.explain_prioritize(compiled, view)
            elif result:
                head = [(hp.host, hp.score) for hp in result[:10]]
            detail = None
            if forecast and self.forecaster is not None:
                detail = {"ranking": "forecast"}
                if head and rule is not None:
                    described = self.forecaster.describe(rule.metricname, head[0][0])
                    if described:
                        detail["top"] = described
            decisions.DECISIONS.record_prioritize(
                request_id=span.trace_id,
                pod_namespace=namespace,
                pod_name=pod_name,
                policy=policy_name,
                path=path,
                candidates=candidates,
                metric=rule.metricname if rule is not None else "",
                operator=rule.operator if rule is not None else "",
                score_head=head,
                planned=planned,
                ranked=ranked,
                node_index=node_index,
                detail=detail,
            )
        except Exception as exc:  # provenance must never fail the verb
            klog.error("prioritize decision record failed: %r", exc)

    # -- decode ---------------------------------------------------------------

    def _decode(self, request: HTTPRequest) -> Optional[Args]:
        """DecodeExtenderRequest: errors — including a missing Nodes list —
        log and produce an empty 200.  With node_cache_capable, a body
        carrying only NodeNames is valid."""
        if not request.body:
            klog.v(2).info_s("request body empty", component="extender")
            return None
        try:
            args = Args.from_json(request.body)
        except Exception as exc:
            klog.v(2).info_s(f"error decoding request: {exc}", component="extender")
            return None
        if args.nodes is None:
            if self.node_cache_capable and args.node_names is not None:
                return args
            klog.v(2).info_s("no nodes in list", component="extender")
            return None
        return args

    def _candidate_names(self, args: Args) -> List[str]:
        """Nodes.items when present, else (nodeCacheCapable only) NodeNames."""
        if args.nodes:
            return [node.name for node in args.nodes]
        if self.node_cache_capable and args.node_names:
            return list(args.node_names)
        return []

    # -- prioritize logic ------------------------------------------------------

    def _prioritize_body(self, args: Args, names: List[str], span=trace.NULL_SPAN) -> bytes:
        """prioritizeNodes down to response bytes: any failure degrades to
        an empty priority list."""
        try:
            policy = self._policy_from_pod(args.pod)
        except Exception as exc:
            klog.v(2).info_s(f"get policy from pod failed: {exc}", component="extender")
            return encode_host_priority_list([])
        rule = self._scheduling_rule(policy)
        if rule is None:
            klog.v(2).info_s(
                "get scheduling rule from policy failed: no scheduling rule found",
                component="extender",
            )
            return encode_host_priority_list([])
        compiled, view = self._device_policy(policy)
        if compiled is not None and self._device_prioritize_ok(compiled):
            try:
                planned = self.planner.planned_node(args.pod) if self.planner else None
                rank_view = self._forecast_rank_view(compiled) or view
                body = self.fastpath.prioritize_bytes(compiled, rank_view, names, planned, span=span)
                span.set("path", "device")
                if rank_view is not view:
                    span.set("ranking", "forecast")
                self._record_prioritize(
                    span, args.pod.namespace, args.pod.name, policy.name,
                    "device", rule, len(names), planned, compiled=compiled, view=rank_view,
                    forecast=rank_view is not view,
                )
                return body
            except Exception as exc:  # device trouble must never fail the verb
                trace.COUNTERS.inc("pas_prioritize_host_fallback_total")
                klog.error("device prioritize failed, host fallback: %s", exc)
        span.set("path", "host")
        with span.stage("kernel"):
            result = self._apply_plan(args.pod, self._prioritize_host(rule, names))
        with span.stage("encode"):
            body = encode_host_priority_list(result)
        self._record_prioritize(
            span, args.pod.namespace, args.pod.name, policy.name,
            "host", rule, len(names), result=result,
        )
        return body

    def _apply_plan(self, pod: Pod, result: List[HostPriority]) -> List[HostPriority]:
        """Promote the batch-planned node (if any, current, and among the
        scored candidates) to rank 1; scores stay ordinal 10-i."""
        if self.planner is None or not result:
            return result
        planned = self.planner.planned_node(pod)
        if planned is None:
            return result
        hosts = [hp.host for hp in result]
        if planned not in hosts:
            return result
        reordered = [planned] + [h for h in hosts if h != planned]
        return [HostPriority(host=h, score=10 - i) for i, h in enumerate(reordered)]

    def _forecast_rank_view(self, compiled: Optional[CompiledPolicy]):
        """The forecast DeviceView to rank this policy's scheduleonmetric
        rule on, or None (snapshot ranking).  Never raises into a verb:
        forecasting trouble degrades to snapshot ranking."""
        forecaster = self.forecaster
        if forecaster is None or compiled is None:
            return None
        try:
            return forecaster.ranking_view(compiled.scheduleonmetric_metric)
        except Exception as exc:  # noqa: BLE001 — forecasting trouble must never fail the verb
            klog.error("forecast ranking view failed, snapshot serves: %s", exc)
            return None

    def _prioritize_host(self, rule: TASPolicyRule, candidate_names: List[str]) -> List[HostPriority]:
        """prioritizeNodesForRule, exact host semantics.  With a forecaster
        wired, the ranking reads the SAME predicted milli values the
        forecast view carries, so native and host rankings on forecasts
        give the same bytes; forecasting trouble falls back to the
        snapshot read.  A host-only metric never forecasts: it is host-only
        because its values are not milli-exact, and the history holds
        milli-truncated samples."""
        if self.forecaster is not None and not (
            self.mirror is not None and self.mirror.metric_host_only(rule.metricname)
        ):
            try:
                predicted = self.forecaster.host_metric(rule.metricname)
            except Exception as exc:  # noqa: BLE001 — forecasting trouble must never fail the verb
                klog.error("forecast host metric failed, snapshot serves: %s", exc)
                predicted = None
            if predicted is not None:
                filtered = {name: predicted[name] for name in candidate_names if name in predicted}
                ordered = core.ordered_list(filtered, rule.operator)
                return [HostPriority(host=entry.node_name, score=10 - i) for i, entry in enumerate(ordered)]
        try:
            node_data = self.cache.read_metric(rule.metricname)
        except CacheMissError as exc:
            klog.v(2).info_s(f"failed to prioritize: {exc}, {rule.metricname}", component="extender")
            return []
        filtered = {name: node_data[name] for name in candidate_names if name in node_data}
        ordered = core.ordered_list(filtered, rule.operator)
        return [HostPriority(host=entry.node_name, score=10 - i) for i, entry in enumerate(ordered)]

    # -- filter logic ----------------------------------------------------------

    def _filter_nodes(
        self, args: Args, span=trace.NULL_SPAN, degraded: Optional[str] = None
    ) -> Optional[FilterResult]:
        """filterNodes: the pod's policy, its dontschedule violation set,
        and the candidates split into passing and failed.  ``degraded``
        overrides only the telemetry-dependent violation set: fail_open ->
        no node violates, fail_closed -> every candidate does; the policy
        lookup (informer-fed, not telemetry) stays exact."""
        try:
            policy = self._policy_from_pod(args.pod)
        except Exception as exc:
            klog.v(2).info_s(f"get policy from pod failed {exc}", component="extender")
            return None
        strategy = self._dontschedule_strategy(policy)
        if strategy is None:
            klog.v(2).info_s(
                "Don't scheduler strategy failed no dontschedule strategy found",
                component="extender",
            )
            return None
        if degraded == degraded_mode.ACTION_FAIL_OPEN:
            violating: Dict[str, str] = {}
        elif degraded == degraded_mode.ACTION_FAIL_CLOSED:
            names = [node.name for node in args.nodes] if args.nodes else list(args.node_names or [])
            violating = {name: decisions.REASON_FAIL_CLOSED for name in names}
        else:
            violating = self._violating_nodes(policy, strategy, span)
        if not args.nodes:
            if self.node_cache_capable and args.node_names:
                return self._filter_node_names(policy, args.node_names, violating)
            klog.v(2).info_s("No nodes to compare", component="extender")
            return None
        filtered: List[Node] = []
        failed: Dict[str, str] = {}
        available = ""
        for node in args.nodes:
            if node.name in violating:
                failed[node.name] = violating[node.name]
            else:
                filtered.append(node)
                available += node.name + " "
        node_names = available.split(" ")  # trailing "" kept (see module doc)
        if available:
            klog.v(2).info_s(f"Filtered nodes for {policy.name}: {available}", component="extender")
        return FilterResult(nodes=filtered, node_names=node_names, failed_nodes=failed, error="")

    def _filter_node_names(
        self, policy: TASPolicy, names: List[str], violating: Dict[str, str]
    ) -> FilterResult:
        """nodeCacheCapable Filter: NodeNames only (Nodes stays null), and
        exactly the passing names — kube-scheduler consumes every entry."""
        failed: Dict[str, str] = {}
        node_names: List[str] = []
        for name in names:
            if name in violating:
                failed[name] = violating[name]
            else:
                node_names.append(name)
        if node_names:
            klog.v(2).info_s(
                f"Filtered nodes for {policy.name}: {' '.join(node_names)}", component="extender"
            )
        return FilterResult(nodes=None, node_names=node_names, failed_nodes=failed, error="")

    def _violating_nodes(
        self, policy: TASPolicy, strategy: dontschedule.Strategy, span=trace.NULL_SPAN
    ) -> Dict[str, str]:
        """{violating node: reason string}: decoded from the device's
        rule-index vector, or from ``violated_details`` on the host; the
        span's ``path`` says which."""
        compiled, view = self._device_policy(policy)
        if compiled is not None and self._device_filter_ok(compiled):
            try:
                explained = self.fastpath.violation_reasons(compiled, view, policy.name)
                if explained is not None:
                    span.set("path", "device")
                    return explained[1]
            except Exception as exc:  # device trouble must never fail the verb
                trace.COUNTERS.inc("pas_filter_host_fallback_total")
                klog.error("device filter failed, host fallback: %s", exc)
        span.set("path", "host")
        return {name: detail[1] for name, detail in strategy.violated_details(self.cache).items()}

    # -- shared helpers --------------------------------------------------------

    def _policy_from_pod(self, pod: Pod) -> TASPolicy:
        policy_name = pod.get_labels().get(TAS_POLICY_LABEL)
        if policy_name is None:
            raise CacheMissError(f"no policy found in pod spec for pod {pod.name}")
        return self.cache.read_policy(pod.namespace, policy_name)

    def _scheduling_rule(self, policy: TASPolicy) -> Optional[TASPolicyRule]:
        """rule[0] of scheduleonmetric, with a non-empty metric name."""
        strat = policy.strategies.get("scheduleonmetric")
        if strat and strat.rules and strat.rules[0].metricname:
            return strat.rules[0]
        return None

    def _dontschedule_strategy(self, policy: TASPolicy) -> Optional[dontschedule.Strategy]:
        strat = policy.strategies.get("dontschedule")
        if strat is None or not strat.rules:
            return None
        return dontschedule.Strategy.from_policy_strategy(strat)

    # -- device-path eligibility ----------------------------------------------

    def _device_policy(self, policy: TASPolicy):
        """Atomic (compiled, view) snapshot, or (None, None) host-only."""
        if self.mirror is None:
            return None, None
        return self.mirror.policy_with_view(policy.namespace, policy.name)

    # one source of truth for "can the device serve this policy", shared by
    # the request path (live mirror lookup) and the warm pass (a snapshot)

    @staticmethod
    def _prioritize_device_eligible(compiled: CompiledPolicy, host_only) -> bool:
        return compiled.scheduleonmetric_row >= 0 and not host_only(compiled.scheduleonmetric_metric)

    @staticmethod
    def _filter_device_eligible(compiled: CompiledPolicy, host_only) -> bool:
        rules = compiled.dontschedule
        if rules is None or rules.host_only or not rules.active.any():
            return False
        return not any(host_only(name) for name in rules.metric_names)

    def _device_prioritize_ok(self, compiled: CompiledPolicy) -> bool:
        return self._prioritize_device_eligible(compiled, self.mirror.metric_host_only)

    def _device_filter_ok(self, compiled: CompiledPolicy) -> bool:
        return self._filter_device_eligible(compiled, self.mirror.metric_host_only)
