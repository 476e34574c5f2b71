"""GAS scheduling logic: Filter (the per-card fit check) and Bind (card
assignment, annotation and bind).

The port's copy of ``platform_aware_scheduling_tpu/gas/scheduler.py``.
Reference: gpu-aware-scheduling/pkg/gpuscheduler/scheduler.go.  Behaviours
kept:

  * Filter needs ``NodeNames`` (nodeCacheCapable mode, :455-461) and
    answers 404 with an Error result otherwise;
  * cards are chosen first-fit over sorted card names, the request divided
    per GPU by its ``i915`` count (:200-257, 180-198); a card with room for
    several shares may be picked more than once for one container;
  * usage on a card gone from the node's label is tolerated and skipped
    (:230-234);
  * Bind re-runs the logic on the chosen node, books, annotates the pod
    (``gas-ts`` and ``gas-container-cards``) with a 5-attempt conflict
    retry and backoff, binds, and rolls the booking back on any later
    failure (:385-445, 82-119);
  * Prioritize answers 404 (:515-519).

Filter runs the fit check of every candidate node as ONE bin-pack
(``gas/device.py`` → ``ops/binpack.py``, the CUDA kernel on the card) in
place of the reference's loop over nodes.  The host loop stays as the exact
control and, as in the JAX package, answers a request whose nodes staging
cannot read (logged, counted in ``pas_gas_filter_host_total``).  A failure
of the device itself (a kernel that does not build or launch, a shape it
refuses) is an error answer, counted in
``pas_gas_filter_device_error_total``: the host loop never stands in for
the card.  The JAX extender's admission,
SLO, budget-control and flight-recorder attachments are not ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from itertools import compress
from typing import Dict, List, Optional, Tuple

from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest, HTTPResponse
from platform_aware_scheduling_tpu_torch.extender.types import (
    Args,
    BindingArgs,
    BindingResult,
    FilterResult,
)
from platform_aware_scheduling_tpu_torch.gas.cache import ADD, REMOVE, Cache
from platform_aware_scheduling_tpu_torch.gas.resource_map import NodeResources, ResourceMap
from platform_aware_scheduling_tpu_torch.gas.utils import (
    CARD_ANNOTATION,
    GPU_LIST_LABEL,
    GPU_PLUGIN_RESOURCE,
    RESOURCE_PREFIX,
    TS_ANNOTATION,
    container_requests,
)
from platform_aware_scheduling_tpu_torch.kube.client import ConflictError
from platform_aware_scheduling_tpu_torch.kube.objects import Node, Pod
from platform_aware_scheduling_tpu_torch.kube.retry import RetryPolicy
from platform_aware_scheduling_tpu_torch.utils import decisions, events, klog, trace
from platform_aware_scheduling_tpu_torch.utils.device import DeviceLike
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity
from platform_aware_scheduling_tpu_torch.utils.tracing import LatencyRecorder

UPDATE_RETRY_COUNT = 5  # scheduler.go:28


class WontFitError(Exception):
    """will not fit (scheduler.go:49)"""


class NoGPUsError(WontFitError):
    """The node has no GPUs (vanished or never labelled): its own reason
    class, so the host loop and the device bin-pack give it the same code."""


class StagingError(ValueError):
    """A node that the staged bin-pack cannot read (a malformed capacity),
    raised before any device work: the host loop then gives each node its
    typed verdict, as in the JAX package.  Every other error of the device
    path is the device's own and is never answered from the host."""


def request_summary(pod: Pod) -> str:
    """"res=total, ..." of the pod's GPU request: the detail of the GAS
    capacity reason, the same on the device and host paths."""
    totals: Dict[str, int] = {}
    for req in container_requests(pod):
        for name, value in req.items():
            totals[name] = totals.get(name, 0) + value
    return ", ".join(f"{k}={v}" for k, v in sorted(totals.items()))


class GASExtender:
    """extender.Scheduler implementation for GAS (scheduler.go:58-71).

    ``use_device`` puts Filter's fit check on a :class:`DeviceBinpacker`
    over the cache, through a persistent usage mirror when ``use_mirror``;
    ``device`` is where it runs, ``"cuda"`` unless the caller asks for
    another (with no GPU present that default raises)."""

    def __init__(
        self,
        kube_client,
        cache: Optional[Cache] = None,
        recorder: Optional[LatencyRecorder] = None,
        use_device: bool = True,
        use_mirror: bool = True,
        retry_policy: Optional[RetryPolicy] = None,
        sleep=time.sleep,
        device: DeviceLike = None,
    ):
        self.kube_client = kube_client
        # backoff between annotate conflict retries (the reference retried
        # with no sleep, hammering the API server while it reported
        # contention); deterministic jitter, injectable sleep
        self.retry_policy = (
            retry_policy
            if retry_policy is not None
            else RetryPolicy(max_attempts=UPDATE_RETRY_COUNT, base_delay_s=0.05, max_delay_s=1.0)
        )
        self._sleep = sleep
        self.cache = cache if cache is not None else Cache(kube_client)
        self.recorder = recorder or LatencyRecorder()
        # the work queue's work-latency histogram joins this extender's
        # pas_request_duration_seconds family (verb="workqueue_work")
        self.cache.work_queue.recorder = self.recorder
        self._rwmutex = threading.RLock()
        self._device = None
        if use_device:
            # deferred: gas/device.py imports this module's helpers
            from platform_aware_scheduling_tpu_torch.gas.device import DeviceBinpacker

            self._device = DeviceBinpacker(self.cache, use_mirror=use_mirror, device=device)

    # -- verbs -----------------------------------------------------------------

    def metrics_text(self) -> str:
        """The /metrics provider for this extender (utils/trace.py)."""
        return trace.exposition(recorders=[self.recorder])

    def readiness_conditions(self):
        """The /readyz conditions of GAS: node and pod informers synced,
        since it serves from its resource cache and answering before the
        initial lists land would bind against a fictional cluster."""
        return [("informers_synced", self.cache.synced_condition)]

    def prioritize(self, request: HTTPRequest) -> HTTPResponse:
        # not implemented by GAS (scheduler.go:515-519)
        return HTTPResponse(status=404)

    def filter(self, request: HTTPRequest) -> HTTPResponse:
        start = time.perf_counter()
        span = trace.of(request)
        span.set("verb", "gas_filter")
        try:
            klog.v(4).info_s("filter request received", component="extender")
            try:
                with span.stage("decode"):
                    args = Args.from_json(request.body) if request.body else None
            except Exception as exc:
                args = None
                klog.error("cannot decode request %s", exc)
            if args is None:
                return HTTPResponse(status=404)
            with span.stage("kernel"):
                result = self._filter_nodes(args, span=span)
            span.set("pod", f"{args.pod.namespace}/{args.pod.name}")
            status = 404 if result.error else 200
            with span.stage("encode"):
                body = result.to_json()
            events.JOURNAL.publish(
                "verdict",
                "gas_filter",
                request_id=span.trace_id,
                pod=f"{args.pod.namespace}/{args.pod.name}",
                data={"failed": len(result.failed_nodes), "path": str(span.attrs.get("path", ""))},
            )
            return HTTPResponse.json(body, status=status)
        finally:
            self.recorder.observe("gas_filter", time.perf_counter() - start, trace_id=span.trace_id)

    def bind(self, request: HTTPRequest) -> HTTPResponse:
        start = time.perf_counter()
        span = trace.of(request)
        span.set("verb", "gas_bind")
        try:
            klog.v(4).info_s("bind request received", component="extender")
            try:
                with span.stage("decode"):
                    args = BindingArgs.from_json(request.body) if request.body else None
            except Exception as exc:
                args = None
                klog.error("cannot decode request %s", exc)
            if args is None:
                return HTTPResponse(status=404)
            with span.stage("kernel"):
                result = self._bind_node(args)
            status = 404 if result.error else 200
            with span.stage("encode"):
                body = result.to_json()
            events.JOURNAL.publish(
                "verdict",
                "gas_bind",
                request_id=span.trace_id,
                pod=f"{args.pod_namespace}/{args.pod_name}",
                node=args.node,
                data={"status": status},
            )
            return HTTPResponse.json(body, status=status)
        finally:
            self.recorder.observe("gas_bind", time.perf_counter() - start, trace_id=span.trace_id)

    # -- filter (scheduler.go:447-482) -----------------------------------------

    def _filter_nodes(self, args: Args, span=trace.NULL_SPAN) -> FilterResult:
        if not args.node_names:
            error = (
                "No nodes to compare. This should not happen, perhaps the "
                "extender is misconfigured with NodeCacheCapable == false."
            )
            klog.error(error)
            return FilterResult(error=error)
        summary = request_summary(args.pod)
        with self._rwmutex:
            if self._device is not None:
                try:
                    res = self._device.batch_fit(args.pod, args.node_names, with_reasons=True)
                except StagingError as exc:
                    klog.error("device binpack cannot stage a node, host fallback: %s", exc)
                    res = None
                except Exception as exc:
                    klog.error("device binpack failed: %s", exc)
                    span.set("path", "device")
                    trace.COUNTERS.inc("pas_gas_filter_device_error_total")
                    return FilterResult(error=f"device binpack failed: {exc}")
                if res is not None:
                    fits, codes = res
                    span.set("path", "device")
                    trace.COUNTERS.inc("pas_gas_filter_device_total")
                    node_names = list(compress(args.node_names, fits))
                    failing = [not ok for ok in fits]
                    reasons = {code: decisions.gas_reason(code, summary) for code in set(codes)}
                    failed = dict(
                        zip(compress(args.node_names, failing), map(reasons.__getitem__, compress(codes, failing)))
                    )
                    self._record_filter_decision(span, args.pod, args.node_names, failed, codes)
                    return FilterResult(node_names=node_names, failed_nodes=failed, error="")
            span.set("path", "host")
            trace.COUNTERS.inc("pas_gas_filter_host_total")
            node_names: List[str] = []
            failed: Dict[str, str] = {}
            codes: List[int] = []
            for node_name in args.node_names:
                code = decisions.CODE_ELIGIBLE
                try:
                    self._run_scheduling_logic(args.pod, node_name)
                    node_names.append(node_name)
                except NoGPUsError:
                    code = decisions.CODE_GAS_NO_GPUS
                except WontFitError:
                    code = decisions.CODE_GAS_CAPACITY
                except KeyError:
                    # cache.fetch_node's miss: the device path's unknown rows
                    code = decisions.CODE_GAS_UNKNOWN_NODE
                except Exception:
                    # anything else (a malformed capacity quantity, ...) is
                    # its own class, not a cache miss that never happened
                    code = decisions.CODE_GAS_ERROR
                if code != decisions.CODE_ELIGIBLE:
                    failed[node_name] = decisions.gas_reason(code, summary)
                codes.append(code)
            self._record_filter_decision(span, args.pod, args.node_names, failed, codes)
            return FilterResult(node_names=node_names, failed_nodes=failed, error="")

    def _record_filter_decision(self, span, pod: Pod, node_names, failed: Dict[str, str], codes) -> None:
        """One gas_filter decision record and exact per-reason-class
        filtered-node counters (utils/decisions.py)."""
        log = decisions.DECISIONS
        if not log.enabled:
            return
        reason_counts = Counter(codes)
        reason_counts.pop(decisions.CODE_ELIGIBLE, None)
        log.record_filter(
            verb="gas_filter",
            request_id=getattr(span, "trace_id", ""),
            pod_namespace=pod.namespace,
            pod_name=pod.name,
            policy="gas",
            path=str(span.attrs.get("path", "")),
            candidates=len(node_names),
            filtered=len(failed),
            violating=failed,
            violating_scope="request",
            reason_counts=reason_counts,
        )

    # -- scheduling core (scheduler.go:277-338) ---------------------------------

    def _run_scheduling_logic(self, pod: Pod, node_name: str) -> str:
        """Pick cards for every container of ``pod`` on ``node_name``;
        returns the annotation, raises if the pod won't fit.  Books nothing."""
        node = self.cache.fetch_node(node_name)
        gpus = get_node_gpu_list(node)
        if not gpus:
            klog.warning("Node %s GPUs have vanished", node_name)
            raise NoGPUsError("will not fit")
        per_gpu_capacity = get_per_gpu_resource_capacity(node, len(gpus))
        used = self.cache.get_node_resource_status(node_name)
        gpu_set = set(gpus)
        for gpu in gpus:  # empty maps for unused cards (:269-275)
            used.setdefault(gpu, ResourceMap())
        annotation_parts: List[str] = []
        for request in container_requests(pod):
            cards = self._cards_for_container_request(
                request, per_gpu_capacity, node_name, pod.name, used, gpu_set
            )
            annotation_parts.append(",".join(cards))
        return "|".join(annotation_parts)

    def _cards_for_container_request(
        self,
        container_request: ResourceMap,
        per_gpu_capacity: ResourceMap,
        node_name: str,
        pod_name: str,
        used: NodeResources,
        gpu_set,
    ) -> List[str]:
        """First-fit card pick per requested GPU (scheduler.go:200-257);
        books into ``used``, the caller's scratch copy."""
        if not container_request:
            return []
        per_gpu_request, num_i915 = get_per_gpu_resource_request(container_request)
        cards: List[str] = []
        for _ in range(num_i915):
            fitted = False
            for gpu_name in sorted(used):
                if gpu_name not in gpu_set:
                    klog.warning("node %s gpu %s has vanished", node_name, gpu_name)
                    continue
                if check_resource_capacity(per_gpu_request, per_gpu_capacity, used[gpu_name]):
                    try:
                        used[gpu_name].add_rm(per_gpu_request)
                    except Exception:
                        break
                    fitted = True
                    cards.append(gpu_name)
                    break
            if not fitted:
                klog.v(4).info_s(f"pod {pod_name} will not fit node {node_name}", component="extender")
                raise WontFitError("will not fit")
        return cards

    # -- bind (scheduler.go:385-445) --------------------------------------------

    def _bind_node(self, args: BindingArgs) -> BindingResult:
        try:
            pod = self.cache.fetch_pod(args.pod_namespace, args.pod_name)
        except Exception as exc:
            klog.warning("Pod %s couldn't be read or pod vanished", args.pod_name)
            return BindingResult(error=str(exc))
        with self._rwmutex:
            resources_adjusted = False
            annotation = ""
            try:
                annotation = self._run_scheduling_logic(pod, args.node)
                self.cache.adjust_pod_resources_locked(pod, ADD, annotation, args.node)
                resources_adjusted = True
                self._annotate_pod_bind(annotation, pod)
                self.kube_client.bind_pod(args.pod_namespace, args.pod_name, args.pod_uid, args.node)
                # the bind closes this pod's open gas_filter decision records
                decisions.DECISIONS.observe_bind(args.pod_namespace, args.pod_name, args.node)
                return BindingResult()
            except Exception as exc:
                klog.error("binding failed: %s", exc)
                if resources_adjusted:
                    # roll the booking back (scheduler.go:404-414)
                    try:
                        self.cache.adjust_pod_resources_locked(pod, REMOVE, annotation, args.node)
                    except Exception as rollback_exc:
                        klog.error("rollback failed: %s", rollback_exc)
                return BindingResult(error=str(exc))

    def _annotate_pod_bind(self, annotation: str, pod: Pod) -> None:
        """Write gas-ts and gas-container-cards with a conflict-retry loop
        (scheduler.go:82-119)."""
        pod_copy = pod.deep_copy()
        ts = str(time.time_ns())  # the wall-clock annotation of scheduler.go
        last_exc: Optional[Exception] = None
        for attempt in range(UPDATE_RETRY_COUNT):
            pod_copy.annotations[TS_ANNOTATION] = ts
            pod_copy.annotations[CARD_ANNOTATION] = annotation
            try:
                self.kube_client.update_pod(pod_copy)
                klog.v(2).info_s(f"Annotated pod {pod.name} with annotation {annotation}", component="extender")
                return
            except ConflictError as exc:
                last_exc = exc
                try:
                    pod_copy = self.kube_client.get_pod(pod_copy.namespace, pod_copy.name)
                except Exception:
                    klog.error("pod refresh failed")
                    break
                klog.error("pod update failed, retrying with refreshed pod")
                # a 409 means write contention on this object: back off
                # before re-applying
                if attempt + 1 < UPDATE_RETRY_COUNT:
                    self._sleep(self.retry_policy.backoff(attempt + 1, verb="update_pod"))
            except Exception as exc:
                last_exc = exc
                break
        klog.error("Failed to annotate POD with container cards: %s", last_exc)
        raise last_exc if last_exc else RuntimeError("annotate failed")


# -- pure helpers (module-level like the reference) ----------------------------


def get_node_gpu_list(node: Node) -> List[str]:
    """Cards from the ``gpu.intel.com/cards`` label, "card0.card1..."
    (scheduler.go:132-148)."""
    labels = node.get_labels() if node is not None else None
    if not labels or GPU_LIST_LABEL not in labels:
        klog.error("gpulist label not found from node")
        return []
    return labels[GPU_LIST_LABEL].split(".")


def get_node_gpu_resource_capacity(node: Node) -> ResourceMap:
    """Allocatable entries under the gpu.intel.com/ prefix
    (scheduler.go:150-162)."""
    capacity = ResourceMap()
    for name, raw in node.allocatable.items():
        if name.startswith(RESOURCE_PREFIX):
            value, _ok = Quantity(str(raw)).as_int64()
            capacity[name] = value
    return capacity


def get_per_gpu_resource_capacity(node: Node, gpu_count: int) -> ResourceMap:
    """Node capacity divided evenly across cards, the homogeneous-GPU
    assumption (scheduler.go:164-178)."""
    if gpu_count == 0:
        return ResourceMap()
    per_gpu = get_node_gpu_resource_capacity(node).new_copy()
    per_gpu.divide(gpu_count)
    return per_gpu


def get_num_i915(container_request: ResourceMap) -> int:
    """(scheduler.go:192-198)"""
    value = container_request.get(GPU_PLUGIN_RESOURCE, 0)
    return value if value > 0 else 0


def get_per_gpu_resource_request(container_request: ResourceMap) -> Tuple[ResourceMap, int]:
    """Divide the container request evenly across its i915 count
    (scheduler.go:180-190)."""
    per_gpu = container_request.new_copy()
    num_i915 = get_num_i915(container_request)
    if num_i915 > 1:
        per_gpu.divide(num_i915)
    return per_gpu, num_i915


def check_resource_capacity(needed: ResourceMap, capacity: ResourceMap, used: ResourceMap) -> bool:
    """True when every needed resource fits under the per-card capacity
    (scheduler.go:341-383): a negative need or used fails, a missing or
    non-positive capacity fails, an int64 overflow of used + need fails."""
    int64_max = 2**63 - 1
    for name, need in needed.items():
        if need < 0:
            klog.error("negative resource request")
            return False
        cap = capacity.get(name)
        if cap is None or cap <= 0:
            klog.v(4).info_s(f" no capacity available for {name}")
            return False
        in_use = used.get(name, 0)
        if in_use < 0:
            klog.error("negative amount of resources in use")
            return False
        if in_use + need > int64_max:  # the Go wraparound check (used + need < 0)
            klog.error("resource request overflow error")
            return False
        if cap < in_use + need:
            klog.v(4).info_s(" not enough resources")
            return False
    return True
