"""Batch planner: the whole-pending-set solve wired into the service.

The port's counterpart of ``platform_aware_scheduling_tpu/tas/planner.py``.
The planner keeps the pending pods that carry the ``telemetry-policy``
label, solves the ENTIRE set each sync period with
``models/batch_scheduler.scheduling_step``, and lets the per-pod verbs
read the result through :meth:`BatchPlanner.planned_node`.  A pod that is
unknown, unplanned or planned against an older mirror version gets None,
and the caller falls back to the per-request path.

The solve runs on the mirror's device: on a GPU through the hand-written
greedy-assign kernel.  ``solver="greedy"`` is greedy in pod order, what
the sequential scheduler would decide; ``solver="sinkhorn"`` rounds a
Sinkhorn transport plan with the same greedy kernel (``ops/sinkhorn.py``).
:meth:`BatchPlanner.watch` feeds the pending set and the per-node
capacity from pod and node informers, so a pod the scheduler bound leaves
the pending set and takes its node's slot in the next solve.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from platform_aware_scheduling_tpu_torch.kube.informer import (
    DeletedFinalStateUnknown,
    Informer,
    ListWatch,
)
from platform_aware_scheduling_tpu_torch.kube.objects import Node, Pod, object_key
from platform_aware_scheduling_tpu_torch.models.batch_scheduler import (
    ClusterState,
    PendingPods,
    score_and_filter,
    scheduling_step,
)
from platform_aware_scheduling_tpu_torch.ops import sinkhorn
from platform_aware_scheduling_tpu_torch.ops.rules import RuleSet
from platform_aware_scheduling_tpu_torch.ops.state import (
    RULE_PAD,
    CompiledRuleSet,
    DeviceView,
    TensorStateMirror,
)
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
from platform_aware_scheduling_tpu_torch.utils import klog
from platform_aware_scheduling_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
    same_device,
)
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity

TAS_POLICY_LABEL = "telemetry-policy"
SOLVERS = ("greedy", "sinkhorn")
DEFAULT_NODE_CAPACITY = 110  # kubelet's default max pods per node


class _InformerGroup:
    """Stop-handle over the planner's pod and node informers."""

    def __init__(self, *informers):
        self.informers = informers

    def stop(self) -> None:
        for informer in self.informers:
            informer.stop()

    def wait_for_cache_sync(self, timeout: float = 30.0) -> bool:
        return all(i.wait_for_cache_sync(timeout) for i in self.informers)


class SolveInputs(NamedTuple):
    """One replan's problem: pod keys in solve order, the mirror snapshot
    it was built against, and the dense (state, pods) pair."""

    keys: List[str]
    view: DeviceView
    state: ClusterState
    pods: PendingPods


class BatchPlanner:
    """Maintains the batch solution over the current pending set."""

    def __init__(
        self,
        cache: AutoUpdatingCache,
        mirror: TensorStateMirror,
        node_capacity: int = DEFAULT_NODE_CAPACITY,
        solver: str = "greedy",
        device: DeviceLike = None,
    ):
        """``node_capacity`` is only the fallback for nodes whose
        allocatable pod count hasn't been observed; observed nodes use
        ``allocatable.pods - bound pods``, fed by :meth:`node_changed` and
        :meth:`pod_observed`.  ``device`` must be the mirror's device."""
        if solver not in SOLVERS:
            raise ValueError(f"solver {solver!r} is not one of {', '.join(SOLVERS)}")
        self.device = resolve_device(device)
        if not same_device(self.device, mirror.device):
            raise ValueError(
                f"planner device {self.device} differs from the mirror's {mirror.device}"
            )
        self.cache = cache
        self.mirror = mirror
        self.node_capacity = node_capacity
        self.solver = solver
        self._lock = threading.Lock()
        self._pending: Dict[str, Pod] = {}
        # pod key -> (assigned node name, mirror version it was solved at)
        self._plan: Dict[str, Tuple[str, int]] = {}
        # cluster capacity state: allocatable pods per node + bound pods
        self._cap_lock = threading.Lock()
        self._node_alloc: Dict[str, int] = {}
        self._bound_pods: Dict[str, str] = {}  # pod key -> node name
        self._bound_counts: Dict[str, int] = {}
        #: the pod and node informers once :meth:`watch` starts them
        self.feed: Optional[_InformerGroup] = None

    # -- pending-set maintenance ----------------------------------------------

    def pod_added(self, pod: Pod) -> None:
        if pod.spec_node_name or TAS_POLICY_LABEL not in pod.get_labels():
            return
        with self._lock:
            self._pending[object_key(pod)] = pod

    def pod_removed(self, pod: Pod) -> None:
        with self._lock:
            self._pending.pop(object_key(pod), None)
            self._plan.pop(object_key(pod), None)

    def pod_bound(self, pod: Pod) -> None:
        self.pod_removed(pod)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def pending_keys(self) -> List[str]:
        """The pending set's pod keys (``namespace&name``), in solve order."""
        with self._lock:
            return list(self._pending)

    # -- cluster capacity feed ---------------------------------------------------

    def node_changed(self, node, deleted: bool = False) -> None:
        """Track a node's allocatable pod slots (``status.allocatable.pods``)."""
        with self._cap_lock:
            if deleted:
                self._node_alloc.pop(node.name, None)
                return
            pods = node.allocatable.get("pods")
            if pods is None:
                self._node_alloc.pop(node.name, None)
            else:
                try:
                    alloc, _exact = Quantity(str(pods)).as_int64()
                    self._node_alloc[node.name] = int(alloc)
                except ValueError:
                    self._node_alloc.pop(node.name, None)

    def pod_observed(self, pod: Pod, deleted: bool = False) -> None:
        """Track every pod's binding so per-node remaining capacity is
        allocatable − bound (terminated pods free their slot)."""
        key = object_key(pod)
        node = pod.spec_node_name
        active = not deleted and node and pod.phase not in ("Succeeded", "Failed")
        with self._cap_lock:
            prev = self._bound_pods.pop(key, None)
            if prev is not None:
                remaining = self._bound_counts.get(prev, 1) - 1
                if remaining > 0:
                    self._bound_counts[prev] = remaining
                else:
                    self._bound_counts.pop(prev, None)
            if active:
                self._bound_pods[key] = node
                self._bound_counts[node] = self._bound_counts.get(node, 0) + 1

    def _remaining_capacity(self, view) -> np.ndarray:
        """int32 [node_capacity] remaining pod slots per interned node —
        observed nodes use allocatable − bound, unknown nodes fall back to
        the kubelet default."""
        cap = np.full(view.node_capacity, self.node_capacity, dtype=np.int64)
        with self._cap_lock:
            alloc = dict(self._node_alloc)
            counts = dict(self._bound_counts)
        for name, idx in view.node_index.items():
            if idx < cap.shape[0]:
                cap[idx] = alloc.get(name, self.node_capacity) - counts.get(name, 0)
        return np.clip(cap, 0, np.iinfo(np.int32).max).astype(np.int32)

    # -- solve ----------------------------------------------------------------

    def replan(self) -> int:
        """Solve the current pending set; returns the number of planned
        pods.  Called from the sync-period loop (and on demand in tests)."""
        inputs = self.solve_inputs()
        if inputs is None:
            with self._lock:
                self._plan = {}
            return 0
        if self.solver == "sinkhorn":
            _violating, score, eligible = score_and_filter(inputs.state, inputs.pods)
            assignment = sinkhorn.sinkhorn_assign(score, eligible, inputs.state.capacity).assignment
        else:
            assignment = scheduling_step(inputs.state, inputs.pods).assignment
        assigned = assignment.node_for_pod.cpu().numpy()
        view = inputs.view
        plan: Dict[str, Tuple[str, int]] = {}
        for i, key in enumerate(inputs.keys):
            node_idx = int(assigned[i])
            if 0 <= node_idx < len(view.node_names):
                plan[key] = (view.node_names[node_idx], view.version)
        with self._lock:
            self._plan = plan
        klog.v(4).info_s(
            f"batch plan: {len(plan)}/{len(inputs.keys)} pods assigned", component="planner"
        )
        return len(plan)

    def solve_inputs(self) -> Optional[SolveInputs]:
        """What :meth:`replan` would solve now, on the planner's device; None
        when no pending pod has a device-scorable scheduleonmetric rule."""
        with self._lock:
            pods = list(self._pending.items())
        if not pods:
            return None
        # ONE atomic snapshot: every pod's compiled rule rows must resolve
        # against the same view the solve uses
        policy_keys = {
            (pod.namespace, pod.get_labels().get(TAS_POLICY_LABEL)) for _key, pod in pods
        }
        policies, view, host_only = self.mirror.policies_with_view(list(policy_keys))
        compiled_rows: List[Tuple[str, int, int]] = []  # key, row, op
        for key, pod in pods:
            compiled = policies.get((pod.namespace, pod.get_labels().get(TAS_POLICY_LABEL)))
            if compiled is None or compiled.scheduleonmetric_row < 0:
                continue
            if compiled.scheduleonmetric_metric in host_only:
                continue
            compiled_rows.append(
                (key, compiled.scheduleonmetric_row, compiled.scheduleonmetric_op)
            )
        if not compiled_rows:
            return None
        p = len(compiled_rows)
        # dontschedule filtering happens inside scheduling_step; here every
        # known node is a candidate (kube-scheduler's own predicates
        # re-check its side)
        candidates = torch.zeros((p, view.node_capacity), dtype=torch.bool, device=self.device)
        candidates[:, : len(view.node_names)] = True
        state = ClusterState(
            metric_values=view.values,
            metric_present=view.present,
            dontschedule=self._merged_dontschedule(pods, policies),
            capacity=torch.from_numpy(self._remaining_capacity(view)).to(self.device),
        )
        batch = PendingPods(
            metric_row=torch.tensor(
                [r for _, r, _ in compiled_rows], dtype=torch.int32, device=self.device
            ),
            op_id=torch.tensor(
                [o for _, _, o in compiled_rows], dtype=torch.int32, device=self.device
            ),
            candidates=candidates,
        )
        return SolveInputs(
            keys=[key for key, _, _ in compiled_rows], view=view, state=state, pods=batch
        )

    def _merged_dontschedule(self, pods, policies) -> RuleSet:
        """Union of the pending pods' dontschedule rules (deduped), resolved
        against the compiled policies of the replan's atomic snapshot."""
        seen = set()
        rules = []
        for _key, pod in pods:
            compiled = policies.get((pod.namespace, pod.get_labels().get(TAS_POLICY_LABEL)))
            if compiled is None or compiled.dontschedule is None:
                continue
            rs = compiled.dontschedule
            if rs.host_only:
                continue
            for i in range(len(rs.metric_names)):
                sig = (int(rs.metric_rows[i]), int(rs.op_ids[i]), int(rs.targets[i]))
                if sig not in seen:
                    seen.add(sig)
                    rules.append(sig)
        pad = max(RULE_PAD, -(-len(rules) // RULE_PAD) * RULE_PAD)
        merged = CompiledRuleSet(
            metric_rows=np.zeros(pad, dtype=np.int32),
            op_ids=np.zeros(pad, dtype=np.int32),
            targets=np.zeros(pad, dtype=np.int64),
            active=np.zeros(pad, dtype=bool),
        )
        for i, (row, op, target) in enumerate(rules):
            merged.metric_rows[i] = row
            merged.op_ids[i] = op
            merged.targets[i] = target
            merged.active[i] = True
        return merged.to_device(self.device)

    # -- serving --------------------------------------------------------------

    def planned_node(self, pod: Pod) -> Optional[str]:
        """The batch-assigned node for this pod, if the plan is current
        against the mirror (otherwise None -> per-request path)."""
        with self._lock:
            entry = self._plan.get(object_key(pod))
        if entry is None:
            return None
        node, version = entry
        if version != self.mirror.version:
            return None  # cluster state moved since the solve
        return node

    # -- pending-pod feed -------------------------------------------------------

    def watch(self, kube_client, stop: Optional[threading.Event] = None) -> _InformerGroup:
        """Informers over pods (the pending set and the bound counts per
        node) and nodes (allocatable pod slots); returns a handle with
        ``.stop()`` and ``.wait_for_cache_sync()``.  ``stop``, when given,
        is the event both informers stop on (a service's own), so they see
        the service stop at once."""

        def on_event(pod: Pod) -> None:
            self.pod_observed(pod)
            if TAS_POLICY_LABEL not in pod.get_labels():
                # the label may have been removed while the pod was pending
                self.pod_removed(pod)
                return
            if pod.spec_node_name or pod.phase in ("Succeeded", "Failed"):
                self.pod_removed(pod)
            else:
                self.pod_added(pod)

        def on_delete(obj) -> None:
            if isinstance(obj, DeletedFinalStateUnknown):
                obj = obj.obj
            if isinstance(obj, Pod):
                self.pod_observed(obj, deleted=True)
                self.pod_removed(obj)

        pod_informer = Informer(
            ListWatch(
                lambda: (kube_client.list_pods(), ""),
                lambda rv: ((etype, Pod(raw)) for etype, raw in kube_client.watch_pods()),
                object_key,
            ),
            on_add=on_event,
            on_update=lambda _old, new: on_event(new),
            on_delete=on_delete,
            stop=stop,
        )

        def on_node_delete(obj) -> None:
            if isinstance(obj, DeletedFinalStateUnknown):
                obj = obj.obj
            if isinstance(obj, Node):
                self.node_changed(obj, deleted=True)

        node_informer = Informer(
            ListWatch(
                lambda: (kube_client.list_nodes(), ""),
                lambda rv: ((etype, Node(raw)) for etype, raw in kube_client.watch_nodes()),
                lambda node: node.name,
            ),
            on_add=self.node_changed,
            on_update=lambda _old, new: self.node_changed(new),
            on_delete=on_node_delete,
            stop=stop,
        )
        pod_informer.start()
        node_informer.start()
        self.feed = _InformerGroup(pod_informer, node_informer)
        return self.feed

    # -- background loop -------------------------------------------------------

    def start(self, period_seconds: float, stop: Optional[threading.Event] = None) -> threading.Event:
        """Replan every ``period_seconds`` on a daemon thread until
        ``stop`` (a new event when none is given) is set; returns the
        event.  A failed replan is logged and retried on the next tick."""
        stop = stop if stop is not None else threading.Event()

        def loop():
            while not stop.wait(period_seconds):
                try:
                    self.replan()
                except Exception as exc:  # noqa: BLE001 — the loop must keep ticking
                    klog.error("replan failed: %s", exc)

        threading.Thread(target=loop, daemon=True).start()
        return stop
