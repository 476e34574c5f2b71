"""Tensor mirror of the TAS cache: interning tables + dense device tensors,
updated incrementally by the cache's mutation hooks.

The port's counterpart of ``platform_aware_scheduling_tpu/ops/state.py``.
Beside the exact host cache (``tas/cache.py``) the mirror keeps interned
node-name <-> column and metric-name <-> row tables, a dense
``[metric_capacity, node_capacity]`` int64 milli-unit matrix with a
presence mask, and compiled per-policy rule arrays.  Capacities grow by
doubling, as in the JAX package, so shapes change per bucket, never per
node.

Fidelity: a value is stored as exact milli-units when the ``Quantity``
converts exactly; an inexact value marks its metric host-only, and an
unknown operator or out-of-range target marks its rule set host-only.  The
planner skips both, and the extender serves them on its exact host path,
as the JAX package does.

Every publish that changes the snapshot or the compiled-policy set runs
the ``on_state_change`` callbacks after the lock is released: the
extender's warm pass subscribes there, so the device ranking runs in the
state-refresh thread, never on a request.

:func:`build_history_tensor` stages the cache's refresh-history rings
(``tas/cache.py``) against one view's rows and columns for the forecast
fit (``ops/forecast.py``), as the JAX package's does.  The forecaster
keeps the same history on the mirror's device in a :class:`HistoryRing`
instead, which stages only the samples a refit has not seen yet.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from platform_aware_scheduling_tpu_torch.ops.rules import OP_IDS, RuleSet
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy
from platform_aware_scheduling_tpu_torch.utils import klog
from platform_aware_scheduling_tpu_torch.utils.device import DeviceLike, resolve_device

MIN_NODE_CAPACITY = 64
MIN_METRIC_CAPACITY = 8
RULE_PAD = 8

#: forecast history staging keeps each metric's values inside int32 after
#: a per-row arithmetic right shift.  The budget depends on the window
#: (see history_value_bits): the Holt recursion's per-step sums need ~2
#: bits of headroom over the value range, and the residual accumulator
#: sums up to W-1 absolute errors on top
HISTORY_VALUE_BITS = 30


def history_value_bits(window: int) -> int:
    """Max bits of staged value magnitude for ``window`` samples such that
    level/trend/error, the W-1-term residual accumulator and the band tail
    ``resid * (1 + h)`` at the clamped horizon (~2W, forecast/engine.py
    ``_steps_now``) all stay inside int32 (floored at 8 bits: milli
    precision lost past that would be worse than the overflow risk)."""
    return max(8, HISTORY_VALUE_BITS - 2 - max(int(window) - 1, 0).bit_length())


class HistoryTensor(NamedTuple):
    """Dense staging of the cache's refresh history, aligned to one
    DeviceView's ``[metric row, node column]`` universe plus a trailing
    time axis: the last ``W`` refresh samples, oldest first, right-aligned
    at ``W - 1`` (shorter series lead with invalid slots).

    Values are milli-units arithmetic-right-shifted per metric row by
    ``shift[m]`` so every sample fits int32 (the fit runs in the scaled
    domain; predictions are shifted back up on the host).  ``valid`` marks
    real samples: a node absent from a sample, a metric with fewer than W
    samples, and rows or columns outside the view stay False.  Host numpy
    arrays; the forecaster uploads them to the mirror's device."""

    values: np.ndarray  # int32 [M, N, W]: milli >> shift[m]
    valid: np.ndarray  # bool [M, N, W]
    shift: np.ndarray  # int64 [M]: per-metric de-scale amount
    last_stamp: np.ndarray  # float64 [M]: newest sample stamp (nan: none)


def build_history_tensor(
    view: "DeviceView",
    history: Dict[str, List[Tuple[float, Dict[str, int]]]],
    window: int,
) -> HistoryTensor:
    """Stage the cache's history rings into the dense ``[M, N, W]`` form
    (see :class:`HistoryTensor`) against ``view``'s interning.  Metrics or
    nodes unknown to the view are dropped: the forecast universe is
    exactly the snapshot the rankings run against."""
    metric_index = view.metric_index or {}
    node_index = view.node_index
    m_cap = view.values.shape[0]
    n_cap = view.node_capacity
    w = int(window)
    values64 = np.zeros((m_cap, n_cap, w), dtype=np.int64)
    valid = np.zeros((m_cap, n_cap, w), dtype=bool)
    last_stamp = np.full(m_cap, np.nan, dtype=np.float64)
    # a scatter per sample by fancy indexing: the column lookup is the only
    # per-node Python left
    for name, ring in history.items():
        row = metric_index.get(name)
        if row is None or row >= m_cap:
            continue
        samples = ring[-w:]
        base = w - len(samples)
        for j, (_stamp, sample) in enumerate(samples):
            if not sample:
                continue
            slot = base + j
            cols = np.fromiter(
                (node_index.get(node, -1) for node in sample), dtype=np.int64, count=len(sample)
            )
            vals = np.fromiter(sample.values(), dtype=np.int64, count=len(sample))
            keep = (cols >= 0) & (cols < n_cap)
            values64[row, cols[keep], slot] = vals[keep]
            valid[row, cols[keep], slot] = True
        if samples:
            last_stamp[row] = samples[-1][0]
    # per-metric de-scale so the largest magnitude fits the window-aware
    # bit budget
    shift = _history_shift(np.where(valid, np.abs(values64), 0).max(axis=(1, 2)), w)
    scaled = (values64 >> shift[:, None, None]).astype(np.int32)
    return HistoryTensor(values=scaled, valid=valid, shift=shift, last_stamp=last_stamp)


def _history_shift(max_abs: np.ndarray, window: int) -> np.ndarray:
    """Per-row de-scale amounts from each row's largest staged magnitude:
    :func:`build_history_tensor`'s formula."""
    bits = history_value_bits(window)
    shift = np.zeros(max_abs.shape[0], dtype=np.int64)
    over = max_abs >> np.int64(bits)
    for row in np.nonzero(over)[0]:
        shift[row] = int(max_abs[row]).bit_length() - bits
    return shift


def _continued(staged: list, samples: list, window: int) -> Optional[int]:
    """How many of ``samples``' newest are new when ``samples`` continues
    what a ring row ``staged`` (by the identity of the sample objects),
    such that the row's last ``window`` samples after appending them are
    exactly ``samples``; None when it does not (restage the row)."""
    if not staged:
        return None
    last = staged[-1]
    for j in range(len(samples) - 1, -1, -1):
        if samples[j] is last:
            kept, new = j + 1, len(samples) - j - 1
            if kept != min(len(staged), window - new):
                return None
            if any(a is not b for a, b in zip(samples[:kept], staged[len(staged) - kept :])):
                return None
            return new
    return None


class HistoryRing:
    """The cache's refresh history on the mirror's device, one ring of
    ``W`` slots per metric row, in the forecast kernel's layout.

    On the device: raw milli values ``values`` int64 ``[M_cap, W, N_cap]``,
    ``valid`` uint8 of the same shape, ``head`` int32 ``[M_cap]`` (the slot
    of each row's oldest sample; the newest is at ``head - 1``) and the
    rows' de-scale amounts ``shift_dev`` int32 ``[M_cap]``, which the fit
    applies.  On the host: the sample objects each row holds, the largest
    staged magnitude of each ``(row, slot)`` (0 included where a column of
    the slot is invalid, as :func:`build_history_tensor`'s mask has it),
    ``shift`` and ``last_stamp``.

    :meth:`stage` takes a ``cache.history_snapshot()`` and finds, by the
    identity of the sample objects, the samples each row has not staged:
    one a metric a refresh pass, so a refit looks up at most one sample's
    columns a metric, not the window's, and none when the sample lists the
    same nodes in the same order as the row's last.  They are scattered into one host buffer
    (pinned on a card), and :meth:`upload` copies it to the device in one
    asynchronous copy and writes each into its slot, clearing what the slot
    held.  A row whose ring does not continue what it staged (deleted and
    registered again, rebound, another metric on the row) is restaged
    whole; a change of ``view.intern_version``, of either capacity or of
    the window restages every row; a row no metric holds is cleared.
    :meth:`to_history_tensor` materialises the ring as
    :func:`build_history_tensor` stages the same rings.  Not thread-safe:
    the forecaster stages and fits under a lock of its own."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.values: Optional[torch.Tensor] = None
        self.valid: Optional[torch.Tensor] = None
        self.head: Optional[torch.Tensor] = None
        self.shift_dev: Optional[torch.Tensor] = None
        self.shift = np.zeros(0, dtype=np.int64)
        self.last_stamp = np.zeros(0, dtype=np.float64)
        #: live node columns of the staged view; later columns never hold
        #: a sample
        self.n_live = 0
        #: node-name lookups made and slots (new samples) staged by
        #: :meth:`stage`, since construction
        self.lookups = 0
        self.slots = 0
        self._key: Optional[Tuple[int, int, int, int]] = None
        self._head = np.zeros(0, dtype=np.int64)
        self._slot_max = np.zeros((0, 0), dtype=np.int64)
        self._staged: List[list] = []
        #: row -> (the node names of its last looked-up sample, in order,
        #: their columns, the mask of those in the view): a sample listing
        #: the same nodes in the same order (the metrics API's usual
        #: answer) takes its columns without a lookup
        self._columns: Dict[int, tuple] = {}
        self._buffer: Optional[torch.Tensor] = None
        self._copied = None  # the event after the last copy out of the buffer
        self._pending: Optional[tuple] = None

    def _reset(self, m_cap: int, n_cap: int, window: int) -> None:
        shape = (m_cap, window, n_cap)
        self.values = torch.zeros(shape, dtype=torch.int64, device=self.device)
        self.valid = torch.zeros(shape, dtype=torch.uint8, device=self.device)
        self.head = torch.zeros(m_cap, dtype=torch.int32, device=self.device)
        self.shift_dev = torch.zeros(m_cap, dtype=torch.int32, device=self.device)
        self.shift = np.zeros(m_cap, dtype=np.int64)
        self.last_stamp = np.full(m_cap, np.nan, dtype=np.float64)
        self._head = np.zeros(m_cap, dtype=np.int64)
        self._slot_max = np.zeros((m_cap, window), dtype=np.int64)
        self._staged = [[] for _ in range(m_cap)]
        self._columns = {}

    def _host_buffer(self, nbytes: int) -> torch.Tensor:
        """The staging buffer, at least ``nbytes`` long and free to write:
        the copy out of it has left (on a card it is pinned and the copy
        asynchronous)."""
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None
        if self._buffer is None or self._buffer.numel() < nbytes:
            size = max(nbytes, 2 * (0 if self._buffer is None else self._buffer.numel()))
            self._buffer = torch.empty(size, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        return self._buffer

    def _lookup(self, node_index: Dict[str, int], keys: List[str], n_cap: int):
        """The view's columns of ``keys`` that lie in it, and the mask of
        those keys (None: all of them)."""
        self.lookups += len(keys)
        try:
            cols = np.fromiter(map(node_index.__getitem__, keys), dtype=np.int64, count=len(keys))
        except KeyError:  # a node the view has not interned
            cols = np.fromiter((node_index.get(node, -1) for node in keys), dtype=np.int64, count=len(keys))
        keep = (cols >= 0) & (cols < n_cap)
        return (cols, None) if keep.all() else (cols[keep], keep)

    def stage(self, view: "DeviceView", history: Dict[str, List[Tuple[float, Dict[str, int]]]], window: int) -> None:
        """Stage ``history`` against ``view`` on the host (see the class
        note) for :meth:`upload`."""
        w = int(window)
        m_cap, n_cap = view.values.shape[0], view.node_capacity
        key = (w, m_cap, n_cap, view.intern_version)
        cleared: List[int] = []
        if key != self._key:
            self._reset(m_cap, n_cap, w)
        # until the upload has landed the host's state is ahead of the
        # device's: a stage or upload that raises leaves the ring to be
        # restaged whole
        self._key = None
        self.n_live = len(view.node_names)
        metric_index = view.metric_index or {}
        node_index = view.node_index
        appends: List[Tuple[int, int, Dict[str, int]]] = []
        held = set()
        for name, ring in history.items():
            row = metric_index.get(name)
            if row is None or row >= m_cap:
                continue
            held.add(row)
            samples = ring[-w:]
            new = _continued(self._staged[row], samples, w)
            if new is None:
                if self._staged[row]:
                    cleared.append(row)
                self._head[row] = 0
                self._slot_max[row] = 0
                new = len(samples)
            for sample in samples[len(samples) - new :]:
                slot = int(self._head[row])
                appends.append((row, slot, sample[1]))
                self._head[row] = (slot + 1) % w
            self._staged[row] = samples
            self.last_stamp[row] = samples[-1][0] if samples else np.nan
        for row in range(m_cap):
            if row not in held and self._staged[row]:
                cleared.append(row)
                self._staged[row] = []
                self._head[row] = 0
                self._slot_max[row] = 0
                self.last_stamp[row] = np.nan

        # the buffer: head, shift, then the new slots' values and valid
        # bytes (the int64 sections first, so each is aligned)
        k = len(appends)
        self.slots += k
        sizes = (8 * m_cap, 8 * m_cap, 8 * k * n_cap, k * n_cap)
        nbytes = sum(sizes)
        buffer = self._host_buffer(nbytes)[:nbytes].numpy()
        offsets = np.cumsum((0,) + sizes)
        values = buffer[offsets[2] : offsets[3]].view(np.int64).reshape(k, n_cap)
        valid = buffer[offsets[3] : offsets[4]].reshape(k, n_cap)
        values[:] = 0
        valid[:] = 0
        for i, (row, slot, sample) in enumerate(appends):
            keys = list(sample)
            columns = self._columns.get(row)
            if columns is None or columns[0] != keys:
                columns = (keys, *self._lookup(node_index, keys, n_cap))
                self._columns[row] = columns
            _keys, cols, keep = columns
            vals = np.fromiter(sample.values(), dtype=np.int64, count=len(sample))
            if keep is not None:
                vals = vals[keep]
            values[i, cols] = vals
            valid[i, cols] = 1
            largest = np.abs(vals).max() if len(vals) else np.int64(0)
            # an invalid column of the slot counts 0, as the mask does
            self._slot_max[row, slot] = largest if len(vals) == n_cap else max(largest, np.int64(0))
        self.shift = _history_shift(self._slot_max.max(axis=1), w)
        buffer[offsets[0] : offsets[1]].view(np.int64)[:] = self._head
        buffer[offsets[1] : offsets[2]].view(np.int64)[:] = self.shift
        slots = [row * w + slot for row, slot, _sample in appends]
        self._pending = (key, cleared, offsets.tolist(), slots)

    def upload(self) -> None:
        """Copy what :meth:`stage` left to the device: one asynchronous
        copy of the buffer, then the cleared rows zeroed and every new
        slot written whole, on the current stream."""
        if self._pending is None:
            return
        key, cleared, offsets, slots = self._pending
        self._pending = None
        m_cap, w, n_cap = self.values.shape
        dev = self._buffer[: offsets[-1]].to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))
        for row in cleared:
            self.values[row].zero_()
            self.valid[row].zero_()
        self.head.copy_(dev[offsets[0] : offsets[1]].view(torch.int64))
        self.shift_dev.copy_(dev[offsets[1] : offsets[2]].view(torch.int64))
        values = dev[offsets[2] : offsets[3]].view(torch.int64).view(len(slots), n_cap)
        valid = dev[offsets[3] : offsets[4]].view(len(slots), n_cap)
        # a copy a slot: one a metric a pass (the CPU's index_copy_ is far
        # slower at these widths)
        ring_values, ring_valid = self.values.view(m_cap * w, n_cap), self.valid.view(m_cap * w, n_cap)
        for i, slot in enumerate(slots):
            ring_values[slot].copy_(values[i])
            ring_valid[slot].copy_(valid[i])
        self._key = key

    def to_history_tensor(self) -> HistoryTensor:
        """The ring as :func:`build_history_tensor` stages the same rings
        against the same view: ``[M, N, W]``, right-aligned (step ``i``
        from slot ``(head[m] + i) % W``), shifted to int32, on the host."""
        m_cap, w, n_cap = self.values.shape
        order = (self.head.to(torch.int64)[:, None] + torch.arange(w, device=self.device)) % w
        index = order[:, :, None].expand(m_cap, w, n_cap)
        values = torch.gather(self.values, 1, index).permute(0, 2, 1).cpu().numpy()
        valid = torch.gather(self.valid, 1, index).permute(0, 2, 1).cpu().numpy().astype(bool)
        scaled = (values >> self.shift[:, None, None]).astype(np.int32)
        return HistoryTensor(values=scaled, valid=valid, shift=self.shift.copy(), last_stamp=self.last_stamp.copy())


def _next_capacity(current: int, needed: int) -> int:
    while current < needed:
        current *= 2
    return current


@dataclass
class CompiledRuleSet:
    """Host (numpy) staging of one strategy's rule list, padded to
    ``RULE_PAD`` multiples."""

    metric_rows: np.ndarray  # int32 [R_pad]
    op_ids: np.ndarray  # int32 [R_pad]
    targets: np.ndarray  # int64 [R_pad] milli-units
    active: np.ndarray  # bool [R_pad]
    host_only: bool = False  # unknown operator somewhere -> host fallback
    metric_names: Tuple[str, ...] = ()

    def to_device(self, device: torch.device) -> RuleSet:
        return RuleSet(
            metric_row=torch.from_numpy(self.metric_rows).to(device),
            op_id=torch.from_numpy(self.op_ids).to(device),
            target=torch.from_numpy(self.targets).to(device),
            active=torch.from_numpy(self.active).to(device),
        )


@dataclass
class CompiledPolicy:
    """Compiled view of one TASPolicy's strategies, with its rule tensors
    on ``device`` once asked for."""

    dontschedule: Optional[CompiledRuleSet] = None
    deschedule: Optional[CompiledRuleSet] = None
    # scheduleonmetric uses only Rules[0]; an unknown operator compiles to
    # op_id -1, which ranks by node index
    scheduleonmetric_row: int = -1
    scheduleonmetric_op: int = -1
    scheduleonmetric_metric: str = ""
    device: torch.device = torch.device("cpu")
    _device_cache: Dict[str, RuleSet] = field(default_factory=dict, repr=False, compare=False)

    def device_rules(self, strategy: str) -> Optional[RuleSet]:
        """The strategy's rule set on ``device`` (uploaded once), or None
        when the policy lacks it or it is host-only."""
        compiled = getattr(self, strategy, None)
        if compiled is None or compiled.host_only:
            return None
        if strategy not in self._device_cache:
            self._device_cache[strategy] = compiled.to_device(self.device)
        return self._device_cache[strategy]


class DeviceView:
    """An immutable snapshot handed to the scoring code: the int64 metric
    matrix and the presence mask on the mirror's device, plus the
    interning tables they were built against.

    Besides the global ``version`` it carries finer change counters, so
    per-version caches drop only what changed:

      * ``row_versions[r]`` moves only when metric row ``r``'s content
        changes — a ranking of (row, op) survives other rows' updates;
      * ``intern_version`` moves only when the node interning changes —
        the response-fragment table survives pure value churn.

    ``values_milli`` is a host copy of the matrix, so violation reasons
    ("metric cpu=93 > threshold 80") are formatted without a device
    readback.  ``metric_index`` (metric name -> row) lets row-aligned
    overlays, the forecast history tensor among them, be built against
    this exact snapshot; None in synthetic views built without it.
    """

    def __init__(
        self,
        values: torch.Tensor,  # int64 [M_cap, N_cap] milli-units
        present: torch.Tensor,  # bool [M_cap, N_cap]
        node_names: List[str],
        node_index: Dict[str, int],
        version: int,
        row_versions: Tuple[int, ...] = (),
        intern_version: int = 0,
        values_milli: Optional[np.ndarray] = None,
        metric_index: Optional[Dict[str, int]] = None,
    ):
        self.values = values
        self.present = present
        self.node_names = node_names
        self.node_index = node_index
        self.version = version
        self.row_versions = row_versions
        self.intern_version = intern_version
        self.values_milli = values_milli
        self.metric_index = metric_index

    def row_version(self, row: int) -> int:
        return self.row_versions[row] if row < len(self.row_versions) else 0

    @property
    def node_capacity(self) -> int:
        return self.present.shape[1]


class TensorStateMirror:
    """Subscribes to AutoUpdatingCache mutation hooks and keeps the device
    tensors in sync.  Thread-safe; reads publish copy-on-write snapshots."""

    def __init__(
        self,
        node_capacity: int = MIN_NODE_CAPACITY,
        metric_capacity: int = MIN_METRIC_CAPACITY,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._node_index: Dict[str, int] = {}
        self._node_names: List[str] = []
        self._metric_index: Dict[str, int] = {}
        self._free_metric_rows: List[int] = []
        self._values = np.zeros((metric_capacity, node_capacity), dtype=np.int64)
        self._present = np.zeros((metric_capacity, node_capacity), dtype=bool)
        # fine-grained change counters (see DeviceView)
        self._row_versions: Dict[int, int] = {}
        self._intern_version = 0
        self._host_only_metrics: Dict[str, bool] = {}
        self._policies: Dict[Tuple[str, str], CompiledPolicy] = {}
        # sources kept so policies can be recompiled when a freed metric row
        # is reused (their rule arrays hold row indices)
        self._policy_sources: Dict[Tuple[str, str], TASPolicy] = {}
        # bumped only when values/present/interning change: policy churn
        # must not force a metric-matrix re-upload
        self._version = 0
        self._view: Optional[DeviceView] = None
        # post-publish callbacks, run outside the lock (see module doc)
        self.on_state_change: List = []

    # -- wiring ---------------------------------------------------------------

    def attach(self, cache) -> None:
        """Subscribe to a tas.cache.AutoUpdatingCache's mutation hooks."""
        cache.on_metric_write.append(self.on_metric_write)
        cache.on_metric_delete.append(self.on_metric_delete)
        cache.on_policy_write.append(self.on_policy_write)
        cache.on_policy_delete.append(self.on_policy_delete)

    # -- interning ------------------------------------------------------------

    def _intern_node(self, name: str) -> int:
        col = self._node_index.get(name)
        if col is not None:
            return col
        col = len(self._node_names)
        if col >= self._values.shape[1]:
            new_cap = _next_capacity(self._values.shape[1], col + 1)
            grow = ((0, 0), (0, new_cap - self._values.shape[1]))
            self._values = np.pad(self._values, grow)
            self._present = np.pad(self._present, grow)
        self._node_index[name] = col
        self._node_names.append(name)
        self._intern_version += 1
        return col

    def _intern_metric(self, name: str) -> int:
        row = self._metric_index.get(name)
        if row is not None:
            return row
        if self._free_metric_rows:
            row = self._free_metric_rows.pop()
        else:
            row = len(self._metric_index)
            if row >= self._values.shape[0]:
                new_cap = _next_capacity(self._values.shape[0], row + 1)
                grow = ((0, new_cap - self._values.shape[0]), (0, 0))
                self._values = np.pad(self._values, grow)
                self._present = np.pad(self._present, grow)
        self._metric_index[name] = row
        self._values[row, :] = 0
        self._present[row, :] = False
        self._bump_row(row)
        return row

    def _bump_row(self, row: int) -> None:
        self._row_versions[row] = self._row_versions.get(row, 0) + 1

    # -- cache hooks ----------------------------------------------------------

    def _notify(self) -> None:
        """Run the post-publish callbacks; a failing subscriber never
        breaks the writer (the refresh loop must keep ticking)."""
        for callback in list(self.on_state_change):
            try:
                callback()
            except Exception as exc:  # noqa: BLE001 — subscriber errors are theirs
                klog.error("state-change subscriber failed: %r", exc)

    def on_metric_write(self, metric_name: str, info) -> None:
        """info: NodeMetricsInfo (node -> NodeMetric) or None (registration
        only)."""
        if self._metric_write_locked(metric_name, info):
            self._notify()

    def _metric_write_locked(self, metric_name: str, info) -> bool:
        # the fixed-point conversion runs before the lock: it is most of a
        # write's work, and readers (the deschedule evaluation, the verbs'
        # warm passes) must not queue behind it
        converted = (
            None
            if info is None
            else [(node_name, *metric.value.milli_value_exact()) for node_name, metric in info.items()]
        )
        with self._lock:
            shape_before = self._values.shape
            row = self._intern_metric(metric_name)
            if converted is None:
                if self._values.shape != shape_before:
                    self._version += 1
                    return True
                return False
            # stage the new row, then bump the version only on real change:
            # the periodic refresh rewrites every metric each sync period and
            # steady-state values must not invalidate plans
            host_only = False
            staged: Dict[int, int] = {}
            for node_name, milli, exact in converted:
                col = self._intern_node(node_name)
                if not exact:
                    host_only = True
                staged[col] = milli
            grew = self._values.shape != shape_before
            new_values = np.zeros(self._values.shape[1], dtype=np.int64)
            new_present = np.zeros(self._values.shape[1], dtype=bool)
            if staged:
                cols = np.fromiter(staged.keys(), dtype=np.int64, count=len(staged))
                new_values[cols] = np.fromiter(
                    staged.values(), dtype=np.int64, count=len(staged)
                )
                new_present[cols] = True
            self._host_only_metrics[metric_name] = host_only
            changed = (
                grew
                or not np.array_equal(self._present[row], new_present)
                or not np.array_equal(self._values[row], new_values)
            )
            if changed:
                self._values[row] = new_values
                self._present[row] = new_present
                self._version += 1
                self._bump_row(row)
            return changed

    def on_metric_delete(self, metric_name: str) -> None:
        with self._lock:
            row = self._metric_index.pop(metric_name, None)
            self._host_only_metrics.pop(metric_name, None)
            if row is None:
                return
            self._present[row, :] = False
            self._free_metric_rows.append(row)
            self._version += 1
            self._bump_row(row)
            # compiled rule arrays may reference the freed row; if it is
            # later reused for another metric they would read the wrong
            # values — recompile every policy against live rows
            for key, source in self._policy_sources.items():
                self._policies[key] = self._compile_policy(source)
        self._notify()

    def on_policy_write(self, namespace: str, name: str, policy: TASPolicy) -> None:
        with self._lock:
            shape_before = self._values.shape
            self._policy_sources[(namespace, name)] = policy
            self._policies[(namespace, name)] = self._compile_policy(policy)
            if self._values.shape != shape_before:  # a rule interned a new metric
                self._version += 1
        # fire even without a version bump: a new policy can bring (metric
        # row, op) pairs that need warming at the current version
        self._notify()

    def on_policy_delete(self, namespace: str, name: str) -> None:
        with self._lock:
            self._policies.pop((namespace, name), None)
            self._policy_sources.pop((namespace, name), None)

    # -- policy compilation ---------------------------------------------------

    def _compile_rules(self, rules) -> CompiledRuleSet:
        count = len(rules)
        pad = max(RULE_PAD, -(-count // RULE_PAD) * RULE_PAD)
        metric_rows = np.zeros(pad, dtype=np.int32)
        op_ids = np.zeros(pad, dtype=np.int32)
        targets = np.zeros(pad, dtype=np.int64)
        active = np.zeros(pad, dtype=bool)
        host_only = False
        for idx, rule in enumerate(rules):
            metric_rows[idx] = self._intern_metric(rule.metricname)
            op = OP_IDS.get(rule.operator)
            if op is None:
                host_only = True
                op = -1
            op_ids[idx] = op
            if abs(int(rule.target)) > (2**63 - 1) // 1000:
                host_only = True  # milli-domain target would overflow int64
            else:
                targets[idx] = np.int64(rule.target) * np.int64(1000)
            active[idx] = True
        return CompiledRuleSet(
            metric_rows=metric_rows,
            op_ids=op_ids,
            targets=targets,
            active=active,
            host_only=host_only,
            metric_names=tuple(rule.metricname for rule in rules),
        )

    def _compile_policy(self, policy: TASPolicy) -> CompiledPolicy:
        compiled = CompiledPolicy(device=self.device)
        strategies = policy.strategies
        if "dontschedule" in strategies:
            compiled.dontschedule = self._compile_rules(strategies["dontschedule"].rules)
        if "deschedule" in strategies:
            compiled.deschedule = self._compile_rules(strategies["deschedule"].rules)
        som = strategies.get("scheduleonmetric")
        if som is not None and som.rules and som.rules[0].metricname:
            rule = som.rules[0]
            compiled.scheduleonmetric_row = self._intern_metric(rule.metricname)
            op = OP_IDS.get(rule.operator)
            compiled.scheduleonmetric_op = -1 if op is None else op
            compiled.scheduleonmetric_metric = rule.metricname
        return compiled

    # -- reads ----------------------------------------------------------------

    def policy(self, namespace: str, name: str) -> Optional[CompiledPolicy]:
        with self._lock:
            return self._policies.get((namespace, name))

    def metric_host_only(self, metric_name: str) -> bool:
        with self._lock:
            return self._host_only_metrics.get(metric_name, False)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def device_view(self) -> DeviceView:
        """Publish (and memoize per version) the device snapshot."""
        with self._lock:
            return self._view_locked()

    def policy_with_view_by_name(
        self, name: str
    ) -> Tuple[Optional[CompiledPolicy], Optional[DeviceView]]:
        """Lookup by bare policy name: strategies registered with the
        enforcer carry only the name, not the namespace."""
        with self._lock:
            for (_ns, pname), compiled in self._policies.items():
                if pname == name:
                    return compiled, self._view_locked()
        return None, None

    def policies_with_view(
        self, keys: Sequence[Tuple[str, str]]
    ) -> Tuple[Dict[Tuple[str, str], Optional[CompiledPolicy]], DeviceView, frozenset]:
        """Atomic ({(ns, name): policy}, view, host-only metric names) for a
        whole batch under ONE lock acquisition — a per-policy loop could
        straddle a metric delete + row reuse, leaving earlier policies'
        compiled row indices pointing at a different metric in the view the
        solve uses."""
        with self._lock:
            policies = {key: self._policies.get(key) for key in keys}
            host_only = frozenset(
                name for name, flag in self._host_only_metrics.items() if flag
            )
            return policies, self._view_locked(), host_only

    def policies_snapshot(
        self,
    ) -> Tuple[Dict[Tuple[str, str], CompiledPolicy], DeviceView, Dict[str, bool]]:
        """Atomic ({(ns, name): policy}, view, host-only metric map) under
        one lock acquisition — for the warm pass, which must see a policy
        set consistent with the view it ranks against."""
        with self._lock:
            return dict(self._policies), self._view_locked(), dict(self._host_only_metrics)

    def policy_with_view(
        self, namespace: str, name: str
    ) -> Tuple[Optional[CompiledPolicy], DeviceView]:
        """Atomic (compiled policy, snapshot) pair: the policy's rule arrays
        hold metric ROW indices, so reading them and the matrix in two
        steps could straddle a metric-row reuse."""
        with self._lock:
            return self._policies.get((namespace, name)), self._view_locked()

    def _view_locked(self) -> DeviceView:
        if self._view is not None and self._view.version == self._version:
            return self._view
        # the host copy and the tensor are both read-only snapshots, so on
        # the CPU they may share memory
        values_milli = self._values.copy()
        values = torch.from_numpy(values_milli).to(self.device)
        present = torch.from_numpy(self._present.copy()).to(self.device)
        if self.device.type == "cuda":
            # the upload must have landed before any reader sees the view
            torch.cuda.current_stream(self.device).synchronize()
        rows = self._values.shape[0]
        self._view = DeviceView(
            values=values,
            present=present,
            node_names=list(self._node_names),
            node_index=dict(self._node_index),
            version=self._version,
            row_versions=tuple(self._row_versions.get(r, 0) for r in range(rows)),
            intern_version=self._intern_version,
            values_milli=values_milli,
            metric_index=dict(self._metric_index),
        )
        return self._view
