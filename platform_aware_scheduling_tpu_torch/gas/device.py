"""Device side of GAS: the persistent usage mirror and request staging for
the batched bin-pack (``ops/binpack.py``).

The port's copy of ``platform_aware_scheduling_tpu/gas/device.py``.
:class:`GASUsageMirror` subscribes to the cache's booking hook and the node
informer's events and keeps ``[nodes, cards, resources]`` usage and
capacity arrays current incrementally, so a Filter request only stages its
small per-container request and reads candidate rows, instead of walking
every node's resource maps in Python.  ``snapshot`` puts one state on the
mirror's device per version.

Lanes are interned append-only; the first-fit name order the reference
iterates in (scheduler.go:216-224) is carried as an explicit ``card_order``
rank.  Values are exact int64.

:class:`DeviceBinpacker` answers one pod's fit across many nodes in one
bin-pack, through the mirror (the hot path) or by per-request staging (the
control in the tests).  Both take ``device``, ``"cuda"`` unless the caller
asks for another; with no GPU present that default raises.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from platform_aware_scheduling_tpu_torch.gas import scheduler as gas_logic
from platform_aware_scheduling_tpu_torch.gas.utils import container_requests
from platform_aware_scheduling_tpu_torch.kube.objects import Pod
from platform_aware_scheduling_tpu_torch.ops.binpack import (
    BIG_ORDER,
    BinpackNodeState,
    BinpackRequest,
    binpack,
)
from platform_aware_scheduling_tpu_torch.utils import decisions
from platform_aware_scheduling_tpu_torch.utils.device import DeviceLike, resolve_device

MIN_NODES = 16
MIN_CARDS = 4
MIN_RESOURCES = 4
MIN_CONTAINERS = 2
MIN_GPUS = 2


def _bucket(n: int, minimum: int) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


def _put(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``array`` on ``device`` that later host writes leave alone
    (a blocking copy to the card has read the array when it returns)."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    return tensor.clone() if device.type == "cpu" else tensor.to(device)


class GASUsageMirror:
    """Incrementally synced per-card usage and capacity, put on ``device``
    once per version."""

    def __init__(self, cache, device: DeviceLike = None):
        self.cache = cache
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._node_index: Dict[str, int] = {}
        self._res_index: Dict[str, int] = {}
        self._card_index: List[Dict[str, int]] = []  # per node row
        n, c, r = MIN_NODES, MIN_CARDS, MIN_RESOURCES
        self._used = np.zeros((n, c, r), dtype=np.int64)
        self._cap = np.zeros((n, r), dtype=np.int64)
        self._cap_present = np.zeros((n, r), dtype=bool)
        self._card_valid = np.zeros((n, c), dtype=bool)
        self._card_real = np.zeros((n, c), dtype=bool)
        self._card_order = np.full((n, c), BIG_ORDER, dtype=np.int32)
        self._has_gpus = np.zeros(n, dtype=bool)
        self._known = np.zeros(n, dtype=bool)
        self._version = 0
        self._device_state: Optional[Tuple[int, BinpackNodeState]] = None
        # rows written since the device state was built; a new version's
        # state re-uploads only these (a booking changes one row)
        self._dirty_rows: set = set()
        self._host_view: Optional[tuple] = None  # (version, node_index, known, has_gpus, res_index)
        # each row's last node object: an informer resync re-delivers the
        # object it holds, which changes nothing
        self._node_seen: Dict[int, object] = {}
        cache.on_node_change(self.on_node_change)  # replays cached nodes
        # replays booked nodes and registers under the cache lock, keeping
        # the cache -> mirror lock order (no window against the cache's
        # worker firing the hook mid-construction)
        cache.on_booking_change(self.on_booking_change)

    # -- interning -------------------------------------------------------------

    def _grow(self, n=None, c=None, r=None) -> None:
        cur_n, cur_c, cur_r = self._used.shape
        new_n = _bucket(n or cur_n, cur_n)
        new_c = _bucket(c or cur_c, cur_c)
        new_r = _bucket(r or cur_r, cur_r)
        if (new_n, new_c, new_r) == (cur_n, cur_c, cur_r):
            return
        pad3 = ((0, new_n - cur_n), (0, new_c - cur_c), (0, new_r - cur_r))
        self._used = np.pad(self._used, pad3)
        self._cap = np.pad(self._cap, (pad3[0], pad3[2]))
        self._cap_present = np.pad(self._cap_present, (pad3[0], pad3[2]))
        self._card_valid = np.pad(self._card_valid, (pad3[0], pad3[1]))
        self._card_real = np.pad(self._card_real, (pad3[0], pad3[1]))
        self._card_order = np.pad(self._card_order, (pad3[0], pad3[1]), constant_values=BIG_ORDER)
        self._has_gpus = np.pad(self._has_gpus, pad3[0])
        self._known = np.pad(self._known, pad3[0])

    def _intern_node(self, name: str) -> int:
        row = self._node_index.get(name)
        if row is None:
            row = len(self._node_index)
            self._grow(n=row + 1)
            self._node_index[name] = row
            self._card_index.append({})
        return row

    def _intern_resource(self, name: str) -> int:
        idx = self._res_index.get(name)
        if idx is None:
            idx = len(self._res_index)
            self._grow(r=idx + 1)
            self._res_index[name] = idx
            # a new resource lane invalidates the memoized snapshot: a
            # request interning a never-seen resource between cluster
            # events would otherwise get a state whose R is too small for
            # the index just handed out
            self._version += 1
        return idx

    def _intern_card(self, row: int, card: str) -> int:
        cards = self._card_index[row]
        lane = cards.get(card)
        if lane is None:
            lane = len(cards)
            self._grow(c=lane + 1)
            cards[card] = lane
            self._card_real[row, lane] = True
            # first-fit order = rank among the sorted names of the row's lanes
            for rank, name in enumerate(sorted(cards)):
                self._card_order[row, cards[name]] = rank
        return lane

    # -- event hooks -----------------------------------------------------------

    def on_node_change(self, node, deleted: bool = False) -> None:
        """Node added, updated or deleted: restage capacity and card set.
        The object the row was last staged from is skipped: a resync every
        30 s re-delivers every node, and restaging 10,000 unchanged rows
        would hold the mirror's lock against Filter for most of a second."""
        with self._lock:
            row = self._intern_node(node.name)
            if deleted:
                self._node_seen.pop(row, None)
                self._known[row] = False
                self._version += 1
                return
            if self._node_seen.get(row) is node:
                return
            self._node_seen[row] = node
            self._dirty_rows.add(row)
            self._known[row] = True
            gpus = gas_logic.get_node_gpu_list(node)
            self._has_gpus[row] = bool(gpus)
            capacity = gas_logic.get_per_gpu_resource_capacity(node, len(gpus))
            self._cap[row, :] = 0
            self._cap_present[row, :] = False
            for name, value in capacity.items():
                idx = self._intern_resource(name)
                self._cap[row, idx] = value
                self._cap_present[row, idx] = True
            gpu_set = set(gpus)
            for card in gpus:
                self._intern_card(row, card)
            for card, lane in self._card_index[row].items():
                self._card_valid[row, lane] = card in gpu_set
            self._version += 1

    def on_booking_change(self, node_name: str) -> None:
        """A booking changed on one node: restage its used row.  Called
        with the cache lock held, so the read is consistent."""
        with self._lock:
            row = self._intern_node(node_name)
            self._dirty_rows.add(row)
            used = self.cache.get_node_resource_status(node_name)
            self._used[row, :, :] = 0
            for card, rm in used.items():
                lane = self._intern_card(row, card)
                for name, value in rm.items():
                    idx = self._intern_resource(name)
                    self._used[row, lane, idx] = value
            self._version += 1

    # -- reads -----------------------------------------------------------------

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def resource_index(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._res_index)

    def _host_arrays(self) -> Tuple[np.ndarray, ...]:
        """The host arrays in BinpackNodeState's field order."""
        return (self._used, self._cap, self._cap_present, self._card_valid, self._card_real, self._card_order)

    def _build_state(self) -> BinpackNodeState:
        """This version's device state.  A state's tensors are never written
        after it is built, so the next one starts from the last one's, with
        the dirty rows uploaded (index_copy is out of place); a grown shape
        or many dirty rows upload everything."""
        rows = sorted(self._dirty_rows)
        self._dirty_rows.clear()
        last = self._device_state[1] if self._device_state is not None else None
        if last is None or tuple(last.used.shape) != self._used.shape or 4 * len(rows) > self._used.shape[0]:
            return BinpackNodeState(*(_put(array, self.device) for array in self._host_arrays()))
        if not rows:
            return BinpackNodeState(*last)  # a new version with the same values
        index = torch.tensor(rows, dtype=torch.long, device=self.device)
        return BinpackNodeState(*(
            tensor.index_copy(0, index, _put(array[rows], self.device))
            for tensor, array in zip(last, self._host_arrays())
        ))

    def snapshot(self):
        """(device state over ALL interned rows, node_index, known,
        has_gpus, resource index), memoized per version: one device state
        object and one read-only copy of the host tables each."""
        with self._lock:
            if self._device_state is None or self._device_state[0] != self._version:
                self._device_state = (self._version, self._build_state())
            if self._host_view is None or self._host_view[0] != self._version:
                self._host_view = (
                    self._version,
                    dict(self._node_index),
                    self._known.copy(),
                    self._has_gpus.copy(),
                    dict(self._res_index),
                )
            return (self._device_state[1], *self._host_view[1:])


def stage_request(
    requests, shares, resources_index: Dict[str, int], r_pad: int, device: torch.device
) -> Tuple[BinpackRequest, int]:
    """The padded per-container request tensors on ``device``, and K."""
    t_pad = _bucket(len(requests), MIN_CONTAINERS)
    max_gpus = max((k for _, k in shares), default=0)
    k_pad = _bucket(max(max_gpus, 1), MIN_GPUS)
    need = np.zeros((t_pad, r_pad), dtype=np.int64)
    need_active = np.zeros((t_pad, r_pad), dtype=bool)
    num_gpus = np.zeros(t_pad, dtype=np.int32)
    container_active = np.zeros(t_pad, dtype=bool)
    for t, (per_gpu, k) in enumerate(shares):
        container_active[t] = True
        num_gpus[t] = k
        for name, value in per_gpu.items():
            idx = resources_index[name]
            need[t, idx] = value
            need_active[t, idx] = True
    return (
        BinpackRequest(
            need=_put(need, device),
            need_active=_put(need_active, device),
            num_gpus=_put(num_gpus, device),
            container_active=_put(container_active, device),
        ),
        k_pad,
    )


def _verdicts(rows: np.ndarray, known, has_gpus, fits) -> Tuple[List[bool], List[int]]:
    """Per-candidate (fit, code) from interned rows (-1 = never seen): a
    row not known is an unknown node, a known row without GPUs has none,
    else the bin-pack decides."""
    present = rows >= 0
    safe = np.where(present, rows, 0)
    known_r = present & known[safe]
    gpus_r = known_r & has_gpus[safe]
    fit_r = gpus_r & fits[safe]
    codes = np.full(rows.shape[0], decisions.CODE_GAS_CAPACITY, dtype=np.int64)
    codes[~known_r] = decisions.CODE_GAS_UNKNOWN_NODE
    codes[known_r & ~gpus_r] = decisions.CODE_GAS_NO_GPUS
    codes[fit_r] = decisions.CODE_ELIGIBLE
    return fit_r.tolist(), codes.tolist()


class DeviceBinpacker:
    """Evaluates one pod's fit against many nodes in one bin-pack.

    The mirror path amortises the device work across a scheduling burst:
    the pods of a deployment share a template, and the mirror state only
    changes when a booking or node event lands, so fits are cached per
    (state, request signature) over ALL interned rows and a repeat costs
    row lookups alone.  ``fits_hits`` and ``fits_misses`` count the cache's
    answers; a miss runs the bin-pack once."""

    FITS_CACHE_SIZE = 8

    def __init__(self, cache, use_mirror: bool = True, device: DeviceLike = None):
        self.cache = cache
        self.device = resolve_device(device)
        self.mirror = GASUsageMirror(cache, device=self.device) if use_mirror else None
        self._fits_lock = threading.Lock()
        # MRU [state, signature, fits over all rows]; keyed by the state
        # OBJECT (snapshot memoizes one per mirror version) and the pod's
        # request signature
        self._fits_cache: List[list] = []
        self.fits_hits = 0
        self.fits_misses = 0

    def batch_fit(
        self,
        pod: Pod,
        node_names: Sequence[str],
        with_reasons: bool = False,
    ):
        """Per-node fit verdicts, or None when the pod has no per-card
        demand (the host loop decides that cheaply).  With
        ``with_reasons`` the return is ``(fits, codes)``: 0 fit,
        gas_unknown_node and gas_no_gpus for the pre-failed lanes,
        gas_capacity where the bin-pack said no — the classes the host
        loop's typed exceptions give.  A node the staged path cannot read
        raises ``StagingError``; an error of the device (a kernel that does
        not build or launch, a shape it refuses) propagates as it is."""
        requests = container_requests(pod)
        shares = [gas_logic.get_per_gpu_resource_request(req) for req in requests]
        max_gpus = max((k for _, k in shares), default=0)
        resources = sorted({name for req in requests for name in req})
        if not resources or max_gpus == 0:
            return None
        if self.mirror is not None:
            fits, codes = self._fit_mirror(requests, shares, resources, node_names)
        else:
            fits, codes = self._fit_staged(requests, shares, resources, node_names)
        return (fits, codes) if with_reasons else fits

    # -- persistent-mirror path ------------------------------------------------

    def _all_rows_fits(self, state, signature, compute) -> np.ndarray:
        """Fits over ALL interned rows for this (state, request template),
        from the MRU cache when the burst repeats the template; ``compute``
        runs only on a miss."""
        with self._fits_lock:
            for idx, entry in enumerate(self._fits_cache):
                if entry[0] is state and entry[1] == signature:
                    if idx:
                        self._fits_cache.insert(0, self._fits_cache.pop(idx))
                    self.fits_hits += 1
                    return entry[2]
            self.fits_misses += 1
        fits = compute()
        # purge against the mirror's CURRENT state, not this call's: a
        # straggler that snapshotted a superseded state must neither evict
        # fresh entries nor insert one that can never hit again
        with self.mirror._lock:
            dev = self.mirror._device_state
            current = dev[1] if dev is not None else state
        with self._fits_lock:
            self._fits_cache = [entry for entry in self._fits_cache if entry[0] is current]
            if state is current:
                self._fits_cache.insert(0, [state, signature, fits])
                del self._fits_cache[self.FITS_CACHE_SIZE:]
        return fits

    def _fit_mirror(self, requests, shares, resources, node_names):
        mirror = self.mirror
        with mirror._lock:
            for name in resources:  # unknown request resources: intern (all absent)
                mirror._intern_resource(name)
            state, node_index, known, has_gpus, res_index = mirror.snapshot()
        max_gpus = max((k for _, k in shares), default=0)
        k_pad = _bucket(max(max_gpus, 1), MIN_GPUS)
        signature = (
            tuple((tuple(sorted(per_gpu.items())), k) for per_gpu, k in shares),
            k_pad,
        )

        def compute() -> np.ndarray:
            r_pad = state.capacity.shape[-1]
            request, staged_k_pad = stage_request(requests, shares, res_index, r_pad, self.device)
            return binpack(state, request, staged_k_pad).fits.cpu().numpy()

        fits_all = self._all_rows_fits(state, signature, compute)
        rows = np.fromiter(
            (node_index.get(name, -1) for name in node_names), dtype=np.int64, count=len(node_names)
        )
        return _verdicts(rows, known, has_gpus, fits_all)

    # -- per-request staging path (control) ------------------------------------

    def _fit_staged(self, requests, shares, resources, node_names):
        r_pad = _bucket(len(resources), MIN_RESOURCES)
        res_index = {name: i for i, name in enumerate(resources)}
        request, k_pad = stage_request(requests, shares, res_index, r_pad, self.device)

        staged = []
        out = [False] * len(node_names)
        codes = [decisions.CODE_GAS_CAPACITY] * len(node_names)
        max_cards = 1
        for pos, name in enumerate(node_names):
            try:
                node = self.cache.fetch_node(name)
            except Exception:
                codes[pos] = decisions.CODE_GAS_UNKNOWN_NODE
                continue
            try:
                gpus = gas_logic.get_node_gpu_list(node)
                if not gpus:
                    codes[pos] = decisions.CODE_GAS_NO_GPUS
                    continue
                capacity = gas_logic.get_per_gpu_resource_capacity(node, len(gpus))
                used = self.cache.get_node_resource_status(name)
            except Exception as exc:
                raise gas_logic.StagingError(f"cannot stage node {name}: {exc}") from exc
            cards = sorted(set(gpus) | set(used))
            max_cards = max(max_cards, len(cards))
            staged.append((pos, cards, capacity, used, set(gpus)))
        if not staged:
            return out, codes

        n = len(staged)
        c_pad = _bucket(max_cards, MIN_CARDS)
        used_np = np.zeros((n, c_pad, r_pad), dtype=np.int64)
        cap_np = np.zeros((n, r_pad), dtype=np.int64)
        cap_present = np.zeros((n, r_pad), dtype=bool)
        card_valid = np.zeros((n, c_pad), dtype=bool)
        card_real = np.zeros((n, c_pad), dtype=bool)
        card_order = np.full((n, c_pad), BIG_ORDER, dtype=np.int32)
        for row, (_pos, cards, capacity, used, gpu_set) in enumerate(staged):
            for name, value in capacity.items():
                idx = res_index.get(name)
                if idx is not None:
                    cap_np[row, idx] = value
                    cap_present[row, idx] = True
            for ci, card in enumerate(cards):  # already name-sorted
                card_real[row, ci] = True
                card_valid[row, ci] = card in gpu_set
                card_order[row, ci] = ci
                for name, value in used.get(card, {}).items():
                    idx = res_index.get(name)
                    if idx is not None:
                        used_np[row, ci, idx] = value

        state = BinpackNodeState(
            used=_put(used_np, self.device),
            capacity=_put(cap_np, self.device),
            cap_present=_put(cap_present, self.device),
            card_valid=_put(card_valid, self.device),
            card_real=_put(card_real, self.device),
            card_order=_put(card_order, self.device),
        )
        fits_np = binpack(state, request, k_pad).fits.cpu().numpy()
        for row, (pos, *_rest) in enumerate(staged):
            out[pos] = bool(fits_np[row])
            if out[pos]:
                codes[pos] = decisions.CODE_ELIGIBLE
        return out, codes
