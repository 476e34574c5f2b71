"""Per-request fast path for the Prioritize and Filter verbs.

The port's counterpart of ``platform_aware_scheduling_tpu/tas/fastpath.py``
(its pure-Python paths).  The ordering a Prioritize answer needs is
request-independent: for one (metric, operator) the rank order over all
nodes is fixed until that metric's row changes, and a request's answer is
that order restricted to its candidates (the sort key, ``ops/scoring.py``,
does not depend on which candidates are present).  Filter's violation set
is request-independent too.  So the device work leaves the request path:

  * on a state change, :meth:`PrioritizeFastPath.precompute` ranks every
    (metric row, op) pair in use in ONE batched pass
    (``ops/scoring.batch_prioritize``), runs ``ops/scoring.filter_explain``
    once for each policy whose rule rows moved, and reads all of it back
    in ONE ``.cpu()``;
  * a request then costs a candidate-row lookup, a subsequence selection
    and JSON assembly from per-node byte fragments.

With the native wire extension (``native/``, ``_wirec_torch``) the verbs
serve through its zero-copy scanner and encoders instead, on three layers
of reuse, each keyed so that a state change misses by construction:

  * interned node-name universes (:meth:`PrioritizeFastPath.universe_probe`):
    a candidate list seen twice is kept once, its row map cached per name
    table, so a render over it hashes nothing;
  * response skeletons: a whole body keyed by the identities of its inputs
    (ranking, name table, planned row and universe for Prioritize;
    violation set, policy and universe for Filter), pre-rendered for every
    live universe by the warm pass (:meth:`warm_skeletons`);
  * the span caches: bodies keyed by the same identities and the raw
    candidate-span bytes (memcmp, no hash trusted), for lists not interned.

The pure-Python selection and fragments stay as the exact path's encoder
and the one used when the extension is off or cannot be built.
"""

from __future__ import annotations

import json
import os
import threading
from itertools import repeat
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from platform_aware_scheduling_tpu_torch.ops.rules import OP_IDS
from platform_aware_scheduling_tpu_torch.ops.scoring import (
    batch_prioritize,
    filter_explain,
    prioritize,
)
from platform_aware_scheduling_tpu_torch.ops.state import (
    CompiledPolicy,
    CompiledRuleSet,
    DeviceView,
)
from platform_aware_scheduling_tpu_torch.utils import decisions, trace

# op id -> operator name, for decoding device rule indexes into reasons
_OP_NAMES = {op_id: name for name, op_id in OP_IDS.items()}

# rank -> b'<score>}, ' suffix bytes (entry end and separator), grown on
# demand (scores are ordinal 10 - rank and go negative past rank 10)
_SCORE_SUFFIX: List[bytes] = []
_SCORE_LOCK = threading.Lock()


def _score_suffixes(n: int) -> List[bytes]:
    if len(_SCORE_SUFFIX) < n:
        with _SCORE_LOCK:
            for i in range(len(_SCORE_SUFFIX), n):
                _SCORE_SUFFIX.append(f"{10 - i}}}, ".encode())
    return _SCORE_SUFFIX


def _response_cache_size(default: int = 32) -> int:
    """``PAS_TPU_RESPONSE_CACHE``: response-reuse entries kept per cache;
    a malformed or non-positive value falls back to the default."""
    try:
        value = int(os.environ.get("PAS_TPU_RESPONSE_CACHE", ""))
    except ValueError:
        return default
    return value if value >= 1 else default


def _universe_cache_size(default: int = 8) -> int:
    """``PAS_TPU_UNIVERSE_CACHE``: interned universes kept (each holds the
    raw candidate span, its slices and encode metadata, ~0.5 MB at 10k
    nodes).  ``0`` turns interning off (the span caches alone serve, with
    the same bytes); a malformed or negative value falls back."""
    try:
        value = int(os.environ.get("PAS_TPU_UNIVERSE_CACHE", ""))
    except ValueError:
        return default
    return value if value >= 0 else default


class _ViewTable:
    """Per-interning-version request-time tables: name -> row index,
    pre-rendered JSON fragments (the Python encoder) and the native
    ``NameTable`` (the wire extension's).  Keyed by the view's
    ``intern_version``, so pure value churn keeps the tables until a new
    node appears; each kind builds on first use."""

    __slots__ = ("version", "node_index", "node_names", "node_capacity", "_fragments", "_native")

    def __init__(self, view: DeviceView):
        self.version = view.intern_version
        self.node_index = view.node_index  # immutable snapshot dict
        self.node_names = view.node_names
        self.node_capacity = view.node_capacity
        self._fragments: Optional[List[bytes]] = None
        self._native = None

    @property
    def fragments(self) -> List[bytes]:
        fragments = self._fragments
        if fragments is None:
            # json.dumps escapes exactly as encode_host_priority_list does
            fragments = [
                f'{{"Host": {json.dumps(name)}, "Score": '.encode() for name in self.node_names
            ]
            self._fragments = fragments
        return fragments

    def native(self, wirec):
        table = self._native
        if table is None:
            table = wirec.build_table(self.node_names)
            self._native = table
        return table


def _violation_sig(rules: CompiledRuleSet, view: DeviceView) -> Tuple:
    """Cache key of a policy's violation set: its rule rows' content
    versions and the rule arrays, so churn on other metrics keeps it."""
    rule_rows = tuple(int(r) for r in rules.metric_rows[rules.active])
    return (
        tuple(view.row_version(r) for r in rule_rows),
        rule_rows,
        rules.op_ids.tobytes(),
        rules.targets.tobytes(),
        rules.active.tobytes(),
    )


class PrioritizeFastPath:
    """Caches global rankings + violation sets per state and answers
    verbs with numpy selections over them."""

    # MRU bound of every per-state cache below (a response entry is about
    # a candidate span plus a body, ~0.5 MB at 10k nodes)
    RESPONSE_CACHE_SIZE = _response_cache_size()
    # interned node-name universes kept (wirec.c UniverseCache; 0 = off)
    UNIVERSE_CACHE_SIZE = _universe_cache_size()

    def __init__(self):
        self._lock = threading.Lock()
        self._table: Optional[_ViewTable] = None
        # the extension's UniverseCache, made on the first probe; False
        # once it is known to be unavailable, so the probe stays O(1)
        self._universes = None
        # (row content version, metric row, op) -> int64 np global order
        self._rank: Dict[Tuple[int, int, int], np.ndarray] = {}
        # violation sig -> (frozenset of violating rows, {row: first rule})
        self._violations: Dict[Tuple, Tuple[frozenset, Dict[int, int]]] = {}
        # [violations, policy_name, {name: reason}, {name: rule index},
        #  per-row JSON-encoded reason bytes or None (built on first use by
        #  the native Filter encoders)], MRU
        self._viol_reasons: List[list] = []
        # [ranked, table, top-K (name, score) head], MRU
        self._explain_heads: List[list] = []
        # Prioritize span cache: [ranked, table, planned_row, span bytes,
        # body], MRU.  A hit needs the same ranking and table objects, the
        # same planned row and byte-equal candidate spans
        self._responses: List[list] = []
        # Filter span cache: [violations, policy_name, use_node_names, span
        # bytes, body, failed count].  The policy is part of the key:
        # policies with the same rules share one violation set, but their
        # FailedNodes reasons name the policy
        self._filter_responses: List[list] = []
        # response skeletons, the universe-keyed layer above the span
        # caches: a hit is identity compares only.  [violations,
        # policy_name, universe, body, failed count] and [ranked, table,
        # planned_row, universe, body]
        self._filter_skeletons: List[list] = []
        self._prioritize_skeletons: List[list] = []
        # [violations, row count, uint8-a-row mask bytes] for the native
        # Filter encoders; the entry holds the set, so no id can alias
        self._viol_masks: List[list] = []

    # -- table/cache maintenance ----------------------------------------------

    def _table_for(self, view: DeviceView) -> _ViewTable:
        """The encode table for this view's interning.  Forward-only: a
        stale in-flight request gets a throwaway table and never displaces
        the current one."""
        table = self._table
        if table is not None and table.version == view.intern_version:
            return table
        if table is not None and view.intern_version < table.version:
            return _ViewTable(view)
        with self._lock:
            current = self._table
            if current is None or current.version < view.intern_version:
                current = _ViewTable(view)
                self._table = current
            elif current.version > view.intern_version:  # raced past us
                return _ViewTable(view)
            return current

    def _ranking(self, view: DeviceView, row: int, op: int) -> np.ndarray:
        """The global order of (row, op) at this state; a miss (a request
        that beat the warm pass) ranks on the device with one
        :func:`prioritize` and reads the valid prefix back."""
        key = (view.row_version(row), row, op)
        ranked = self._rank.get(key)
        if ranked is None:
            res = prioritize(
                view.values,
                view.present,
                row,
                op,
                torch.ones(view.node_capacity, dtype=torch.bool, device=view.values.device),
            )
            host = torch.cat([res.valid_count[None], res.perm[: len(view.node_names)]]).cpu().numpy()
            ranked = host[1 : 1 + int(host[0])].astype(np.int64)
            with self._lock:
                self._rank[key] = ranked
        return ranked

    def _solve(
        self,
        view: DeviceView,
        pairs: Iterable[Tuple[int, int]],
        policies: Sequence[CompiledPolicy] = (),
    ) -> Tuple[int, Dict[Tuple, Tuple[frozenset, Dict[int, int]]]]:
        """Rank every not-yet-cached (row, op) pair in one
        :func:`batch_prioritize` and explain every not-yet-cached policy
        violation set with :func:`filter_explain`, then read all of it
        back in ONE ``.cpu()``.  Returns the number of pairs ranked and
        {violation sig: cached entry} for the given policies."""
        missing = sorted(
            {
                (int(row), int(op))
                for row, op in pairs
                if (view.row_version(int(row)), int(row), int(op)) not in self._rank
            }
        )
        resolved: Dict[Tuple, Tuple[frozenset, Dict[int, int]]] = {}
        explain: List[Tuple[Tuple, object]] = []
        for compiled in policies:
            sig = _violation_sig(compiled.dontschedule, view)
            cached = self._violations.get(sig)
            if cached is not None:
                resolved[sig] = cached
            elif all(sig != pending for pending, _ in explain):
                device_rules = compiled.device_rules("dontschedule")
                if device_rules is not None:
                    explain.append((sig, device_rules))
        if not missing and not explain:
            return 0, resolved
        n = view.node_capacity
        device = view.values.device
        # only interned columns can be present, so every valid lane of a
        # ranking and every violating lane lies in the first ``real``
        real = len(view.node_names)
        parts = []
        if missing:
            res = batch_prioritize(
                view.values,
                view.present,
                torch.tensor([row for row, _ in missing], dtype=torch.int32, device=device),
                torch.tensor([op for _, op in missing], dtype=torch.int32, device=device),
                torch.ones((len(missing), n), dtype=torch.bool, device=device),
            )
            parts.append(torch.cat([res.valid_count[:, None], res.perm[:, :real]], dim=1))
        everywhere = torch.ones(n, dtype=torch.bool, device=device)
        for _sig, device_rules in explain:
            res = filter_explain(view.values, view.present, device_rules, everywhere)
            parts.append(torch.cat([res.first_rule.new_zeros(1), res.first_rule[:real]])[None])
        host = torch.cat(parts).cpu().numpy()  # the pass's one readback
        with self._lock:
            for i, (row, op) in enumerate(missing):
                key = (view.row_version(row), row, op)
                # a C-contiguous int64 copy, never a view of ``host``: the
                # wire encoders read a ranking as a raw buffer
                self._rank[key] = host[i, 1 : 1 + int(host[i, 0])].astype(np.int64)
            for i, (sig, _rules) in enumerate(explain, start=len(missing)):
                first_rule = host[i, 1:]
                rows = np.nonzero(first_rule >= 0)[0]
                computed = (
                    frozenset(int(r) for r in rows),
                    {int(r): int(first_rule[r]) for r in rows},
                )
                # a concurrent computer may have won: keep ITS set so the
                # identity-keyed reason cache sees one object per state
                resolved[sig] = self._violations.setdefault(sig, computed)
        return len(missing), resolved

    def warm_rankings_batched(self, view: DeviceView, pairs) -> int:
        """Seed the ranking cache for every not-yet-warm (metric row, op)
        pair in one device pass; returns the number of pairs computed."""
        return self._solve(view, pairs)[0]

    def warm_pairs(self, view: DeviceView, pairs) -> None:
        """Warm the rankings of (metric row, op) pairs against ``view``
        without :meth:`precompute`'s pruning."""
        self._solve(view, pairs)

    def precompute(
        self, view: DeviceView, pairs, policies: Sequence[CompiledPolicy] = (), wirec=None
    ) -> int:
        """Warm the request-time state at ``view``: the encode table of the
        encoder that will serve (the native ``NameTable`` when ``wirec`` is
        given, the fragments otherwise), the rankings of ``pairs`` and the
        violation sets of ``policies`` (one device pass, one readback; see
        :meth:`_solve`).  Then prune entries whose rows have moved on.
        Returns the pairs ranked."""
        table = self._table_for(view)
        if wirec is not None:
            table.native(wirec)
        else:
            table.fragments
        ranked, _ = self._solve(view, pairs, policies)
        with self._lock:
            self._rank = {k: v for k, v in self._rank.items() if k[0] == view.row_version(k[1])}
            self._violations = {
                k: v
                for k, v in self._violations.items()
                if k[0] == tuple(view.row_version(r) for r in k[1])
            }
        return ranked

    # -- universe interning ----------------------------------------------------

    def universe_probe(self, wirec, parsed, use_node_names: bool):
        """The interned universe of this request's candidate span, or None
        (a cold span, interning off).  A span is interned on its second
        sighting, so a one-off list pays no interning.  Every probe against
        an available cache counts one ``pas_wire_intern_hits_total`` or
        ``pas_wire_intern_misses_total`` (evictions beside them).  Never
        raises into the verb: interning only saves work."""
        cache = self._universe_cache(wirec)
        if cache is None:
            return None
        try:
            universe, interned, evicted = cache.probe(parsed, use_node_names)
        except (ValueError, TypeError, MemoryError):
            return None
        if universe is not None and not interned:
            trace.COUNTERS.inc("pas_wire_intern_hits_total")
            return universe
        trace.COUNTERS.inc("pas_wire_intern_misses_total")
        if evicted:
            trace.COUNTERS.inc("pas_wire_intern_evictions_total", evicted)
        # interned just now (or a first sighting, None): this request still
        # renders, and its body seeds the skeleton layer
        return universe

    def _universe_cache(self, wirec):
        cache = self._universes
        if cache is not None:
            return cache or None  # False: known to be unavailable
        if self.UNIVERSE_CACHE_SIZE <= 0 or wirec is None:
            self._universes = False
            return None
        with self._lock:
            if self._universes is None:
                self._universes = wirec.UniverseCache(capacity=self.UNIVERSE_CACHE_SIZE)
            return self._universes or None

    def warm_skeletons(
        self,
        wirec,
        compiled: CompiledPolicy,
        view: DeviceView,
        policy_name: str,
        filter_ok: bool = True,
        prioritize_ok: bool = True,
    ) -> int:
        """Render the response skeletons of every interned NodeNames
        universe at the current state, in the warm pass, so that a refresh
        that makes a new violation set or ranking re-renders each live
        universe's body once, off the request path, and the first request
        of the period still finds its body.  Returns the bodies rendered."""
        cache = self._universes
        if not cache or wirec is None:
            return 0
        rendered = 0
        table = self._table_for(view)
        n_rows = len(table.node_names)
        native = table.native(wirec)
        violations = reasons = ranked = None
        if filter_ok:
            counted = self._violation_set_counted(compiled, view)
            if counted is not None:
                violations, rule_map = counted[0]
                reasons = self.reason_table(compiled, view, policy_name, violations, rule_map, n_rows)
        if prioritize_ok and compiled.scheduleonmetric_row >= 0:
            ranked = self._ranking(view, compiled.scheduleonmetric_row, compiled.scheduleonmetric_op)
        for universe in cache.snapshot():
            if not universe.use_node_names:
                continue
            if violations is not None:
                with self._lock:
                    have = any(
                        e[0] is violations and e[1] == policy_name and e[2] is universe
                        for e in self._filter_skeletons
                    )
                if not have:
                    mask = self._violation_mask(violations, n_rows)
                    body, n_failed = wirec.filter_respond(universe, native, mask, reasons)
                    self.filter_store(violations, policy_name, True, None, body, n_failed, universe=universe)
                    rendered += 1
            if ranked is not None:
                with self._lock:
                    have = any(
                        e[0] is ranked and e[1] is table and e[2] == -1 and e[3] is universe
                        for e in self._prioritize_skeletons
                    )
                if not have:
                    body = wirec.select_encode_universe(universe, native, ranked, -1)
                    self._store_prioritize_skeleton([ranked, table, -1, universe, body])
                    rendered += 1
        return rendered

    def _store_prioritize_skeleton(self, entry: list) -> None:
        with self._lock:
            self._prioritize_skeletons.insert(0, entry)
            del self._prioritize_skeletons[self.RESPONSE_CACHE_SIZE :]

    def wire_debug(self) -> Dict:
        """The ``/debug/wire`` payload: the universe cache's occupancy, the
        interning counters and the skeleton caches' keys (universe uid,
        violation-set size, planned row), the operator's view of why a
        request was cold, interned or served whole."""
        out: Dict = {
            "enabled": bool(self._universes),
            "capacity": self.UNIVERSE_CACHE_SIZE,
            "counters": {
                "hits": trace.COUNTERS.get("pas_wire_intern_hits_total"),
                "misses": trace.COUNTERS.get("pas_wire_intern_misses_total"),
                "evictions": trace.COUNTERS.get("pas_wire_intern_evictions_total"),
            },
        }
        cache = self._universes
        if not cache:
            out["occupancy"] = 0
            out["universes"] = []
        else:
            out["occupancy"] = cache.occupancy
            out["universes"] = cache.universes()
        with self._lock:
            out["skeletons"] = {
                "filter": [
                    {"universe": e[2].uid, "violating": len(e[0]), "policy": e[1], "bytes": len(e[3])}
                    for e in self._filter_skeletons
                ],
                "prioritize": [
                    {"universe": e[3].uid, "planned_row": e[2], "bytes": len(e[4])}
                    for e in self._prioritize_skeletons
                ],
            }
        return out

    # -- prioritize ------------------------------------------------------------

    def prioritize_parsed(
        self,
        wirec,
        compiled: CompiledPolicy,
        view: DeviceView,
        parsed,
        planned: Optional[str] = None,
        use_node_names: bool = False,
        span=trace.NULL_SPAN,
        universe=None,
    ) -> bytes:
        """The Prioritize body through the wire extension: candidate
        lookup, selection and assembly in ``select_encode`` over the parsed
        body's name slices, with no per-node Python object.  An interned
        ``universe`` is served from the skeleton layer first, and a miss
        renders over its cached row map (``select_encode_universe``); a
        candidate span equal to a cached one under the same ranking, table
        and plan is served from the span cache.  The bytes are
        :meth:`prioritize_bytes`'s."""
        table = self._table_for(view)
        with span.stage("kernel"):
            ranked = self._ranking(view, compiled.scheduleonmetric_row, compiled.scheduleonmetric_op)
        planned_row = -1 if planned is None else table.node_index.get(planned, -1)
        with self._lock:
            if universe is not None:
                skeletons = self._prioritize_skeletons
                for idx, e in enumerate(skeletons):
                    if e[0] is ranked and e[1] is table and e[2] == planned_row and e[3] is universe:
                        if idx:
                            skeletons.insert(0, skeletons.pop(idx))
                        span.set("fastpath", "hit")
                        trace.COUNTERS.inc("pas_fastpath_response_hit_total")
                        return e[4]
            responses = self._responses
            for idx, e in enumerate(responses):
                if (
                    e[0] is ranked
                    and e[1] is table
                    and e[2] == planned_row
                    and parsed.span_matches(use_node_names, e[3])
                ):
                    if idx:
                        responses.insert(0, responses.pop(idx))
                    if universe is not None:
                        # promote it, so the next request skips the memcmp
                        self._prioritize_skeletons.insert(0, [ranked, table, planned_row, universe, e[4]])
                        del self._prioritize_skeletons[self.RESPONSE_CACHE_SIZE :]
                    span.set("fastpath", "hit")
                    trace.COUNTERS.inc("pas_fastpath_response_hit_total")
                    return e[4]
        span.set("fastpath", "miss")
        trace.COUNTERS.inc("pas_fastpath_response_miss_total")
        with span.stage("encode"):
            if universe is not None:
                body = wirec.select_encode_universe(universe, table.native(wirec), ranked, planned_row)
            else:
                body = wirec.select_encode(parsed, table.native(wirec), ranked, planned_row, use_node_names)
        if universe is not None:
            self._store_prioritize_skeleton([ranked, table, planned_row, universe, body])
            return body
        cand_span = parsed.node_names_span() if use_node_names else parsed.nodes_span()
        if cand_span is not None:
            with self._lock:
                self._responses.insert(0, [ranked, table, planned_row, cand_span, body])
                del self._responses[self.RESPONSE_CACHE_SIZE :]
        return body

    def prioritize_bytes(
        self,
        compiled: CompiledPolicy,
        view: DeviceView,
        names: List[str],
        planned: Optional[str] = None,
        span=trace.NULL_SPAN,
    ) -> bytes:
        """The full Prioritize response body for one request: the global
        order restricted to ``names`` (candidate ∩ metric-present), ordinal
        scores, and the batch-planned node promoted to rank 1."""
        table = self._table_for(view)
        with span.stage("kernel"):
            ranked = self._ranking(view, compiled.scheduleonmetric_row, compiled.scheduleonmetric_op)
        with span.stage("encode"):
            index = table.node_index
            sentinel = table.node_capacity
            mask = np.zeros(sentinel + 1, dtype=bool)
            rows = np.fromiter(map(index.get, names, repeat(sentinel)), dtype=np.int64, count=len(names))
            mask[rows] = True
            mask[sentinel] = False
            sel = ranked[mask[ranked]]
            if planned is not None:
                prow = index.get(planned)
                if prow is not None:
                    at = np.nonzero(sel == prow)[0]
                    if at.size:
                        sel = np.concatenate(([prow], np.delete(sel, at[0])))
            return self._encode(table, sel)

    def neutral_bytes(self, view: DeviceView, names: List[str]) -> bytes:
        """The degraded-mode neutral Prioritize body: every candidate, in
        request order, scored 0.  The bytes ``encode_host_priority_list``
        gives over ``HostPriority(name, 0)``, joined from the view's
        pre-rendered fragments; a name the view does not hold is rendered
        here."""
        if not names:
            return b"[]\n"
        table = self._table_for(view)
        fragments, index = table.fragments, table.node_index
        parts = [
            fragments[row] if (row := index.get(name)) is not None
            else f'{{"Host": {json.dumps(name)}, "Score": '.encode()
            for name in names
        ]
        return b"[" + b"0}, ".join(parts) + b"0}]\n"

    @staticmethod
    def _encode(table: _ViewTable, sel: np.ndarray) -> bytes:
        k = sel.size
        if k == 0:
            return b"[]\n"
        # fragments and suffixes interleaved, so one C-level join builds
        # the body with no per-entry concatenation
        parts = [b""] * (2 * k)
        parts[0::2] = map(table.fragments.__getitem__, sel.tolist())
        parts[1::2] = _score_suffixes(k)[:k]
        parts[-1] = parts[-1][:-2]  # no separator after the last entry
        return b"[" + b"".join(parts) + b"]\n"

    # -- filter ----------------------------------------------------------------

    def violation_set(self, compiled: CompiledPolicy, view: DeviceView) -> Optional[frozenset]:
        """Identity-stable violating-row frozenset for this policy at this
        state (a state change makes a new object)."""
        result = self._violation_set_counted(compiled, view)
        return result if result is None else result[0][0]

    def violation_rule_map(self, compiled: CompiledPolicy, view: DeviceView) -> Optional[Dict[int, int]]:
        """{violating row: first matching rule index} at this state."""
        result = self._violation_set_counted(compiled, view)
        return result if result is None else result[0][1]

    def violation_reasons(self, compiled: CompiledPolicy, view: DeviceView, policy_name: str):
        """``(violations frozenset, {node name: reason string}, {node name:
        rule index})`` for one policy at this state, or None when the
        policy has no device-evaluable dontschedule rules.  Built once per
        (violation set, policy) and shared by every request at that state;
        the strings equal the host path's (``violated_details``)."""
        counted = self._violation_set_counted(compiled, view)
        if counted is None:
            return None
        violations, rule_map = counted[0]
        entry = self._reason_entry(compiled, view, policy_name, violations, rule_map)
        return violations, entry[2], entry[3]

    def _reason_entry(
        self,
        compiled: CompiledPolicy,
        view: DeviceView,
        policy_name: str,
        violations: frozenset,
        rule_map: Dict[int, int],
    ) -> list:
        with self._lock:
            for idx, entry in enumerate(self._viol_reasons):
                if entry[0] is violations and entry[1] == policy_name:
                    if idx:
                        self._viol_reasons.insert(0, self._viol_reasons.pop(idx))
                    return entry
        rules = compiled.dontschedule
        reasons: Dict[str, str] = {}
        indexes: Dict[str, int] = {}
        n_names = len(view.node_names)
        for row in sorted(rule_map):
            if row >= n_names:
                continue  # padding lanes never violate real nodes
            ridx = rule_map[row]
            metric = rules.metric_names[ridx] if ridx < len(rules.metric_names) else ""
            operator = _OP_NAMES.get(int(rules.op_ids[ridx]), "?")
            target_str = decisions.fmt_milli(int(rules.targets[ridx]))
            if view.values_milli is not None:
                value_str = decisions.fmt_milli(
                    int(view.values_milli[int(rules.metric_rows[ridx]), row])
                )
            else:
                value_str = "?"
            name = view.node_names[row]
            reasons[name] = decisions.rule_reason(policy_name, metric, operator, value_str, target_str)
            indexes[name] = ridx
        entry = [violations, policy_name, reasons, indexes, None]
        with self._lock:
            for existing in self._viol_reasons:
                if existing[0] is violations and existing[1] == policy_name:
                    return existing  # another thread built it first
            self._viol_reasons.insert(0, entry)
            del self._viol_reasons[self.RESPONSE_CACHE_SIZE :]
        return entry

    def reason_table(
        self,
        compiled: CompiledPolicy,
        view: DeviceView,
        policy_name: str,
        violations: frozenset,
        rule_map: Dict[int, int],
        n_rows: int,
    ) -> list:
        """Per-row JSON-encoded reason bytes (aligned with the violation
        mask) for the native Filter encoders, which splice them verbatim,
        so the bytes equal the exact path's ``json.dumps``.  Built once per
        (violation set, policy) and kept on its reason entry."""
        entry = self._reason_entry(compiled, view, policy_name, violations, rule_map)
        table = entry[4]
        if table is None or len(table) < n_rows:
            table = [None] * n_rows
            index = view.node_index
            for name, reason in entry[2].items():
                row = index.get(name)
                if row is not None and row < n_rows:
                    table[row] = json.dumps(reason).encode()
            entry[4] = table
        return table

    def _violation_mask(self, violations: frozenset, n_rows: int) -> bytes:
        """A violation set as one uint8 a row, the native encoders' form;
        cached per set identity and row count."""
        with self._lock:
            for idx, e in enumerate(self._viol_masks):
                if e[0] is violations and e[1] == n_rows:
                    if idx:
                        self._viol_masks.insert(0, self._viol_masks.pop(idx))
                    return e[2]
        mask = np.zeros(n_rows, dtype=np.uint8)
        rows = np.fromiter((i for i in violations if i < n_rows), dtype=np.int64)
        mask[rows] = 1
        mask_bytes = mask.tobytes()
        with self._lock:
            self._viol_masks.insert(0, [violations, n_rows, mask_bytes])
            del self._viol_masks[self.RESPONSE_CACHE_SIZE :]
        return mask_bytes

    def filter_parsed(
        self,
        wirec,
        compiled: CompiledPolicy,
        view: DeviceView,
        parsed,
        violations: frozenset,
        policy_name: str,
        universe=None,
    ) -> Tuple[bytes, int]:
        """The NodeNames-mode Filter body through the wire extension: row
        lookup, the violation split and assembly in ``filter_encode`` over
        the parsed body's name slices, or in ``filter_respond`` over an
        interned ``universe``'s cached row map.  FailedNodes carry the
        per-rule reasons of :meth:`reason_table`.  Returns (body, failed
        count); the bytes equal the exact path's."""
        table = self._table_for(view)
        n_rows = len(table.node_names)
        mask = self._violation_mask(violations, n_rows)
        reasons = None
        rule_map = self.violation_rule_map(compiled, view)
        if rule_map is not None:
            reasons = self.reason_table(compiled, view, policy_name, violations, rule_map, n_rows)
        if universe is not None:
            return wirec.filter_respond(universe, table.native(wirec), mask, reasons)
        return wirec.filter_encode(parsed, table.native(wirec), mask, reasons)

    # -- filter response reuse -------------------------------------------------

    def filter_lookup(
        self, violations: frozenset, policy_name: str, use_node_names: bool, parsed, universe=None
    ) -> Optional[Tuple[bytes, int]]:
        """The cached (body, failed count) of this candidate span under
        this violation set and policy, or None.  With an interned
        ``universe`` the skeleton layer is probed first (identity compares
        only); a span-cache hit is promoted into it."""
        with self._lock:
            if universe is not None:
                skeletons = self._filter_skeletons
                for idx, e in enumerate(skeletons):
                    if e[0] is violations and e[1] == policy_name and e[2] is universe:
                        if idx:
                            skeletons.insert(0, skeletons.pop(idx))
                        return e[3], e[4]
            responses = self._filter_responses
            for idx, e in enumerate(responses):
                if (
                    e[0] is violations
                    and e[1] == policy_name
                    and e[2] == use_node_names
                    and parsed.span_matches(use_node_names, e[3])
                ):
                    if idx:
                        responses.insert(0, responses.pop(idx))
                    if universe is not None:
                        self._filter_skeletons.insert(0, [violations, policy_name, universe, e[4], e[5]])
                        del self._filter_skeletons[self.RESPONSE_CACHE_SIZE :]
                    return e[4], e[5]
        return None

    def filter_store(
        self,
        violations: frozenset,
        policy_name: str,
        use_node_names: bool,
        parsed,
        body: bytes,
        n_failed: int,
        universe=None,
    ) -> None:
        """Keep a Filter body under its key: the skeleton layer with an
        interned ``universe``, else the span cache."""
        if universe is not None:
            with self._lock:
                self._filter_skeletons.insert(0, [violations, policy_name, universe, body, n_failed])
                del self._filter_skeletons[self.RESPONSE_CACHE_SIZE :]
            return
        span = parsed.node_names_span() if use_node_names else parsed.nodes_span()
        if span is None:
            return
        with self._lock:
            self._filter_responses.insert(0, [violations, policy_name, use_node_names, span, body, n_failed])
            del self._filter_responses[self.RESPONSE_CACHE_SIZE :]

    def _violation_set_counted(self, compiled: CompiledPolicy, view: DeviceView):
        """((violation frozenset, {row: rule index}), computed-now?) or None
        (no device rules)."""
        rules = compiled.dontschedule
        if rules is None:
            return None
        sig = _violation_sig(rules, view)
        cached = self._violations.get(sig)
        if cached is not None:
            return cached, False
        if compiled.device_rules("dontschedule") is None:
            return None
        _ranked, resolved = self._solve(view, (), [compiled])
        return resolved[sig], True

    # -- decision provenance ---------------------------------------------------

    def explain_prioritize(self, compiled: CompiledPolicy, view: DeviceView, k: int = 10):
        """(score head, ranked, node_index) for one policy at this state:
        the top-``k`` ``(node, ordinal score)`` pairs of the global ranking
        (shared by every decision record at this state) plus the ranking
        and interning table for the rank lookup at bind time."""
        table = self._table_for(view)
        ranked = self._ranking(view, compiled.scheduleonmetric_row, compiled.scheduleonmetric_op)
        with self._lock:
            for idx, entry in enumerate(self._explain_heads):
                if entry[0] is ranked and entry[1] is table:
                    if idx:
                        self._explain_heads.insert(0, self._explain_heads.pop(idx))
                    return entry[2], ranked, table.node_index
        names = table.node_names
        head = [(names[r], 10 - i) for i, r in enumerate(ranked[:k].tolist()) if r < len(names)]
        with self._lock:
            self._explain_heads.insert(0, [ranked, table, head])
            del self._explain_heads[self.RESPONSE_CACHE_SIZE :]
        return head, ranked, table.node_index
