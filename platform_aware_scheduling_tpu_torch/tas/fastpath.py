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
  * a request then costs a candidate-row lookup, a numpy subsequence
    selection and JSON assembly from per-node byte fragments.

The JAX module's native-wire parts (interned universes, response
skeletons, the Filter response cache) wait for the native wire path.
"""

from __future__ import annotations

import json
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


class _ViewTable:
    """Per-interning-version request-time tables: name -> row index and
    pre-rendered JSON fragments.  Keyed by the view's ``intern_version``,
    so pure value churn keeps the table until a new node appears."""

    __slots__ = ("version", "node_index", "node_names", "node_capacity", "_fragments")

    def __init__(self, view: DeviceView):
        self.version = view.intern_version
        self.node_index = view.node_index  # immutable snapshot dict
        self.node_names = view.node_names
        self.node_capacity = view.node_capacity
        self._fragments: Optional[List[bytes]] = None

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

    # MRU bound of the per-state reason maps and score heads
    RESPONSE_CACHE_SIZE = 32

    def __init__(self):
        self._lock = threading.Lock()
        self._table: Optional[_ViewTable] = None
        # (row content version, metric row, op) -> int64 np global order
        self._rank: Dict[Tuple[int, int, int], np.ndarray] = {}
        # violation sig -> (frozenset of violating rows, {row: first rule})
        self._violations: Dict[Tuple, Tuple[frozenset, Dict[int, int]]] = {}
        # [violations, policy_name, {name: reason}, {name: rule index}], MRU
        self._viol_reasons: List[list] = []
        # [ranked, table, top-K (name, score) head], MRU
        self._explain_heads: List[list] = []

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

    def precompute(
        self, view: DeviceView, pairs, policies: Sequence[CompiledPolicy] = ()
    ) -> int:
        """Warm the request-time state at ``view``: the fragment table,
        the rankings of ``pairs`` and the violation sets of ``policies``
        (one device pass, one readback; see :meth:`_solve`).  Then prune
        entries whose rows have moved on.  Returns the pairs ranked."""
        self._table_for(view).fragments
        ranked, _ = self._solve(view, pairs, policies)
        with self._lock:
            self._rank = {k: v for k, v in self._rank.items() if k[0] == view.row_version(k[1])}
            self._violations = {
                k: v
                for k, v in self._violations.items()
                if k[0] == tuple(view.row_version(r) for r in k[1])
            }
        return ranked

    # -- prioritize ------------------------------------------------------------

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
        entry = [violations, policy_name, reasons, indexes]
        with self._lock:
            for existing in self._viol_reasons:
                if existing[0] is violations and existing[1] == policy_name:
                    return existing  # another thread built it first
            self._viol_reasons.insert(0, entry)
            del self._viol_reasons[self.RESPONSE_CACHE_SIZE :]
        return entry

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
