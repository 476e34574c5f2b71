"""Scheduler-extender protocol wire types (the port's copy of
``platform_aware_scheduling_tpu/extender/types.py``).

JSON field names EMITTED are the Go-default (capitalized) names of the
reference's re-implemented upstream types (reference extender/types.go:
22-82): ``FilterResult`` carries ``Nodes`` / ``NodeNames`` /
``FailedNodes`` / ``Error``; priorities are ``[{"Host": .., "Score": ..}]``.

Field names ACCEPTED are case-insensitive, because that is how the
reference actually interoperates: the real kube-scheduler marshals the
*upstream* extender types, whose json tags are lowercase (``pod`` /
``nodes`` / ``nodenames``; bindings ``podName`` / ``podNamespace`` /
``podUID`` / ``node`` — k8s.io/kube-scheduler/extender/v1), and the
reference's untagged Go structs decode them only via encoding/json's
case-insensitive field matching.  Go resolves every JSON key to its field
case-insensitively in document order, later assignments overwriting
earlier ones — reproduced here (the golden fixtures in tests/golden/
carry both key spellings).  Case-insensitivity is ASCII (an A-Z-only
fold): Go's ``strings.EqualFold`` additionally folds exotic Unicode
spellings (``ſ``→``s``, Kelvin ``K``→``k``) that no real JSON marshaler
emits for these fields — such keys are dropped here, as in the JAX
package (``str.lower`` would fold Kelvin ``K``, hence the explicit ASCII
table).

Envelope note on duplicate keys: field RESOLUTION (ASCII
case-insensitivity, document order, per-type null rules) matches Go on
every producible wire body, but when the same
object-valued field appears twice, the later OBJECT replaces the earlier
one wholesale (json.loads semantics), whereas Go would merge it per-field
into the existing struct.  Go marshalers cannot emit duplicate keys, so
no real wire producer exercises the difference.

Node objects are passed through as raw dicts so responses round-trip the
scheduler's own node JSON exactly.

Enforced decode scope (Go type-mismatch parity): a type-mismatched value
raises :class:`DecodeError` — which the verb handlers surface as the
reference's decode-failure empty-200 quirk — for EXACTLY these typed
fields:

  * ``Pod`` must be an object (or null); ``Pod.metadata`` an object;
    ``Pod.metadata.name`` / ``.namespace`` strings; ``Pod.metadata.labels``
    an object whose values are all strings;
  * ``Nodes`` must be an object; ``Nodes.items`` a list whose non-null
    entries are objects; ``items[].metadata`` an object;
    ``items[].metadata.name`` a string;
  * ``NodeNames`` must be a list of strings (null entries become "");
  * every ``BindingArgs`` field (``PodName`` / ``PodNamespace`` /
    ``PodUID`` / ``Node``) must be a string.

Everything OUTSIDE that list is accepted leniently as raw pass-through —
``Pod.spec``, ``Pod.status``, node ``labels`` / ``annotations`` /
``status``, and any unknown key may hold any JSON type without failing
the decode, even where Go's fully-typed structs would reject it (e.g. a
non-string node label).  The enforced set covers every field the verbs
read; the gap is observable only on hand-crafted bodies no real
kube-scheduler emits.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol

from platform_aware_scheduling_tpu_torch.kube.objects import Node, Pod


class DecodeError(ValueError):
    """Raised when a request body cannot be decoded into the expected type."""


def _loads_with_top_pairs(body: bytes):
    """json.loads plus the TOP-LEVEL object's (key, value) pairs in raw
    document order.  Needed for Go parity: a body carrying both an exact
    duplicate and a case-variant of one field (``{"Pod":A,"pod":B,
    "Pod":C}``) resolves to the LAST occurrence in document order in Go, but json.loads collapses the exact
    duplicates at their first position, which would re-order the fold.

    The hook fires for every object bottom-up, the outermost last — only
    that final call is kept (O(1) extra memory, not O(total keys))."""
    top: List[tuple] = []

    def hook(pairs):
        nonlocal top
        top = pairs
        return dict(pairs)

    obj = json.loads(body, object_pairs_hook=hook)
    return obj, (top if isinstance(obj, dict) else [])


# A-Z -> a-z only; unlike str.lower() this cannot fold non-ASCII
# spellings (Kelvin K, etc.)
_ASCII_LOWER = str.maketrans(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz"
)


def _require_obj(value, what: str):
    """Go decode parity: a field typed as an object accepts an object or
    null (null -> nil/zero value, returned as None); anything else is an
    UnmarshalTypeError -> DecodeError here."""
    if value is not None and not isinstance(value, dict):
        raise DecodeError(f"error decoding request: {what} is not an object")
    return value


def _normalize_string_field(container: Dict[str, Any], key: str, what: str):
    """Go decode parity for string-typed fields: strings pass, an explicit
    null becomes the zero value "" (in place), anything else is a decode
    error."""
    value = container.get(key)
    if value is None:
        if key in container:
            container[key] = ""
        return
    if not isinstance(value, str):
        raise DecodeError(f"error decoding request: {what} is not a string")


def _fold_keys(
    pairs, fields: Dict[str, str], nullable: frozenset = frozenset()
) -> Dict[str, Any]:
    """Go-unmarshal field resolution over raw-document-order (key, value)
    pairs: each JSON key matches a struct field case-insensitively, later
    assignments overwrite earlier ones.  ``fields`` maps lowercase wire
    name -> canonical name; unmatched keys are dropped (as Go ignores
    them).

    JSON ``null`` follows Go's per-type rule: decoding null into a
    pointer/slice/map field assigns nil (fields listed in ``nullable`` —
    ``Nodes`` / ``NodeNames`` are pointers in both the reference and
    upstream structs), while null into a value field (strings,
    struct-valued ``Pod``) "has no effect" — the earlier value, if any,
    survives."""
    out: Dict[str, Any] = {}
    for key, value in pairs:
        canonical = fields.get(key.translate(_ASCII_LOWER))
        if canonical is None:
            continue
        if value is None and canonical not in nullable:
            continue  # Go: null into a value field has no effect
        out[canonical] = value
    return out


@dataclass
class Args:
    """Arguments for Filter/Prioritize (reference extender/types.go:41-50)."""

    pod: Pod
    # populated when the extender is registered nodeCacheCapable: false
    nodes: Optional[List[Node]]
    # populated when the extender is registered nodeCacheCapable: true
    node_names: Optional[List[str]]

    @classmethod
    def from_json(cls, body: bytes) -> "Args":
        try:
            obj, top_pairs = _loads_with_top_pairs(body)
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise DecodeError(f"error decoding request: {exc}") from exc
        if not isinstance(obj, dict):
            raise DecodeError("error decoding request: not an object")
        # accept both the reference's capitalized keys and the upstream
        # kube-scheduler's lowercase tags ("pod"/"nodes"/"nodenames"),
        # exactly as Go's case-insensitive unmarshal does (module doc)
        folded = _fold_keys(
            top_pairs,
            {"pod": "Pod", "nodes": "Nodes", "nodenames": "NodeNames"},
            nullable=frozenset({"Nodes", "NodeNames"}),
        )
        # type-mismatched fields are Go decode errors (json.Unmarshal into
        # the typed structs fails -> the empty-200 decode-failure quirk),
        # not values to limp along with; an explicit null into a string
        # field is Go's "no effect" -> the zero value "".
        pod_obj = _require_obj(folded.get("Pod"), "Pod") or {}
        md = _require_obj(pod_obj.get("metadata"), "Pod metadata")
        if md is not None:
            _normalize_string_field(md, "name", "Pod name")
            _normalize_string_field(md, "namespace", "Pod namespace")
            labels = _require_obj(md.get("labels"), "Pod labels")
            if labels is not None:
                for key in labels:
                    _normalize_string_field(labels, key, f"label {key!r}")
        pod = Pod(pod_obj)
        nodes_obj = _require_obj(folded.get("Nodes"), "Nodes")
        nodes = None
        if nodes_obj is not None:
            items = nodes_obj.get("items")
            if items is not None and not isinstance(items, list):
                raise DecodeError(
                    "error decoding request: Nodes.items is not a list"
                )
            for item in items or []:
                # a null list element is Go's zero-value Node (name "");
                # any other non-object fails the decode
                if item is None:
                    continue
                if not isinstance(item, dict):
                    raise DecodeError(
                        "error decoding request: node is not an object"
                    )
                imd = _require_obj(item.get("metadata"), "node metadata")
                if imd is not None:
                    _normalize_string_field(imd, "name", "node name")
            nodes = [Node(item) for item in (items or [])]
        node_names = folded.get("NodeNames")
        if node_names is not None:
            if not isinstance(node_names, list):
                raise DecodeError(
                    "error decoding request: NodeNames is not a list"
                )
            # one C-level pass for the usual all-strings list; the entry
            # loop below only runs when some entry is not a string
            if not set(map(type, node_names)) <= {str}:
                fixed = []
                for entry in node_names:
                    if entry is None:
                        fixed.append("")  # Go: null into string = zero value
                    elif not isinstance(entry, str):
                        raise DecodeError(
                            "error decoding request: NodeNames entry is not "
                            "a string"
                        )
                    else:
                        fixed.append(entry)
                node_names = fixed
        return cls(pod=pod, nodes=nodes, node_names=node_names)

    @classmethod
    def from_parsed(cls, parsed, node_names) -> "Args":
        """Args from the native wire view of a NodeNames-mode request
        (``_wirec_torch.ParsedArgs``) plus an already-materialized
        candidate list, typically an interned universe's shared name
        tuple, so a repeat request builds no per-name Python object.

        The content equals :meth:`from_json`'s for every field the Filter
        path reads (pod name and namespace, the ``telemetry-policy``
        label, the candidate names): the scanner applies the same Go
        decode rules and rejects (ValueError -> exact path) every body
        where the two could differ.  Fields the wire view does not keep
        (other pod labels, the pod spec) are absent."""
        metadata: Dict[str, Any] = {}
        if parsed.pod_name is not None:
            metadata["name"] = parsed.pod_name
        if parsed.pod_namespace is not None:
            metadata["namespace"] = parsed.pod_namespace
        label = parsed.policy_label
        if label is not None:
            metadata["labels"] = {"telemetry-policy": label}
        pod = Pod({"metadata": metadata} if metadata else {})
        return cls(pod=pod, nodes=None, node_names=node_names)

    def to_json(self) -> bytes:
        nodes = None
        if self.nodes is not None:
            nodes = {"metadata": {}, "items": [n.raw for n in self.nodes]}
        return json.dumps(
            {"Pod": self.pod.raw, "Nodes": nodes, "NodeNames": self.node_names}
        ).encode()


@dataclass
class HostPriority:
    """Priority of one host; higher is better (reference extender/types.go:26)."""

    host: str
    score: int

    def to_obj(self) -> Dict[str, Any]:
        return {"Host": self.host, "Score": self.score}


def encode_host_priority_list(items: List[HostPriority]) -> bytes:
    return (json.dumps([hp.to_obj() for hp in items]) + "\n").encode()


@dataclass
class FilterResult:
    """Filter verb response (reference extender/types.go:53-64)."""

    nodes: Optional[List[Node]] = None
    node_names: Optional[List[str]] = None
    failed_nodes: Dict[str, str] = field(default_factory=dict)
    error: str = ""

    def to_obj(self) -> Dict[str, Any]:
        nodes = None
        if self.nodes is not None:
            items = [n.raw for n in self.nodes] if self.nodes else None
            nodes = {"metadata": {}, "items": items}
        return {
            "Nodes": nodes,
            "NodeNames": self.node_names,
            "FailedNodes": self.failed_nodes if self.failed_nodes is not None else None,
            "Error": self.error,
        }

    def to_json(self) -> bytes:
        return (json.dumps(self.to_obj()) + "\n").encode()

    @classmethod
    def from_json(cls, body: bytes) -> "FilterResult":
        obj = json.loads(body)
        nodes = None
        nodes_obj = obj.get("Nodes")
        if nodes_obj is not None:
            nodes = [Node(item) for item in (nodes_obj.get("items") or [])]
        return cls(
            nodes=nodes,
            node_names=obj.get("NodeNames"),
            failed_nodes=obj.get("FailedNodes") or {},
            error=obj.get("Error") or "",
        )


@dataclass
class BindingArgs:
    """Bind verb arguments (reference extender/types.go:67-76)."""

    pod_name: str
    pod_namespace: str
    pod_uid: str
    node: str

    @classmethod
    def from_json(cls, body: bytes) -> "BindingArgs":
        try:
            obj, top_pairs = _loads_with_top_pairs(body)
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise DecodeError(f"error decoding request: {exc}") from exc
        if not isinstance(obj, dict):
            raise DecodeError("error decoding request: not an object")
        # upstream ExtenderBindingArgs tags are podName/podNamespace/
        # podUID/node; the reference's untagged struct accepts either
        # spelling via Go case-insensitive matching — so do we
        folded = _fold_keys(
            top_pairs,
            {
                "podname": "PodName",
                "podnamespace": "PodNamespace",
                "poduid": "PodUID",
                "node": "Node",
            },
        )
        # Go decode parity, as in Args.from_json: every field is a string
        # (null has no effect and was already dropped by _fold_keys for
        # these value-typed fields); anything else fails the decode
        for key in folded:
            _normalize_string_field(folded, key, key)
        return cls(
            pod_name=folded.get("PodName", ""),
            pod_namespace=folded.get("PodNamespace", ""),
            pod_uid=folded.get("PodUID", ""),
            node=folded.get("Node", ""),
        )

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "PodName": self.pod_name,
                "PodNamespace": self.pod_namespace,
                "PodUID": self.pod_uid,
                "Node": self.node,
            }
        ).encode()


@dataclass
class BindingResult:
    """Bind verb response (reference extender/types.go:79-82)."""

    error: str = ""

    def to_json(self) -> bytes:
        return (json.dumps({"Error": self.error}) + "\n").encode()

    @classmethod
    def from_json(cls, body: bytes) -> "BindingResult":
        obj = json.loads(body)
        return cls(error=obj.get("Error") or "")


class Scheduler(Protocol):
    """The three scheduler verbs an extender implements
    (reference extender/types.go:11-15).  Handlers receive the parsed HTTP
    request and return the response to send."""

    def filter(self, request: "HTTPRequest") -> "HTTPResponse": ...

    def prioritize(self, request: "HTTPRequest") -> "HTTPResponse": ...

    def bind(self, request: "HTTPRequest") -> "HTTPResponse": ...


# imported late to avoid a cycle; re-exported for typing convenience
from platform_aware_scheduling_tpu_torch.extender.server import (  # noqa: E402
    HTTPRequest,
    HTTPResponse,
)
