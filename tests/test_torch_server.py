"""The port's extender server (``extender/server.py``) and wire types
(``extender/types.py``), held against the JAX package's: the middleware
and the routes answer with the same status, headers and bytes, and a
live socket carries exactly the bytes of the in-process route."""

import http.client
import json

import pytest

from platform_aware_scheduling_tpu.extender import server as jax_server
from platform_aware_scheduling_tpu.extender import types as jax_types
from platform_aware_scheduling_tpu.kube.objects import Node as JaxNode
from platform_aware_scheduling_tpu_torch.extender import server, types
from platform_aware_scheduling_tpu_torch.kube.objects import Node
from platform_aware_scheduling_tpu_torch.utils import trace

from test_torch_extender import Stacks, golden_stacks, policy_body, read_fixture

JSON = {"Content-Type": "application/json"}
NODENAMES_BODY = read_fixture("prioritize_request_upstream_nodenames.json")


@pytest.fixture(autouse=True)
def _pure_python_wire(monkeypatch):
    monkeypatch.setenv("PAS_TPU_NO_NATIVE", "1")


def servers(stacks):
    return jax_server.Server(stacks.jax), server.Server(stacks.port)


def route_both(stacks, method, path, headers, body=b""):
    """The port server's response, after checking it equals the JAX one."""
    jax_srv, port_srv = servers(stacks)
    want = jax_srv.route(jax_server.HTTPRequest(method, path, dict(headers), body))
    got = port_srv.route(server.HTTPRequest(method, path, dict(headers), body))
    assert (got.status, got.headers, got.body) == (want.status, want.headers, want.body)
    return got


MIDDLEWARE = {
    "ok": ("POST", "/scheduler/prioritize", JSON, 200),
    "charset_suffix": ("POST", "/scheduler/prioritize", {"Content-Type": "application/json; charset=utf-8"}, 404),
    "text_plain": ("POST", "/scheduler/filter", {"Content-Type": "text/plain"}, 404),
    "no_content_type": ("POST", "/scheduler/filter", {}, 404),
    "lowercase_header_name": ("POST", "/scheduler/filter", {"content-type": "application/json"}, 200),
    "get_verb": ("GET", "/scheduler/filter", JSON, 405),
    "put_verb": ("PUT", "/scheduler/prioritize", JSON, 405),
    "get_bind": ("GET", "/scheduler/bind", JSON, 405),
    "bind": ("POST", "/scheduler/bind", JSON, 404),
    "unknown_path": ("POST", "/scheduler/preempt", JSON, 404),
    "unknown_path_get": ("GET", "/nope", {}, 404),
    "query_on_verb": ("POST", "/scheduler/filter?x=1", JSON, 404),
}


@pytest.mark.parametrize("case", sorted(MIDDLEWARE))
def test_middleware(case):
    method, path, headers, status = MIDDLEWARE[case]
    got = route_both(golden_stacks(), method, path, headers, NODENAMES_BODY)
    assert got.status == status


def test_oversized_body_is_500():
    class HugeBody(bytes):
        def __len__(self):
            return server.MAX_CONTENT_LENGTH + 1

    request = server.HTTPRequest("POST", "/scheduler/filter", dict(JSON), HugeBody(b"{}"))
    assert server.apply_middleware(lambda r: server.HTTPResponse(), request).status == 500


# the JAX server's answers with every optional plane off; /debug/wire is
# its answer without a device fastpath (with one, it serves the wire
# caches: tests/test_torch_wire_extender.py)
PLANE_OFF_PATHS = sorted(set(server.PLANE_OFF) - {"/debug/profile"})


@pytest.mark.parametrize("path", PLANE_OFF_PATHS)
def test_unported_plane_endpoint_answers_as_plane_off(path):
    stacks = Stacks(mirror=path != "/debug/wire")
    method = server.PLANE_OFF[path][0]
    got = route_both(stacks, method, path, {})
    assert got.status == 404
    other = "GET" if method == "POST" else "POST"
    assert route_both(stacks, other, path, {}).status == 405


@pytest.mark.parametrize(
    "path,status",
    [
        ("/healthz", 200),
        ("/readyz", 200),
        ("/debug/traces?min_ms=abc", 400),
        ("/debug/decisions?limit=x", 400),
        ("/debug/explain", 400),
    ],
)
def test_observability_endpoint_matches_jax(path, status):
    got = route_both(golden_stacks(), "GET", path, {})
    assert got.status == status
    assert route_both(golden_stacks(), "POST", path, {}).status == 405


def test_debug_endpoints_and_index():
    port_srv = server.Server(golden_stacks().port, metrics_provider=lambda: "m 1\n")
    get = lambda path: port_srv.route(server.HTTPRequest("GET", path, {}, b""))  # noqa: E731
    index = json.loads(get("/debug").body)["endpoints"]
    assert [e["path"] for e in index] == [
        "/healthz", "/readyz", "/metrics", "/debug/traces", "/debug/decisions", "/debug/forecast",
        "/debug/leader", "/debug/wire", "/debug/explain",
    ]
    for entry in index:
        # no elector and no forecaster are wired here: /debug/leader and
        # /debug/forecast answer their plane-off 404s
        want = 404 if entry["path"] in ("/debug/leader", "/debug/forecast") else 200
        assert get(entry["path"] + ("?pod=default/p" if entry["path"] == "/debug/explain" else "")).status == want
    assert get("/metrics").body == b"m 1\n"
    ready = json.loads(get("/readyz").body)
    assert {c["name"] for c in ready["conditions"]} == {"kernels_warmed", "telemetry_fresh"}


def test_metrics_text_names_the_verbs_and_counters():
    stacks = golden_stacks()
    stacks.post("filter", NODENAMES_BODY)
    stacks.post("prioritize", NODENAMES_BODY)
    text = stacks.port.metrics_text()
    for needle in (
        'pas_request_duration_seconds_count{verb="filter"}',
        'pas_request_duration_seconds_count{verb="prioritize"}',
        "pas_filter_cache_bypass_total",
        "pas_prioritize_exact_total",
    ):
        assert needle in text


# -- a live socket ----------------------------------------------------------------


@pytest.fixture()
def live():
    stacks = golden_stacks()
    srv = server.Server(stacks.port, metrics_provider=stacks.port.metrics_text)
    srv.start_server(port="0", unsafe=True, host="127.0.0.1", block=False)
    assert srv.wait_ready()
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    yield stacks, srv, conn
    conn.close()
    srv.shutdown()


def _send(conn, method, path, body=b"", headers=JSON):
    conn.request(method, path, body=body, headers=dict(headers))
    resp = conn.getresponse()
    return resp.status, resp.getheader("Content-Type"), resp.read(), resp.getheader("X-Request-ID")


LIVE_CASES = [
    ("POST", "/scheduler/prioritize", NODENAMES_BODY, JSON),
    ("POST", "/scheduler/filter", NODENAMES_BODY, JSON),
    ("POST", "/scheduler/filter", read_fixture("prioritize_request_upstream.json"), JSON),
    ("POST", "/scheduler/prioritize", policy_body("golden-pol", ["gw-a", "nope"]), JSON),
    ("POST", "/scheduler/prioritize", b"", JSON),
    ("POST", "/scheduler/filter", policy_body("missing", ["gw-a"]), JSON),
    ("POST", "/scheduler/bind", read_fixture("bind_request_upstream.json"), JSON),
    ("POST", "/scheduler/filter", NODENAMES_BODY, {"Content-Type": "text/plain"}),
    ("GET", "/scheduler/filter", b"", JSON),
    ("GET", "/healthz", b"", {}),
    ("GET", "/debug/gangs", b"", {}),
]


def test_live_socket_bytes_equal_the_in_process_route(live):
    """One keep-alive connection carries every case; each answer equals
    the in-process route's, byte for byte."""
    stacks, srv, conn = live
    for method, path, body, headers in LIVE_CASES:
        want = srv.route(server.HTTPRequest(method, path, dict(headers), body))
        status, content_type, data, request_id = _send(conn, method, path, body, headers)
        assert (status, data) == (want.status, want.body), (method, path)
        assert content_type == want.headers.get("Content-Type")
        assert request_id
    for verb, golden in (("prioritize", "prioritize_nodenames_response.golden"),
                         ("filter", "filter_nodenames_response.golden")):
        assert _send(conn, "POST", f"/scheduler/{verb}", NODENAMES_BODY)[2] == read_fixture(golden)


def test_live_socket_spans_record_the_device_path(live):
    _stacks, _srv, conn = live
    trace.TRACES.clear()
    headers = {**JSON, "X-Request-ID": "rid-live-1"}
    assert _send(conn, "POST", "/scheduler/prioritize", NODENAMES_BODY, headers)[3] == "rid-live-1"
    spans = json.loads(_send(conn, "GET", "/debug/traces?verb=prioritize", headers={})[2])["recent"]
    assert [(s["id"], s["attrs"]["path"], s["status"]) for s in spans] == [("rid-live-1", "device", 200)]
    assert {"read", "decode", "kernel", "encode", "write"} <= {st["name"] for st in spans[0]["stages"]}
    metrics = _send(conn, "GET", "/metrics", headers={})[2].decode()
    assert 'pas_request_duration_seconds_count{verb="prioritize"}' in metrics


# -- wire types ------------------------------------------------------------------

ARGS_BODIES = [
    NODENAMES_BODY,
    read_fixture("prioritize_request_upstream.json"),
    read_fixture("prioritize_request_reference_style.json"),
    b'{"NodeNames": ["x"], "nodenames": ["y"], "NodeNames": ["z"], "pod": {"metadata": {"name": "p"}}}',
    b'{"Pod": {"metadata": null}, "nodes": {"items": [{"metadata": {"name": "n"}}]}}',
    b'{"Pod": {"metadata": {"name": "p", "labels": null}}, "Nodes": null, "NodeNames": null}',
    b'{"Pod": {"metadata": {"name": "p"}}, "NodeNames": ["a", null, "b"]}',
]


@pytest.mark.parametrize("index", range(len(ARGS_BODIES)))
def test_args_decode_like_jax(index):
    body = ARGS_BODIES[index]
    want = jax_types.Args.from_json(body)
    got = types.Args.from_json(body)
    assert got.pod.raw == want.pod.raw
    assert got.node_names == want.node_names
    assert (got.nodes is None) == (want.nodes is None)
    if got.nodes is not None:
        assert [n.raw for n in got.nodes] == [n.raw for n in want.nodes]
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize(
    "body",
    [b'{"Pod": 1}', b'{"NodeNames": "n"}', b'{"NodeNames": ["a", 1]}', b'{"Nodes": {"items": 3}}', b"[]"],
)
def test_args_decode_errors_like_jax(body):
    with pytest.raises(jax_types.DecodeError):
        jax_types.Args.from_json(body)
    with pytest.raises(types.DecodeError):
        types.Args.from_json(body)


def test_encoders_like_jax():
    hps = [("né-1", 10), ('quo"te', 9), ("plain", -3)]
    assert types.encode_host_priority_list(
        [types.HostPriority(h, s) for h, s in hps]
    ) == jax_types.encode_host_priority_list([jax_types.HostPriority(h, s) for h, s in hps])
    raw = {"metadata": {"name": "n1", "labels": {"a": "b"}}, "status": {}}
    for names, nodes in ((["n1", ""], True), (["n1"], False), ([], False)):
        port_result = types.FilterResult(
            nodes=[Node(raw)] if nodes else None, node_names=names,
            failed_nodes={"n2": "policy p: metric m=9 > threshold 8"}, error="",
        )
        jax_result = jax_types.FilterResult(
            nodes=[JaxNode(raw)] if nodes else None, node_names=names,
            failed_nodes={"n2": "policy p: metric m=9 > threshold 8"}, error="",
        )
        assert port_result.to_json() == jax_result.to_json()
    body = read_fixture("bind_request_upstream.json")
    got, want = types.BindingArgs.from_json(body), jax_types.BindingArgs.from_json(body)
    assert got.to_json() == want.to_json()
    assert types.BindingResult().to_json() == jax_types.BindingResult().to_json()


# -- mutual TLS ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tls_server(tmp_path_factory):
    from test_hardening import gen_certs

    ca, certs = gen_certs(tmp_path_factory.mktemp("certs"))
    srv = server.Server(golden_stacks().port)
    srv.start_server(
        port="0", cert_file=certs["server"][0], key_file=certs["server"][1], ca_file=ca,
        unsafe=False, host="127.0.0.1", block=False,
    )
    assert srv.wait_ready()
    yield srv, ca, certs
    srv.shutdown()


def _tls_post(srv, ca, client_cert=None, tls11=False):
    import ssl
    import urllib.request

    ctx = ssl.create_default_context(cafile=ca)
    ctx.check_hostname = False
    if client_cert:
        ctx.load_cert_chain(*client_cert)
    if tls11:
        ctx.minimum_version = ctx.maximum_version = ssl.TLSVersion.TLSv1_1
    req = urllib.request.Request(
        f"https://127.0.0.1:{srv.port}/scheduler/prioritize", data=NODENAMES_BODY, headers=JSON
    )
    with urllib.request.urlopen(req, timeout=10, context=ctx) as resp:
        return resp.status, resp.read()


@pytest.mark.parametrize("case", ["client_cert", "no_client_cert", "tls11"])
def test_mutual_tls(tls_server, case):
    import ssl
    import urllib.error

    srv, ca, certs = tls_server
    if case == "client_cert":
        assert _tls_post(srv, ca, certs["client"]) == (
            200, read_fixture("prioritize_nodenames_response.golden"))
        return
    with pytest.raises((ssl.SSLError, urllib.error.URLError, ConnectionError)):
        _tls_post(srv, ca, certs["client"] if case == "tls11" else None, tls11=case == "tls11")
