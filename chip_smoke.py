#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``platform_aware_scheduling_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card (the greedy-assign
kernel also against the plain model of its two stages, rescan count
included), then drives the batch planner's main path at full size — 10,000
nodes, 8 metrics, 4 TAS policies, 1,000 pending pods — through 5 sync
periods, checking every plan against the same planner on the CPU and that
each replan launched the kernel once.  Then it serves the TAS verbs
(Filter, Prioritize, Bind) from the port's ``Server`` on 127.0.0.1 over a
CUDA-mirror extender steered by that planner, through the native wire
path (the ``_wirec_torch`` extension, built with ``cc`` beside the
kernels; the run fails without it), holds every response against a
CPU-mirror extender and the host path with the extension off, and times
native Prioritize, Filter hits and Filter misses, then both verbs on the
exact path, holding the native verbs' p99, warm-pass and replan times to
the limits ``PERF.md`` section 2 sets.  Then the service phase runs the TAS service as ``cmd/tas.main``
wires it (degraded mode, leader election) over the port's fake API server
at the same size, and the faults phase adds a second replica and drives a
metrics-API outage, a kube-API outage and a failover through a shared
FaultPlan.  Last, the GAS phase serves the GAS extender as ``cmd/gas.main``
wires it over a 10,000-node GPU cluster in the fake API server and drives
a burst of 300 Filters and their Binds over a socket, every Filter held
against a CPU-mirror twin and the host loop; each Filter that misses the
fits cache launches the CUDA first-fit bin-pack kernel once (held exactly
against its plain version on the card beforehand, on edge cases, random
states and a state for every template instance, whose registers and stack
``nvcc -Xptxas -v`` reports).  Then the forecast phase assembles the TAS
service with ``--forecast=on`` over the verbs phase's world and drives 40
churned refresh passes, each staging its new samples into the history
ring on the card and launching the CUDA Holt forecast kernel once on it
(held exactly against its plain version on edge cases beforehand, as
``[M, N, W]`` stagings and as rings, and on every pass), serves 500
native Prioritize requests ranked on the forecasts (each equal to a CPU
twin's and the host path's) beside 500 ranked on the snapshot, times
Prioritize while 32 more passes refit (what the slowest request
overlapped: the refit's stages, collections, lock waits), and rides a
metrics-API outage past the last-known-good window on extrapolated
forecasts.  Then the solvers phase assembles the TAS planner with
``--batchSolver=sinkhorn`` on the card beside a CPU twin over the same
world and replans both each of 4 periods: every card replan launches the
greedy kernel once to round its Sinkhorn plan, each assignment is
feasible, its guide within a stated number of micro-nats of the twin's
and its rounding equal to the plain greedy's, and the auction fixpoint
equals the greedy kernel on the planner phase's inputs.  Last, the fused
phase solves BASELINE config #4 (10,000 nodes x 1,000 pods, 8 cards, 3
resources, 3 request classes) with ``models/fused.fused_schedule``: three
bin-pack launches and one launch of the CUDA fused-scan kernel a solve,
held exactly against the plain solve on the card there and on edge cases.
Prints the card, the timings (the greedy
kernel's two stages and its rescans at the main path's inputs and three
others; the verbs' p50/p99, their slowest requests' stages and the warm
passes; the partition counters each timed run moved and the wire
caches; GAS Filter and Bind p50/p99; each kernel's device time, from 50
calls captured in a CUDA graph and from ``torch.profiler``, beside the
time of its wrapper's calls), a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result line, when there is no GPU, when the package is not beside this
script, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from collections import namedtuple
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
PACKAGE = "platform_aware_scheduling_tpu_torch"

NUM_NODES = 10_000
NUM_METRICS = 8
NUM_PODS = 1_000
SYNC_PERIODS = 5
ALLOCATABLE_PODS = 110  # kubelet default, as the planner assumes
FULL_NODE_SHARE = 0.10  # nodes whose 110 slots are all bound
NEARLY_FULL_SHARE = 0.05  # nodes with 1-5 slots left
CHURN = 0.3  # share of node values that move each sync period
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
VECTOR_OPS_PER_S = 67e12  # H100 SXM data sheet: float32 outside the tensor cores
SEED = 0
# the end-to-end limits of PERF.md section 2, held on the card
VERB_P99_LIMIT_MS = 30.0
VERB_P99_TARGET_MS = 20.0  # the JAX package's target, reported against the native path, not held
REFRESH_WARM_LIMIT_MS = 250.0
REPLAN_P50_LIMIT_MS = 100.0


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


# -- phase 1: the card -----------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernel parity --------------------------------------------------------


def parity_cases(torch, np, max_nodes: int, list_size: int):
    """(name, score, eligible, capacity) on the card, from numpy seeds."""
    rng = np.random.default_rng(SEED)

    def put(array):
        return torch.from_numpy(np.ascontiguousarray(array)).cuda()

    def random_case(name, p, n, cap_hi=3, p_ok=0.7):
        score = rng.integers(-(2**62), 2**62, size=(p, n), dtype=np.int64)
        eligible = rng.random((p, n)) < p_ok
        capacity = rng.integers(0, cap_hi, size=n).astype(np.int32)
        return name, put(score), put(eligible), put(capacity)

    cases = [
        random_case("random 1x1", 1, 1),
        random_case("random 7x1", 7, 1),
        random_case("random 33x257", 33, 257),
        random_case("random 129x1025", 129, 1025),
        random_case("random 301x4099", 301, 4099),
        random_case("random 1000x1023", 1000, 1023, cap_hi=2),
    ]
    p, n = 500, 300
    cases.append(
        (
            "contention 500x300 equal scores, capacity 1",
            put(np.zeros((p, n), np.int64)),
            put(np.ones((p, n), bool)),
            put(np.ones(n, np.int32)),
        )
    )
    edges = np.array(
        [-(2**63), 2**63 - 1, 2**31, -(2**31), 2**32 - 1, -1, 0, 1], dtype=np.int64
    )
    score = rng.choice(edges, size=(64, 67))
    score[5, :] = -(2**63)  # a row whose only values are INT64_MIN
    cases.append(
        ("edge values", put(score), put(rng.random((64, 67)) < 0.8), put(np.full(67, 2, np.int32)))
    )
    cases.append(
        (
            "all lanes ineligible",
            put(rng.integers(-9, 9, size=(40, 513), dtype=np.int64)),
            put(np.zeros((40, 513), bool)),
            put(np.ones(513, np.int32)),
        )
    )
    cases.append(random_case(f"shared-memory limit 64x{max_nodes}", 64, max_nodes))
    cases.append(random_case("slice shape 1000x10000", 1000, 10_000))
    # the staged kernel's own paths: lists of exactly K-1, K and K+1 lanes
    # used up under contention, the main path's padded shape, rows with
    # fewer than K ok lanes, and rows that start at every alignment
    for n in (list_size - 1, list_size, list_size + 1):
        cases.append(
            (
                f"contention {n + 8}x{n} equal scores, capacity 1",
                put(np.zeros((n + 8, n), np.int64)),
                put(np.ones((n + 8, n), bool)),
                put(np.ones(n, np.int32)),
            )
        )
    p, n, real = 1000, 16_384, 10_000
    score = rng.integers(0, 100_000, size=(p, n), dtype=np.int64)
    eligible = rng.random((p, n)) < 0.97
    eligible[:, real:] = False
    capacity = rng.integers(0, 111, size=n).astype(np.int32)
    cases.append((f"padded {p}x{n}, columns {real}: ineligible", put(score), put(eligible), put(capacity)))
    eligible = np.zeros((200, 2048), bool)
    for pod in range(200):
        eligible[pod, rng.choice(2048, size=pod % (list_size + 2), replace=False)] = True
    cases.append(
        (
            f"200x2048, rows with 0..{list_size + 1} eligible lanes",
            put(rng.integers(-5, 5, size=(200, 2048), dtype=np.int64)),
            put(eligible),
            put(rng.integers(0, 3, size=2048).astype(np.int32)),
        )
    )
    cases.append(random_case("odd N 97x1001, rows at every alignment", 97, 1001, cap_hi=4))
    # a view one row into larger tensors: contiguous, but the score rows
    # start 8 bytes off 16-byte alignment, so every row takes the scalar path
    score = put(rng.integers(-(2**62), 2**62, size=(41, 515), dtype=np.int64))[1:]
    eligible = put(rng.random((41, 515)) < 0.7)[1:]
    cases.append(("misaligned base 40x515", score, eligible, put(rng.integers(0, 3, 515).astype(np.int32))))
    # two inputs timed beside the main path's: scores that rise with the
    # node index (every lane enters a warp's list in stage 1), and four
    # score rows shared by 1000 pods on nodes that hold one pod each (most
    # pods use up their list and rescan)
    p, n = 1000, 16_384
    cases.append(
        (
            f"ascending scores {p}x{n}",
            put(np.broadcast_to(np.arange(n, dtype=np.int64), (p, n))),
            put(np.ones((p, n), bool)),
            put(np.full(n, ALLOCATABLE_PODS, np.int32)),
        )
    )
    rows = rng.integers(-(2**62), 2**62, size=(4, n), dtype=np.int64)
    cases.append(
        (
            f"shared rows, capacity 1 {p}x{n}",
            put(rows[np.arange(p) % 4]),
            put(np.ones((p, n), bool)),
            put(np.ones(n, np.int32)),
        )
    )
    return cases


def run_parity(torch, cases) -> int:
    """Kernel against plain version, exactly, on every case, and against
    the staged plain model at the kernel's K, rescan count included;
    returns the largest absolute difference seen (0 when exact)."""
    from platform_aware_scheduling_tpu_torch.ops.assign import (
        greedy_assign_reference,
        greedy_assign_staged_reference,
    )
    from platform_aware_scheduling_tpu_torch.ops.cuda_assign import (
        greedy_assign_cuda_with_rescans,
        list_size,
    )

    max_err = 0
    for name, score, eligible, capacity in cases:
        got, rescans = greedy_assign_cuda_with_rescans(score, eligible, capacity)
        torch.cuda.synchronize()
        want = greedy_assign_reference(score, eligible, capacity)
        staged, staged_rescans = greedy_assign_staged_reference(
            score, eligible, capacity, list_size()
        )
        torch.cuda.synchronize()
        for out, ref, model in zip(got, want, staged):
            check(out.dtype == ref.dtype and out.shape == ref.shape, f"{name}: output form")
            err = (out.long() - ref.long()).abs().max().item() if out.numel() else 0
            max_err = max(max_err, err)
            check(torch.equal(out, ref), f"{name}: kernel disagrees with the plain version")
            check(torch.equal(out, model), f"{name}: kernel disagrees with the staged model")
        check(
            int(rescans.item()) == staged_rescans,
            f"{name}: kernel rescanned {int(rescans.item())} pods, the staged model {staged_rescans}",
        )
        print(
            f"parity {name}: exact ({int((got.node_for_pod >= 0).sum())} pods placed, "
            f"{staged_rescans} rescans)"
        )
    return max_err


def check_node_limit(torch, limit: int) -> None:
    from platform_aware_scheduling_tpu_torch.ops.cuda_assign import greedy_assign_cuda

    z = torch.zeros((1, limit + 1), dtype=torch.int64, device="cuda")
    try:
        greedy_assign_cuda(z, z.bool(), z[0].int())
    except ValueError:
        print(f"parity: N={limit + 1} refused above the {limit}-node shared-memory limit")
        return
    raise SmokeError("N beyond the shared-memory limit was not refused")


# -- phase 4: the main path --------------------------------------------------------


def policies(rule):
    """4 TAS policies: scheduleonmetric LessThan/GreaterThan, 1-2 dontschedule."""
    return {
        "pol-0": {
            "scheduleonmetric": [rule("metric0", "LessThan", 0)],
            "dontschedule": [rule("metric4", "GreaterThan", 90)],
        },
        "pol-1": {
            "scheduleonmetric": [rule("metric1", "GreaterThan", 0)],
            "dontschedule": [
                rule("metric5", "GreaterThan", 95),
                rule("metric6", "LessThan", 3),
            ],
        },
        "pol-2": {
            "scheduleonmetric": [rule("metric2", "LessThan", 0)],
            "dontschedule": [rule("metric7", "GreaterThan", 92)],
        },
        "pol-3": {
            "scheduleonmetric": [rule("metric3", "GreaterThan", 0)],
            "dontschedule": [
                rule("metric4", "GreaterThan", 97),
                rule("metric0", "LessThan", 2),
            ],
        },
    }


def rule(metricname, operator, target):
    return {"metricname": metricname, "operator": operator, "target": target}


METRIC_NAMES = [f"metric{j}" for j in range(NUM_METRICS)]


def write_policies(cache) -> None:
    """The policies, then each metric's registration, as the policy
    controller writes them."""
    from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy

    for name, strategies in policies(rule).items():
        obj = {
            "metadata": {"name": name, "namespace": "default"},
            "spec": {
                "strategies": {
                    kind: {"policyName": name, "rules": rules}
                    for kind, rules in strategies.items()
                }
            },
        }
        cache.write_policy("default", name, TASPolicy.from_obj(obj))
    for metric in METRIC_NAMES:
        cache.write_metric(metric)


def run_main_path(torch, np, device: str, on_replan=None) -> dict:
    """Drive cache -> mirror -> planner at full size on ``device``, each
    plan checked against the same planner on the CPU.  The returned world
    (cache, mirrors, planners, metrics client, ``refresh``) carries on
    into the verbs phase."""
    from platform_aware_scheduling_tpu_torch.kube.objects import Node, Pod, object_key
    from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
    from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
    from platform_aware_scheduling_tpu_torch.tas.metrics import DummyMetricsClient, NodeMetric
    from platform_aware_scheduling_tpu_torch.tas.planner import BatchPlanner
    from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity

    rng = np.random.default_rng(SEED)
    setup_start = time.perf_counter()
    cache = AutoUpdatingCache()
    mirrors = {name: TensorStateMirror(device=dev) for name, dev in (("dut", device), ("cpu", "cpu"))}
    for mirror in mirrors.values():
        mirror.attach(cache)
    planners = {
        name: BatchPlanner(cache, mirror, device=mirror.device) for name, mirror in mirrors.items()
    }
    write_policies(cache)
    metric_names = METRIC_NAMES

    nodes = [f"node-{i:05d}" for i in range(NUM_NODES)]
    order = rng.permutation(NUM_NODES)
    full = order[: int(NUM_NODES * FULL_NODE_SHARE)]
    nearly = order[len(full) : len(full) + int(NUM_NODES * NEARLY_FULL_SHARE)]
    bound = {int(i): ALLOCATABLE_PODS for i in full}
    bound.update({int(i): ALLOCATABLE_PODS - int(rng.integers(1, 6)) for i in nearly})
    node_objs = [
        Node({"metadata": {"name": n}, "status": {"allocatable": {"pods": str(ALLOCATABLE_PODS)}}})
        for n in nodes
    ]
    bound_pods = [
        Pod(
            {
                "metadata": {"name": f"bound-{i}-{k}", "namespace": "default"},
                "spec": {"nodeName": nodes[i]},
                "status": {"phase": "Running"},
            }
        )
        for i, count in bound.items()
        for k in range(count)
    ]
    pending = [
        Pod(
            {
                "metadata": {
                    "name": f"pending-{i}",
                    "namespace": "default",
                    "labels": {"telemetry-policy": f"pol-{i % 4}"},
                },
                "spec": {},
                "status": {"phase": "Pending"},
            }
        )
        for i in range(NUM_PODS)
    ]
    for planner in planners.values():
        for node in node_objs:
            planner.node_changed(node)
        for pod in bound_pods:
            planner.pod_observed(pod)
        for pod in pending:
            planner.pod_added(pod)

    # values in milli-units over [0, 100) whole units; targets are whole units
    values = rng.integers(0, 100_000, size=(NUM_METRICS, NUM_NODES))
    client = DummyMetricsClient()

    def refresh():
        moved = rng.random(values.shape) < CHURN
        values[...] = np.where(moved, rng.integers(0, 100_000, size=values.shape), values)
        for j, metric in enumerate(metric_names):
            client.store[metric] = {
                n: NodeMetric(value=Quantity(f"{int(v)}m")) for n, v in zip(nodes, values[j])
            }
        cache.update_all_metrics(client)

    def replan_both():
        start = time.perf_counter()
        planned = planners["dut"].replan()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - start
        check(planners["cpu"].replan() == planned, "planned-pod count differs from the CPU planner")
        got = {object_key(p): planners["dut"].planned_node(p) for p in pending}
        want = {object_key(p): planners["cpu"].planned_node(p) for p in pending}
        check(got == want, "plan differs from the CPU planner")
        check(planned > 0, "nothing was planned")
        return planned, wall

    refresh()
    setup_s = time.perf_counter() - setup_start
    replan_both()  # warm-up: the first view upload and plan
    view = mirrors["dut"].device_view()
    check(
        view.values.device.type == device and view.present.device.type == device,
        "mirror tensors are not on the device",
    )
    check(planners["dut"].device.type == device, "planner is not on the device")

    if on_replan is not None:
        on_replan("reset")
    walls, planned_counts = [], []
    for _period in range(SYNC_PERIODS):
        refresh()
        planned, wall = replan_both()
        walls.append(wall)
        planned_counts.append(planned)
        if on_replan is not None:
            on_replan("replan")
    # the last replan's kernel inputs: nothing changed since, so the
    # planner's problem is the one it just solved
    from platform_aware_scheduling_tpu_torch.models.batch_scheduler import score_and_filter

    inputs = planners["dut"].solve_inputs()
    _violating, score, eligible = score_and_filter(inputs.state, inputs.pods)
    return {
        "cache": cache,
        "mirrors": mirrors,
        "planners": planners,
        "client": client,
        "refresh": refresh,
        "values": values,
        "nodes": nodes,
        "pending": pending,
        "planner": planners["dut"],
        "kernel_inputs": (score, eligible, inputs.state.capacity),
        "setup_s": setup_s,
        "replan_wall_s": walls,
        "planned": planned_counts,
        "view_shape": tuple(inputs.view.values.shape),
        "full_nodes": len(full),
        "nearly_full_nodes": len(nearly),
        "bound_pods": len(bound_pods),
    }


# -- phase 5: times -----------------------------------------------------------------


def cuda_ms(torch, fn, repeats: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def graph_ms(torch, fn, repeats: int, replays: int = 5) -> float:
    """The device time of one call of ``fn``, apart from its wrapper's host
    work: ``repeats`` calls captured in one CUDA graph (the wrapper's
    ``torch.empty`` calls allocate from the graph's pool, its launches go
    to the capturing stream), the graph replayed between two events; the
    median over ``replays`` replays of their time over ``repeats``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the stream to be captured
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / repeats)
    return statistics.median(times)


def profiled_ms(torch, fn, kernels, repeats: int):
    """The device time of one call of ``fn`` by ``torch.profiler``: the
    CUDA time of the kernels whose names hold one of ``kernels`` over
    ``repeats`` calls; None where the trace shows no such device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        getattr(event, "device_time_total", 0)
        for event in prof.key_averages()
        if any(name in event.key for name in kernels)
    )
    return total_us / repeats / 1e3 if total_us > 0 else None


def ms_or_not_measured(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def time_kernel(torch, score, eligible, capacity, profiled: bool = False) -> dict:
    """Kernel, stage and plain-version times on one problem, the stage-2
    rescan count, and the least time the card could take: the bytes the
    function must move over the card's memory rate.  It must read the whole eligible mask, the score of every
    eligible lane, the capacity, and write the result and the capacity
    left; the dense figure counts every score as read.  ``ms`` is the
    device time of a call (:func:`graph_ms`), ``call_ms`` that of wrapper
    calls one after another; ``profiled`` adds ``torch.profiler``'s
    reading of the two kernels."""
    from platform_aware_scheduling_tpu_torch.ops.assign import greedy_assign_reference
    from platform_aware_scheduling_tpu_torch.ops.cuda_assign import (
        greedy_assign_cuda,
        launch_candidates,
        launch_resolve,
    )

    p, n = score.shape
    bytes_needed = p * n + 8 * int(eligible.sum()) + 8 * n + 4 * p
    bytes_dense = 9 * p * n + 8 * n + 4 * p
    lists, counts = launch_candidates(score, eligible, capacity)
    _result, rescans = launch_resolve(score, eligible, capacity, lists, counts)
    launches = greedy_assign_cuda.LAUNCHES
    call = lambda: greedy_assign_cuda(score, eligible, capacity)  # noqa: E731
    device_ms = graph_ms(torch, call, 20)
    out = {
        "shape": [p, n],
        "ms": device_ms,
        "device_ms": device_ms,
        "call_ms": cuda_ms(torch, call, 20),
        "profiler_ms": profiled_ms(torch, call, ("candidates_kernel", "resolve_kernel"), 20) if profiled else None,
        "candidates_ms": cuda_ms(torch, lambda: launch_candidates(score, eligible, capacity), 20),
        "resolve_ms": cuda_ms(
            torch, lambda: launch_resolve(score, eligible, capacity, lists, counts), 20
        ),
        "rescans": int(rescans.item()),
        "plain_ms": cuda_ms(torch, lambda: greedy_assign_reference(score, eligible, capacity), 3),
        "bound_ms": bytes_needed / HBM_BYTES_PER_S * 1e3,
        "dense_bound_ms": bytes_dense / HBM_BYTES_PER_S * 1e3,
    }
    greedy_assign_cuda.LAUNCHES = launches  # the timing's launches are not the main path's
    return out


def replan_breakdown(torch, planner, repeats: int = 5) -> dict:
    """Host-clock split of a replan of an unchanged cluster, each part
    ended by a synchronise: building the solve inputs (mirror snapshot,
    rule merge, remaining capacity, upload), the solve (score_and_filter +
    greedy_assign) and the readback; plus the device time of
    score_and_filter alone.  Medians in ms."""
    from platform_aware_scheduling_tpu_torch.models.batch_scheduler import (
        score_and_filter,
        scheduling_step,
    )

    parts = {"inputs_ms": [], "solve_ms": [], "readback_ms": []}
    for _ in range(repeats):
        t0 = time.perf_counter()
        inputs = planner.solve_inputs()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = scheduling_step(inputs.state, inputs.pods)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.assignment.node_for_pod.cpu().numpy()
        t3 = time.perf_counter()
        parts["inputs_ms"].append((t1 - t0) * 1e3)
        parts["solve_ms"].append((t2 - t1) * 1e3)
        parts["readback_ms"].append((t3 - t2) * 1e3)
    result = {name: statistics.median(values) for name, values in parts.items()}
    result["score_and_filter_device_ms"] = cuda_ms(
        torch, lambda: score_and_filter(inputs.state, inputs.pods), 10
    )
    return result


# -- phase 6: the TAS verbs over a socket ---------------------------------------------

SCORING_FUNCTIONS = ("ordinal_scores", "prioritize", "batch_prioritize", "filter", "filter_explain")
TIMED_REQUESTS = 500
SUBSET = 1_000
# Filter misses: candidate lists that drop a different 1% of the names
# each, taken in turn; more of them than the universe cache's once-seen
# ring (64) and the span cache (32) hold, so every one is a cold list
MISS_SUBSETS = 80
MISS_REQUESTS = 200
EXACT_REQUESTS = 200  # each verb on the exact path, the extension switched off
PARTITION_COUNTERS = (
    "pas_prioritize_native_total",
    "pas_prioritize_native_host_total",
    "pas_prioritize_exact_total",
    "pas_prioritize_host_fallback_total",
    "pas_filter_host_fallback_total",
    "pas_fastpath_response_hit_total",
    "pas_fastpath_response_miss_total",
    "pas_filter_cache_hit_total",
    "pas_filter_cache_miss_total",
    "pas_filter_cache_bypass_total",
    "pas_wire_intern_hits_total",
    "pas_wire_intern_misses_total",
    "pas_wire_intern_evictions_total",
)


# the counters that partition each verb's requests by the path that
# answered (host fallbacks beside them), as counter_moves names them
VERB_PARTITIONS = {
    "prioritize": ("prioritize_native", "prioritize_native_host", "prioritize_exact", "prioritize_host_fallback"),
    "filter": ("filter_cache_hit", "filter_cache_miss", "filter_cache_bypass", "filter_host_fallback"),
}


@contextlib.contextmanager
def native_off():
    """The wire extension switched off inside the block, as an operator
    switches it off (``PAS_TPU_NO_NATIVE=1``): every verb takes the exact
    path."""
    old = os.environ.get("PAS_TPU_NO_NATIVE")
    os.environ["PAS_TPU_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PAS_TPU_NO_NATIVE"]
        else:
            os.environ["PAS_TPU_NO_NATIVE"] = old


def partition_counters() -> dict:
    from platform_aware_scheduling_tpu_torch.utils import trace

    return {name: trace.COUNTERS.get(name) for name in PARTITION_COUNTERS}


def counter_moves(before: dict) -> dict:
    """The partition counters' moves since ``before``, zeros left out."""
    now = partition_counters()
    return {name.removeprefix("pas_").removesuffix("_total"): now[name] - before[name]
            for name in PARTITION_COUNTERS if now[name] != before[name]}


class PathsServed:
    """Counts the path of each verb span the servers complete (a socket
    request's; in-process controls make none): ``verb path`` and, for
    Filter, its response-cache outcome."""

    def __init__(self):
        import threading

        self.counts = {}
        self._lock = threading.Lock()

    def __call__(self, span) -> None:
        verb = span.attrs.get("verb")
        if verb not in ("filter", "prioritize"):
            return
        key = f"{verb} {span.attrs.get('path', '-')}"
        if verb == "filter":
            key += f"/{span.attrs.get('filter_cache', '-')}"
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + 1

    def line(self) -> str:
        return ", ".join(f"{k} {v}" for k, v in sorted(self.counts.items())) or "none"


def expected_warm_calls() -> dict:
    """The scoring calls the extender's warm passes must make in one
    refresh that moves every metric's row: each metric write is one state
    version, and its pass runs one batched ranking when a policy ranks on
    that metric and one filter_explain per policy with a dontschedule rule
    on it."""
    pols = policies(rule).values()
    batched = sum(
        any(p["scheduleonmetric"][0]["metricname"] == metric for p in pols) for metric in METRIC_NAMES
    )
    explains = sum(
        any(r["metricname"] == metric for r in p["dontschedule"])
        for metric in METRIC_NAMES
        for p in pols
    )
    return {
        "ordinal_scores": batched,
        "prioritize": 0,
        "batch_prioritize": batched,
        "filter": 0,
        "filter_explain": explains,
    }


def args_body(pod: str, policy, names=None, node_objs=None) -> bytes:
    labels = {"telemetry-policy": policy} if policy else {}
    body = {"Pod": {"metadata": {"name": pod, "namespace": "default", "labels": labels}}}
    if node_objs is not None:
        body["Nodes"] = {"items": node_objs}
    else:
        body["NodeNames"] = names
    return json.dumps(body).encode()


def percentile(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(round(q * (len(ordered) - 1))))]


@contextlib.contextmanager
def collections():
    """The interpreter's collections inside the block, as (generation, ms):
    each holds the GIL, so it stalls warm passes and requests alike."""
    pauses, started = [], []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append((info["generation"], (time.perf_counter() - started.pop()) * 1e3))

    gc.callbacks.append(on_gc)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(on_gc)


def full(pauses) -> list:
    """The full (generation 2) collections' ms of a ``collections()`` list."""
    return [ms for generation, ms in pauses if generation == 2]


def run_verbs(torch, np, world: dict, device: str) -> dict:
    """Serve Filter, Prioritize and Bind from the port's ``Server`` over a
    CUDA-mirror ``MetricsExtender`` with the main path's planner, on
    127.0.0.1 at the main path's 10,000 nodes.  Every response over the
    socket is held against the same extender over a CPU mirror, and
    Filter (and Prioritize where ties cannot reorder) against the host
    path, both with the wire extension switched off; the CUDA extender
    serves through it, as ``main`` does.  Then the verbs are timed: native
    Prioritize, Filter hits and Filter misses, then both verbs on the
    exact path (the extension switched off) for the comparison."""
    import http.client

    from platform_aware_scheduling_tpu_torch import native
    from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest, Server
    from platform_aware_scheduling_tpu_torch.ops import scoring
    from platform_aware_scheduling_tpu_torch.ops.cuda_assign import greedy_assign_cuda
    from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
    from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
    from platform_aware_scheduling_tpu_torch.tas.telemetryscheduler import MetricsExtender
    from platform_aware_scheduling_tpu_torch.utils import trace

    rng = np.random.default_rng(SEED + 1)
    cache, client, planner = world["cache"], world["client"], world["planners"]["dut"]
    cpu_planner, mirror = world["planners"]["cpu"], world["mirrors"]["dut"]
    nodes, values = world["nodes"], world["values"]
    check(mirror.device.type == device, f"the verbs' mirror is not on {device}")
    check(native.get_wirec() is not None, "verbs: the wire extension _wirec_torch is not loaded")
    ext = MetricsExtender(cache, mirror=mirror, planner=planner, node_cache_capable=True)
    # the controls see the same cache writes through a cache of their own,
    # so the scoring counters below count the CUDA extender's calls alone
    control_cache = AutoUpdatingCache()
    control_mirror = TensorStateMirror(device="cpu")
    control_mirror.attach(control_cache)
    write_policies(control_cache)
    control_cache.update_all_metrics(client)
    controls = {
        "cpu mirror": Server(
            MetricsExtender(control_cache, mirror=control_mirror, planner=cpu_planner, node_cache_capable=True)
        ),
        "host": Server(MetricsExtender(control_cache, planner=cpu_planner, node_cache_capable=True)),
    }
    server = Server(ext, metrics_provider=ext.metrics_text)
    server.start_server(port="0", unsafe=True, host="127.0.0.1", block=False)
    check(server.wait_ready(), "the extender server did not start")
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)

    def send(method, path, body=b"", content_type="application/json", request_id=None):
        headers = {"Content-Type": content_type} if content_type else {}
        if request_id is not None:
            headers["X-Request-ID"] = request_id
        start = time.perf_counter()
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data, time.perf_counter() - start

    def scoring_calls():
        return {name: getattr(scoring, name).CALLS for name in SCORING_FUNCTIONS}

    def check_warm(when):
        check(ext.readiness_conditions()[0][1]() == (True, "fastpath warmed"), f"verbs: not warmed {when}")
        for counter in ("pas_prioritize_host_fallback_total", "pas_filter_host_fallback_total"):
            fallbacks = trace.COUNTERS.get(counter)
            check(fallbacks == 0, f"verbs: {counter} is {fallbacks} {when}")

    spans = []  # every completed span while the verbs are timed
    try:
        # open the connection and the server's handler thread before the
        # refresh, so the first request after it times the verb alone
        first_body = args_body("first-after-refresh", "pol-0", names=nodes)
        check(send("POST", "/scheduler/prioritize", first_body)[0] == 200, "verbs: warm-up failed")
        # two churned refreshes, each warm pass timed where it runs: the
        # first after the planner phase, the second in steady state
        hooks = mirror.on_state_change
        index = hooks.index(ext.warm_fastpath)
        refreshes = []
        for _round in range(2):
            warm_s = []

            def timed_warm(warm_s=warm_s):
                start = time.perf_counter()
                ext.warm_fastpath()
                warm_s.append(time.perf_counter() - start)

            hooks[index] = timed_warm
            for name in SCORING_FUNCTIONS:
                getattr(scoring, name).CALLS = 0
            with collections() as pauses:
                start = time.perf_counter()
                world["refresh"]()
                refresh_s = time.perf_counter() - start
            hooks[index] = ext.warm_fastpath
            calls = scoring_calls()
            check(
                calls == expected_warm_calls(),
                f"verbs: scoring calls {calls}, expected {expected_warm_calls()}",
            )
            refreshes.append(
                {"warm_ms": [t * 1e3 for t in warm_s], "refresh_ms": refresh_s * 1e3, "gc_ms": full(pauses)}
            )
        check_warm("after the refreshes")
        greedy_assign_cuda.LAUNCHES = 0
        planned_count = planner.replan()
        launches = greedy_assign_cuda.LAUNCHES
        status, _data, first_s = send("POST", "/scheduler/prioritize", first_body)
        check(status == 200, f"verbs: first Prioritize after the refresh answered {status}")
        check(scoring_calls() == calls, "verbs: the first request ran a scoring function")
        if device == "cuda":
            check(launches == 1, f"verbs: greedy_assign launched {launches} times in the verbs' replan")
        check(cpu_planner.replan() == planned_count, "verbs: the CPU planner planned another count")
        check(
            all(planner.planned_node(p) == cpu_planner.planned_node(p) for p in world["pending"]),
            "verbs: the plan differs from the CPU planner's",
        )
        control_cache.update_all_metrics(client)
        # the controls' warm passes ran above; from here on no request, of
        # the CUDA extender or a control, may run a scoring function
        calls_served = scoring_calls()

        # -- the request mix ----------------------------------------------------
        by_policy = {}
        for pod in world["pending"]:
            node = planner.planned_node(pod)
            if node is not None:
                by_policy.setdefault(pod.get_labels()["telemetry-policy"], []).append((pod.name, node))
        # a 1000-name subset that holds each policy's second planned node
        held = {plans[1][1] for plans in by_policy.values()}
        others = [n for n in nodes if n not in held]
        subset = list(held) + [others[i] for i in rng.choice(len(others), SUBSET - len(held), replace=False)]
        subset = [subset[i] for i in rng.permutation(len(subset))]
        node_objs = [
            {"metadata": {"name": n, "labels": {"zone": f"zone-{i % 3}"}},
             "status": {"allocatable": {"pods": str(ALLOCATABLE_PODS)}}}
            for i, n in enumerate(subset)
        ]
        mix = []  # (verb, label, body, host path equal?, planned node or None)
        for k in range(4):
            policy = f"pol-{k}"
            (pod_a, node_a), (pod_b, node_b) = by_policy[policy][:2]
            metric = values[k]  # each policy ranks on metric k
            _vals, first = np.unique(metric, return_index=True)
            distinct = [nodes[i] for i in rng.permutation(first)[:SUBSET]]
            mix += [
                # node order: ties break alike on the device and host paths
                ("prioritize", f"{policy} NodeNames 10000", args_body(pod_a, policy, nodes), True, node_a),
                ("filter", f"{policy} NodeNames 10000", args_body(pod_a, policy, nodes), True, None),
                ("prioritize", f"{policy} NodeNames 1000", args_body(pod_b, policy, subset), False,
                 node_b if node_b in subset else None),
                ("filter", f"{policy} NodeNames 1000", args_body(pod_b, policy, subset), True, None),
                ("prioritize", f"{policy} distinct values 1000", args_body(pod_a, policy, distinct), True,
                 node_a if node_a in distinct else None),
                ("prioritize", f"{policy} Nodes 1000", args_body(f"probe-{k}", policy, node_objs=node_objs),
                 False, None),
                ("filter", f"{policy} Nodes 1000", args_body(f"probe-{k}", policy, node_objs=node_objs),
                 True, None),
            ]
        for verb in ("prioritize", "filter"):
            mix += [
                (verb, "empty body", b"", True, None),
                (verb, "no policy label", args_body("quirk", None, subset), True, None),
                (verb, "unknown policy", args_body("quirk", "pol-x", subset), True, None),
            ]
        pod_a, node_a = by_policy["pol-0"][0]
        bind = {"PodName": pod_a, "PodNamespace": "default", "PodUID": "u", "Node": node_a}
        mix.append(("bind", "bind", json.dumps(bind).encode(), True, None))

        def control_answer(control, verb, body):
            with native_off():
                want = controls[control].route(
                    HTTPRequest("POST", f"/scheduler/{verb}", {"Content-Type": "application/json"}, body)
                )
            return want.status, want.body

        # the mix twice: the first pass interns and caches, the second is
        # served from the caches; each answer against the controls'
        promoted = host_checked = 0
        wants = {}
        mix_paths = PathsServed()
        trace.SPAN_OBSERVERS.append(mix_paths)
        try:
            for verb, label, body, host_equal, planned in mix + mix:
                status, data, _s = send("POST", f"/scheduler/{verb}", body)
                for control in controls:
                    if control == "host" and not host_equal:
                        continue
                    if (control, verb, body) not in wants:
                        wants[control, verb, body] = control_answer(control, verb, body)
                    check(
                        (status, data) == wants[control, verb, body],
                        f"verbs {verb} {label}: the CUDA extender differs from the {control} control",
                    )
                    host_checked += control == "host"
                if planned is not None:
                    check(
                        json.loads(data)[0] == {"Host": planned, "Score": 10},
                        f"verbs {verb} {label}: the planned node {planned} is not ranked first",
                    )
                    promoted += 1
        finally:
            trace.SPAN_OBSERVERS.remove(mix_paths)
        check(promoted >= 16, f"verbs: only {promoted} planned pods checked")
        check(scoring_calls() == calls_served, "verbs: a request of the mix ran a scoring function")
        status, data, _s = send("GET", "/readyz", content_type=None)
        check(status == 200, f"verbs: /readyz answered {status}: {data[:200]!r}")
        check_warm("after the mix")

        # -- timing over the socket -----------------------------------------------
        # the server's spans are taken as they complete, matched to the
        # client's times by X-Request-ID.  Native Prioritize and Filter hits
        # over the 8 all-names bodies; Filter misses over MISS_SUBSETS cold
        # candidate lists in turn; then both verbs on the exact path
        all_names = [
            args_body(pod, f"pol-{k}", nodes) for k in range(4) for pod, _node in by_policy[f"pol-{k}"][:2]
        ]
        drop = max(1, len(nodes) // 100)
        miss_bodies = [
            args_body(by_policy[f"pol-{i % 4}"][0][0], f"pol-{i % 4}", nodes[: i * drop] + nodes[(i + 1) * drop :])
            for i in range(MISS_SUBSETS)
        ]
        runs = [
            # label, verb, bodies, requests, native, the partition it must fill
            ("prioritize", "prioritize", all_names, TIMED_REQUESTS, True, "prioritize_native"),
            ("filter hit", "filter", all_names, TIMED_REQUESTS, True, "filter_cache_hit"),
            ("filter miss", "filter", miss_bodies, MISS_REQUESTS, True, "filter_cache_miss"),
            ("exact prioritize", "prioritize", all_names, EXACT_REQUESTS, False, "prioritize_exact"),
            ("exact filter", "filter", all_names, EXACT_REQUESTS, False, "filter_cache_bypass"),
        ]
        for _label, verb, bodies, _n, _native, _partition in runs:
            for body in bodies:  # the CPU-mirror control's answers, taken before any timing
                if ("cpu mirror", verb, body) not in wants:
                    wants["cpu mirror", verb, body] = control_answer("cpu mirror", verb, body)
        timed, stages, moves = {}, {}, {}
        trace.SPAN_OBSERVERS.append(spans.append)
        for label, verb, bodies, n, on, partition in runs:
            with contextlib.nullcontext() if on else native_off():
                if label != "filter miss":  # warm-up: intern the lists, seed the caches
                    for body in bodies + bodies:
                        send("POST", f"/scheduler/{verb}", body)
                ids = [f"timed-{label.replace(' ', '-')}-{i}" for i in range(n)]
                times = []
                before = partition_counters()
                with collections() as pauses:
                    for i, request_id in enumerate(ids):
                        body = bodies[i % len(bodies)]
                        status, data, seconds = send("POST", f"/scheduler/{verb}", body, request_id=request_id)
                        times.append(seconds * 1e3)
                        check(
                            (status, data) == wants["cpu mirror", verb, body],
                            f"verbs: timed {label} differs from the CPU-mirror control",
                        )
                deadline = time.perf_counter() + 5.0
                while (not spans or spans[-1].trace_id != ids[-1]) and time.perf_counter() < deadline:
                    time.sleep(0.01)  # the last span is added after its response is sent
                moved = counter_moves(before)
            moves[label] = moved
            family = {k: v for k, v in moved.items() if k in VERB_PARTITIONS[verb]}
            check(family == {partition: n}, f"verbs: timed {label} moved the partition counters {moved}")
            by_id = {span.trace_id: span for span in spans}
            check(all(i in by_id for i in ids), f"verbs: {label} spans missing")
            timed_spans = [by_id[i] for i in ids]
            paths = {span.attrs.get("path") for span in timed_spans}
            check(paths == {"native" if on else "device"}, f"verbs: timed {label} spans took paths {paths}")
            check(scoring_calls() == calls_served, f"verbs: a timed {label} ran a scoring function")
            slowest = sorted(range(len(times)), key=times.__getitem__)[-3:][::-1]
            timed[label] = {
                "p50_ms": statistics.median(times),
                "p99_ms": percentile(times, 0.99),
                "max_ms": max(times),
                "n": len(times),
                "native": on,
                "gc": pauses,
                "slowest": [
                    {
                        "client_ms": times[i],
                        "server_ms": timed_spans[i].duration_s * 1e3,
                        "stages": {k: v * 1e3 for k, v in timed_spans[i].stage_seconds().items()},
                    }
                    for i in slowest
                ],
            }
            per_stage = {}
            for span in timed_spans:
                for name, seconds in span.stage_seconds().items():
                    per_stage.setdefault(name, []).append(seconds * 1e3)
            per_stage["outside the server span"] = [
                t - span.duration_s * 1e3 for t, span in zip(times, timed_spans)
            ]
            stages[label] = {name: statistics.median(ms) for name, ms in per_stage.items()}
            spans.clear()
        status, data, _s = send("GET", "/debug/wire", content_type=None)
        check(status == 200, f"verbs: /debug/wire answered {status}")
        wire = json.loads(data)
        check(wire["enabled"] and wire["occupancy"] == len(wire["universes"]) > 0, "verbs: no universe interned")
        check_warm("after the timed requests")

        # device time of the warm pass's scoring calls at the mirror's shape
        policies_now, view, _host_only = mirror.policies_snapshot()
        pairs = sorted({(c.scheduleonmetric_row, c.scheduleonmetric_op) for c in policies_now.values()})
        rank_ms = explain_ms = None
        if device == "cuda":
            rows = torch.tensor([r for r, _ in pairs], dtype=torch.int32, device=device)
            ops = torch.tensor([o for _, o in pairs], dtype=torch.int32, device=device)
            everywhere = torch.ones((len(pairs), view.node_capacity), dtype=torch.bool, device=device)
            rank_ms = cuda_ms(
                torch,
                lambda: scoring.batch_prioritize(view.values, view.present, rows, ops, everywhere),
                20,
            )
            explain_ms = sum(
                cuda_ms(
                    torch,
                    lambda c=c: scoring.filter_explain(
                        view.values, view.present, c.device_rules("dontschedule"), everywhere[0]
                    ),
                    20,
                )
                for c in policies_now.values()
            )
    finally:
        if spans.append in trace.SPAN_OBSERVERS:
            trace.SPAN_OBSERVERS.remove(spans.append)
        conn.close()
        server.shutdown()
    return {
        "timed": timed,
        "stages": stages,
        "moves": moves,
        "mix_paths": mix_paths.line(),
        "wire": {
            "universes": wire["occupancy"],
            "capacity": wire["capacity"],
            "filter_skeletons": len(wire["skeletons"]["filter"]),
            "prioritize_skeletons": len(wire["skeletons"]["prioritize"]),
            "counters": wire["counters"],
        },
        "refreshes": refreshes,
        "first_ms": first_s * 1e3,
        "calls": calls,
        "launches": launches,
        "requests": len(mix),
        "host_checked": host_checked,
        "promoted": promoted,
        "rank_ms": rank_ms,
        "rank_shape": [len(pairs), view.node_capacity],
        "explain_ms": explain_ms,
        "explain_policies": len(policies_now),
    }


def verbs_line(verbs: dict, card: str) -> str:
    calls = verbs["calls"]
    refreshes = "; ".join(
        f"{name} refresh {r['refresh_ms']:.3f} ms, its passes {sum(r['warm_ms']):.3f} ms "
        f"({', '.join(f'{t:.3f}' for t in r['warm_ms'])}), {len(r['gc_ms'])} full collections "
        f"{sum(r['gc_ms']):.3f} ms"
        for name, r in zip(("first", "second"), verbs["refreshes"])
    )
    runs = ", ".join(
        f"{label} p50 {t['p50_ms']:.3f} ms p99 {t['p99_ms']:.3f} ms max {t['max_ms']:.3f} ms (n={t['n']})"
        for label, t in verbs["timed"].items()
    )
    return (
        f"verbs {NUM_NODES} nodes, NodeNames mode over a socket, native wire path: {runs}; "
        f"warm passes per churned refresh "
        f"({calls['batch_prioritize']} batched rankings, {calls['filter_explain']} filter_explain): "
        f"{refreshes}; first request after the refresh {verbs['first_ms']:.3f} ms; "
        f"{verbs['requests']} requests twice (paths: {verbs['mix_paths']}) equal to the CPU-mirror control with "
        f"the extension off, {verbs['host_checked']} to the host path, {verbs['promoted']} planned pods promoted, "
        f"every timed answer equal to the control, 0 host fallbacks [{card}]"
    )


def verbs_wire_line(verbs: dict, card: str) -> str:
    """The partition counters each timed run moved and /debug/wire's
    caches at the end; each native p99 beside the 20 ms target."""
    moves = "; ".join(
        f"{label}: " + ", ".join(f"{k} {v}" for k, v in sorted(m.items())) for label, m in verbs["moves"].items()
    )
    w = verbs["wire"]
    target = ", ".join(
        f"{label} {'met' if t['p99_ms'] <= VERB_P99_TARGET_MS else 'missed'} ({t['p99_ms']:.3f} ms)"
        for label, t in verbs["timed"].items()
        if t["native"]
    )
    return (
        f"verbs wire: counters moved by each timed run: {moves}; /debug/wire {w['universes']} universes "
        f"interned of {w['capacity']}, {w['filter_skeletons']} Filter and {w['prioritize_skeletons']} Prioritize "
        f"skeletons, intern counters {w['counters']}; native p99 against the {VERB_P99_TARGET_MS:.0f} ms target "
        f"(not held): {target} [{card}]"
    )


def verbs_breakdown_line(verbs: dict, card: str) -> str:
    parts = []
    for verb, stages in verbs["stages"].items():
        parts.append(
            f"{verb} " + ", ".join(f"{name} {ms:.3f}" for name, ms in stages.items())
            + f" ({gc_summary(verbs['timed'][verb]['gc'])} in the timed run)"
        )
    device = ""
    if verbs["rank_ms"] is not None:
        k, n = verbs["rank_shape"]
        device = (
            f"; device: batch_prioritize {k}x{n} {verbs['rank_ms']:.4f} ms, filter_explain "
            f"x{verbs['explain_policies']} {verbs['explain_ms']:.4f} ms"
        )
    return f"verbs stages (span medians, ms): {'; '.join(parts)}{device} [{card}]"


def gc_summary(pauses) -> str:
    by_generation = {}
    for generation, ms in pauses:
        by_generation.setdefault(generation, []).append(ms)
    if not by_generation:
        return "no collections"
    return "collections " + ", ".join(
        f"gen {g}: {len(ms)} ({sum(ms):.3f} ms, max {max(ms):.3f})" for g, ms in sorted(by_generation.items())
    )


def verbs_tail_line(verbs: dict, card: str) -> str:
    """The slowest timed requests of each verb, client time beside the
    server span's time and stages (ms): where the tail comes from."""
    parts = []
    for verb, timed in verbs["timed"].items():
        parts.append(
            f"{verb} "
            + "; ".join(
                f"client {r['client_ms']:.3f} (server {r['server_ms']:.3f}: "
                + ", ".join(f"{name} {ms:.3f}" for name, ms in r["stages"].items())
                + ")"
                for r in timed["slowest"]
            )
        )
    return f"verbs tail (the 3 slowest of each timed run, ms): {' | '.join(parts)} [{card}]"


def check_limits(verbs: dict, replan_ms) -> None:
    """The end-to-end limits of PERF.md section 2; the verbs' limit holds
    the path that serves them (native), the exact runs are the comparison."""
    for label, timed in verbs["timed"].items():
        check(
            not timed["native"] or timed["p99_ms"] <= VERB_P99_LIMIT_MS,
            f"{label} p99 {timed['p99_ms']:.3f} ms is over its {VERB_P99_LIMIT_MS} ms limit",
        )
    for refresh in verbs["refreshes"]:
        warm = sum(refresh["warm_ms"])
        check(warm <= REFRESH_WARM_LIMIT_MS, f"a refresh's warm passes took {warm:.3f} ms")
    replan_p50 = statistics.median(replan_ms)
    check(replan_p50 <= REPLAN_P50_LIMIT_MS, f"replan wall p50 {replan_p50:.3f} ms is over its limit")


# -- phase 7: the TAS service, assembled as its main assembles it ---------------------

SERVICE_SYNC_PERIOD_S = 5.0  # the JAX main's --syncPeriod default
SERVICE_CHURN_PERIODS = 4
DESCHEDULE_TARGET = 97
UPDATED_DESCHEDULE_TARGET = 90
BOUND_BY_SCHEDULER = 20
ENFORCE_CYCLE_LIMIT_S = 1.0  # 20% of the sync period (PERF.md section 2)
METRIC_STAMP = "2026-01-01T00:00:00Z"
# the fault planes' windows, cut in time (not in the world) so the faults
# phase fits its budget; both replicas run with them (PERF.md section 4)
# --circuitResetTimeout, 30 s by default; over one sync period, so each
# open circuit spans the start of an enforcement cycle
CIRCUIT_RESET_S = 6.0
LEASE_RENEW_S = 2.0  # --leaseRenewPeriod, a third of --leaseDuration by default
LEASE_DURATION_S = 15.0  # --leaseDuration, its default
LKG_MAX_AGE_S = 15.0  # degraded.lkg_max_age_s, 3 freshness bounds (45 s) by default
FAULTS_TIMED_REQUESTS = 100


def replica_flags(identity: str) -> list:
    """The main's flags of one replica: last-known-good degraded mode and
    leader election under ``identity``, with the cut windows above."""
    return [
        "--degradedMode=last-known-good",
        "--leaderElect",
        f"--replicaId={identity}",
        f"--circuitResetTimeout={CIRCUIT_RESET_S:g}s",
        f"--leaseDuration={LEASE_DURATION_S:g}s",
        f"--leaseRenewPeriod={LEASE_RENEW_S:g}s",
    ]


def service_policies() -> dict:
    """The main path's 4 policies, each with one deschedule rule,
    GreaterThan 97, on the metric it ranks by."""
    out = {}
    for k, (name, strategies) in enumerate(policies(rule).items()):
        out[name] = {**strategies, "deschedule": [rule(f"metric{k}", "GreaterThan", DESCHEDULE_TARGET)]}
    return out


def np_violators(np, rules, values, nodes) -> set:
    """The nodes that violate any of ``rules`` (dicts) over the milli-unit
    ``values`` [metric, node]: the smoke run's own reference, independent
    of the port."""
    hit = np.zeros(len(nodes), dtype=bool)
    compare = {"LessThan": np.less, "GreaterThan": np.greater, "Equals": np.equal}
    for r in rules:
        row = values[METRIC_NAMES.index(r["metricname"])]
        hit |= compare[r["operator"]](row, r["target"] * 1000)
    return {nodes[i] for i in np.flatnonzero(hit)}


def wait_for(pred, timeout_s: float, what: str, poll_s: float = 0.02) -> float:
    """Seconds until ``pred()`` holds; fails after ``timeout_s``."""
    start = time.perf_counter()
    while not pred():
        if time.perf_counter() - start > timeout_s:
            raise SmokeError(f"service: timed out after {timeout_s:.0f} s waiting for {what}")
        time.sleep(poll_s)
    return time.perf_counter() - start


def build_service_world(np, kube):
    """The phase's cluster in the fake API server: 10,000 nodes with
    ``pods: 110``, 10% full and 5% with 1-5 slots left (their bound pods
    as pod objects), 1,000 pending labelled pods and 8 metrics a node."""
    rng = np.random.default_rng(SEED + 2)
    nodes = [f"node-{i:05d}" for i in range(NUM_NODES)]
    for name in nodes:
        kube.add_node(
            {"metadata": {"name": name, "labels": {}}, "status": {"allocatable": {"pods": str(ALLOCATABLE_PODS)}}}
        )
    order = rng.permutation(NUM_NODES)
    full_nodes = order[: int(NUM_NODES * FULL_NODE_SHARE)]
    nearly = order[len(full_nodes) : len(full_nodes) + int(NUM_NODES * NEARLY_FULL_SHARE)]
    bound = {int(i): ALLOCATABLE_PODS for i in full_nodes}
    bound.update({int(i): ALLOCATABLE_PODS - int(rng.integers(1, 6)) for i in nearly})
    bound_pods = 0
    for i, count in bound.items():
        for k in range(count):
            kube.add_pod(
                {
                    "metadata": {"name": f"bound-{i}-{k}", "namespace": "default"},
                    "spec": {"nodeName": nodes[i], "containers": [{"name": "c"}]},
                    "status": {"phase": "Running"},
                }
            )
            bound_pods += 1
    for i in range(NUM_PODS):
        kube.add_pod(
            {
                "metadata": {
                    "name": f"pending-{i}",
                    "namespace": "default",
                    "uid": f"uid-pending-{i}",
                    "labels": {"telemetry-policy": f"pol-{i % 4}"},
                },
                "spec": {"containers": [{"name": "c"}]},
                "status": {"phase": "Pending"},
            }
        )
    values = rng.integers(0, 100_000, size=(NUM_METRICS, NUM_NODES))
    for j, metric in enumerate(METRIC_NAMES):
        for name, v in zip(nodes, values[j].tolist()):
            kube.set_node_metric(metric, name, f"{v}m", timestamp=METRIC_STAMP)
    return rng, nodes, values, bound_pods


def run_service(torch, np, device: str, faults: bool = True) -> dict:
    """The TAS service as ``cmd/tas.main`` wires it: ``assemble`` with the
    batch planner and nodeCacheCapable on ``device``, behind the
    fault-tolerant client with its circuit breakers, last-known-good
    degraded mode and leader election (replica ``replica-a``), and
    ``build_server`` on 127.0.0.1, over the port's fake API server.  A
    FaultyClient with an empty FaultPlan sits between the fault-tolerant
    client and the fake.  Policies arrive as TASPolicy objects through the
    CRD informer; metrics through ``CustomMetricsClient``; a churn thread
    moves 30% of the values each sync period.  Nothing serialises the
    service's threads: each enforcement cycle's and replan's counter
    deltas are the calls its own thread made.  With ``faults``, the faults
    phase (:func:`run_faults`) follows on the same world, and its counts
    start from 0 at a point where no loop pass is in flight."""
    import http.client
    import threading

    from platform_aware_scheduling_tpu_torch.cmd import common, tas
    from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest, Server
    from platform_aware_scheduling_tpu_torch.kube.objects import object_key
    from platform_aware_scheduling_tpu_torch.models import batch_scheduler
    from platform_aware_scheduling_tpu_torch.ops import rules as rule_ops
    from platform_aware_scheduling_tpu_torch.ops import scoring as scoring_ops
    from platform_aware_scheduling_tpu_torch.ops.cuda_assign import greedy_assign_cuda
    from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
    from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache, CacheMissError
    from platform_aware_scheduling_tpu_torch.tas.degraded import DegradedModeController
    from platform_aware_scheduling_tpu_torch.tas.metrics import CustomMetricsClient
    from platform_aware_scheduling_tpu_torch.tas.planner import BatchPlanner
    from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy, TASPolicyRule
    from platform_aware_scheduling_tpu_torch.tas.strategies import deschedule
    from platform_aware_scheduling_tpu_torch.tas.telemetryscheduler import MetricsExtender
    from platform_aware_scheduling_tpu_torch.testing.builders import make_policy
    from platform_aware_scheduling_tpu_torch.testing.fake_kube import FakeKubeClient
    from platform_aware_scheduling_tpu_torch.testing.faults import FaultPlan, FaultyClient
    from platform_aware_scheduling_tpu_torch.utils import trace
    from platform_aware_scheduling_tpu_torch.utils.gctuning import tune_for_serving

    period = SERVICE_SYNC_PERIOD_S
    out = {}
    kube = FakeKubeClient()
    # the API server's faults, for every replica: empty until the faults phase
    plan = FaultPlan(seed=SEED)
    start = time.perf_counter()
    rng, nodes, values, out["bound_pods"] = build_service_world(np, kube)
    out["seed_s"] = time.perf_counter() - start
    pols = service_policies()

    # -- instrumentation: each enforcement cycle, replan and refresh pass -----
    # A cycle is one deschedule Strategy.enforce: it evaluates every
    # registered deschedule policy once, lists the nodes whose labels can
    # change and patches them.  The enforcement loop runs one cycle per
    # registered deschedule strategy each period (the reference's loop), so
    # a period holds ``policies`` cycles.  The service's threads run as
    # ``main`` runs them, side by side: each call of the device functions,
    # of the strategies' evaluations and of the API server's node patch is
    # counted for the thread that made it, so a cycle's or a replan's
    # deltas are its own while the verbs, the warm passes, the controller
    # and the other loops run beside it.
    per_thread = {}  # (what, thread id) -> calls; each key has one writer

    def counted(what, fn, when=lambda *a, **kw: True):
        def wrapper(*a, **kw):
            if when(*a, **kw):
                key = (what, threading.get_ident())
                per_thread[key] = per_thread.get(key, 0) + 1
            return fn(*a, **kw)

        return wrapper

    def mine(what) -> int:
        return per_thread.get((what, threading.get_ident()), 0)

    def everyone(what, since=None) -> int:
        """Every thread's calls of ``what`` (since the snapshot ``since``)."""
        since = since or {}
        return sum(n - since.get((w, tid), 0) for (w, tid), n in list(per_thread.items()) if w == what)

    # the loops' work in flight: once ``stop`` is set no new pass starts,
    # and the phase returns only after the last one ended, so no loop is
    # still inside torch when the interpreter exits
    busy = threading.Condition()
    in_flight = [0]
    closing = threading.Event()  # the phase is ending: no loop starts a pass

    def begin(stop_) -> bool:
        """A replica's loop starts a pass, unless the replica or the phase
        is stopping."""
        with busy:
            if stop_.is_set() or closing.is_set():
                return False
            in_flight[0] += 1
            return True

    def end() -> None:
        with busy:
            in_flight[0] -= 1
            busy.notify_all()

    cycles, periods, replans, refreshes = [], [], [], []
    stages = threading.local()  # the running cycle's stage seconds, per thread
    originals = {
        name: getattr(deschedule.Strategy, name)
        for name in ("enforce", "violated", "violated_device", "_node_status_for_strategy",
                     "_nodes_needing_labels", "_update_node_labels")
    }
    # every module that calls violated_nodes binds it by name at import
    callers = {module: module.violated_nodes for module in (deschedule, scoring_ops, batch_scheduler)}
    # the greedy kernel's one caller dispatches to it for tensors on the
    # card; the kernel's own counter is held to these dispatches' sum
    greedy_assign = batch_scheduler.greedy_assign
    # installed before ``assemble`` starts the loops, so every call of the
    # phase is counted; the functions' own counters are held to the sum
    calls_at_start = rule_ops.violated_nodes.CALLS
    greedy_assign_cuda.LAUNCHES = 0
    def staged(method, stage):
        def wrapper(self, *a, **kw):
            stages.ran.add(stage)
            t = time.perf_counter()
            try:
                return method(self, *a, **kw)
            finally:
                stages.seconds[stage] += time.perf_counter() - t

        return wrapper

    replica_of = {}  # id(enforcer) -> its replica

    def timed_cycle(self, enforcer_, cache_):
        if not begin(replica_of[id(enforcer_)].stop):
            return 0
        try:
            return _timed_cycle(self, enforcer_, cache_)
        finally:
            end()

    def _timed_cycle(self, enforcer_, cache_):
        # the enforcer holds its registry lock across the pass, so this
        # count holds for the whole cycle
        policies = len(enforcer_.registered_strategies.get(deschedule.STRATEGY_TYPE, {}))
        counts = ("violated_nodes", "violated_nodes_cuda", "violated_device", "violated", "patch_node",
                  "evictions_allowed", "probe")
        before = {what: mine(what) for what in counts}
        fallbacks = trace.COUNTERS.get("pas_deschedule_host_fallback_total")
        stages.seconds = {"evaluate": 0.0, "list": 0.0, "patch": 0.0}
        stages.ran = set()
        t0 = time.perf_counter()
        raised = True
        try:
            result = originals["enforce"](self, enforcer_, cache_)
            raised = False
            return result
        finally:
            t1 = time.perf_counter()
            delta = {what: mine(what) - n for what, n in before.items()}
            # which branch of enforce ran: the label pass (leader, evictions
            # allowed), the suspended cycle (the degraded controller said
            # no), or the follower's (no controller consulted)
            if "list" in stages.ran:
                branch = "labels"
            elif delta["evictions_allowed"]:
                branch = "suspended"
            else:
                branch = "follower"
            cycles.append(
                {
                    "start": t0,
                    "end": t1,
                    "replica": replica_of[id(enforcer_)].name,
                    "branch": branch,
                    "raised": raised,
                    "policies": policies,
                    "evaluated": delta["violated_device"],
                    "calls": delta["violated_nodes"],
                    "cuda_calls": delta["violated_nodes_cuda"],
                    "host_calls": delta["violated"],
                    "patches": delta["patch_node"],
                    # the suspended cycle's list_nodes probes that reached
                    # the API server (an open circuit refuses them first)
                    "probes": delta["probe"],
                    # the service-wide counter: it counts any thread's
                    # deschedule fallback, and must stay 0
                    "fallbacks": trace.COUNTERS.get("pas_deschedule_host_fallback_total") - fallbacks,
                    "device": enforcer_.mirror.device.type,
                    **stages.seconds,
                }
            )
            del kube.node_patches[:]  # the record would grow by every patch of the phase

    for name, stage in (("_node_status_for_strategy", "evaluate"), ("_nodes_needing_labels", "list"),
                        ("_update_node_labels", "patch")):
        setattr(deschedule.Strategy, name, staged(originals[name], stage))
    deschedule.Strategy.enforce = timed_cycle
    deschedule.Strategy.violated = counted("violated", originals["violated"])
    deschedule.Strategy.violated_device = counted("violated_device", originals["violated_device"])
    for module, fn in callers.items():
        cuda_counted = counted("violated_nodes_cuda", fn, lambda values, *a, **kw: values.is_cuda)
        module.violated_nodes = counted("violated_nodes", cuda_counted)
    batch_scheduler.greedy_assign = counted(
        "greedy_assign_cuda", greedy_assign, lambda score, *a, **kw: score.is_cuda
    )
    kube.patch_node = counted("patch_node", kube.patch_node)
    # a suspended cycle's probe is the one list_nodes call without a selector
    kube.list_nodes = counted("probe", kube.list_nodes, lambda *a, **kw: not a and not kw)
    evictions_allowed = DegradedModeController.evictions_allowed
    DegradedModeController.evictions_allowed = counted("evictions_allowed", evictions_allowed)

    def instrument(r):
        """Time replica ``r``'s enforcement periods, replans and refresh
        passes, each record naming the replica."""
        enforce_strategy = r.enforcer.enforce_strategy

        def timed_period(strategy_type, cache_):
            if strategy_type != deschedule.STRATEGY_TYPE:
                return enforce_strategy(strategy_type, cache_)
            t0 = time.perf_counter()
            enforce_strategy(strategy_type, cache_)
            periods.append({"start": t0, "end": time.perf_counter(), "replica": r.name})

        r.enforcer.enforce_strategy = timed_period

        solve_inputs, replan = r.planner.solve_inputs, r.planner.replan
        last_inputs = {}

        def recorded_inputs():
            inputs = solve_inputs()
            if inputs is not None:
                last_inputs["capacity"] = inputs.state.capacity.cpu().numpy()
                last_inputs["node_index"] = inputs.view.node_index
            return inputs

        def timed_replan():
            if not begin(r.stop):
                return 0
            try:
                return _timed_replan()
            finally:
                end()

        def _timed_replan():
            launches, calls = mine("greedy_assign_cuda"), mine("violated_nodes")
            last_inputs.clear()
            t0 = time.perf_counter()
            planned = replan()
            t1 = time.perf_counter()
            replans.append(
                {
                    "start": t0,
                    "end": t1,
                    "replica": r.name,
                    "planned": planned,
                    "solved": "capacity" in last_inputs,
                    "launches": mine("greedy_assign_cuda") - launches,
                    "calls": mine("violated_nodes") - calls,
                    **last_inputs,
                }
            )
            return planned

        r.planner.solve_inputs, r.planner.replan = recorded_inputs, timed_replan

        update_all_metrics = r.cache.update_all_metrics

        def timed_refresh(client):
            if not begin(r.stop):
                return
            try:
                t0 = time.perf_counter()
                update_all_metrics(client)
                refreshes.append({"start": t0, "end": time.perf_counter(), "replica": r.name})
            finally:
                end()

        r.cache.update_all_metrics = timed_refresh

    replicas = []

    def replica(identity):
        """One replica as the main wires it (``replica_flags``): the
        fault-tolerant proxy and its breakers over a FaultyClient on the
        shared fault plan, the metrics client over it, the lease elector,
        ``assemble``, the elector started after it, and its server."""
        args = tas.build_arg_parser().parse_args(replica_flags(identity))
        policy, breakers = common.build_fault_tolerance(args)
        api = common.wrap_kube_client(FaultyClient(kube, plan), policy, breakers)
        elector = common.build_lease_elector(args, api)
        t0 = time.perf_counter()
        parts = tas.assemble(
            api,
            CustomMetricsClient(api),
            period,
            enable_batch_planner=True,
            node_cache_capable=True,
            breakers=breakers,
            degraded_mode=args.degradedMode,
            leadership=elector,
            device=device,
        )
        r = SimpleNamespace(name=identity, t_assemble=t0, breakers=breakers, elector=elector)
        r.cache, r.mirror, r.ext, r.controller, r.enforcer, r.stop = parts
        r.planner = r.ext.planner
        check(r.mirror.device.type == device and r.planner.device.type == device, f"service: not on {device}")
        replica_of[id(r.enforcer)] = r
        instrument(r)
        replicas.append(r)
        elector.start(r.stop)
        r.server = tas.build_server(r.ext)
        r.server.start_server(port="0", unsafe=True, host="127.0.0.1", block=False)
        check(r.server.wait_ready(), f"service: {identity}'s server did not start")
        return r

    a = replica("replica-a")
    t_assemble = a.t_assemble
    cache, mirror, ext, controller, enforcer, stop = a.cache, a.mirror, a.ext, a.controller, a.enforcer, a.stop
    planner, server = a.planner, a.server

    def send(verb, body, to=None):
        # a connection a request: the server closes one idle past its
        # 5 s read-header timeout, and this phase idles for periods
        conn = http.client.HTTPConnection("127.0.0.1", (to or a).server.port, timeout=120)
        try:
            conn.request("POST", f"/scheduler/{verb}", body=body, headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def after(t0, name="replica-a"):
        """Wait until a refresh pass of replica ``name`` started after
        ``t0`` ended, then an enforcement period and a replan of it that
        started after that pass."""
        mine_ = lambda records: [x for x in records if x["replica"] == name]  # noqa: E731
        wait_for(lambda: any(r["start"] > t0 for r in mine_(refreshes)), 3 * period, "a refresh pass")
        t1 = next(r["end"] for r in mine_(refreshes) if r["start"] > t0)
        wait_for(
            lambda: any(p["start"] > t1 for p in mine_(periods)) and any(r["start"] > t1 for r in mine_(replans)),
            3 * period,
            "an enforcement period and a replan",
        )

    churn_stop = threading.Event()
    last_write = [time.perf_counter()]

    def churn():
        while not churn_stop.wait(period):
            moved = rng.random(values.shape) < CHURN
            values[...] = np.where(moved, rng.integers(0, 100_000, size=values.shape), values)
            for j, i in zip(*np.nonzero(moved)):
                kube.set_node_metric(METRIC_NAMES[j], nodes[i], f"{values[j, i]}m", timestamp=METRIC_STAMP)
            last_write[0] = time.perf_counter()

    churner = threading.Thread(target=churn, daemon=True)

    # the smoke's own heavy checks on the main thread (full listings, host
    # evaluations, the CPU control) are no part of the service: they run
    # in the gap after an enforcement period, and the worst cycle's line
    # says how long it overlapped them all the same
    checks = []

    def between_periods(name="replica-a"):
        """Return just after an enforcement period of replica ``name`` ends
        (the one in flight, or else the next)."""
        seen = sum(p["replica"] == name for p in periods)
        wait_for(lambda: sum(p["replica"] == name for p in periods) > seen, 2 * period, "an enforcement period to end")

    @contextlib.contextmanager
    def checking():
        t0 = time.perf_counter()
        try:
            yield
        finally:
            checks.append({"start": t0, "end": time.perf_counter()})

    # full collections hold the GIL: each stalls every thread of the service
    full_collections, gc_started = [], []

    def on_gc(phase, info):
        if phase == "start":
            gc_started.append(time.perf_counter())
        elif gc_started:
            t0 = gc_started.pop()
            if info["generation"] == 2:
                full_collections.append({"start": t0, "end": time.perf_counter()})

    gc.callbacks.append(on_gc)
    served = PathsServed()  # the service's verbs, by the path that served them
    trace.SPAN_OBSERVERS.append(served)
    try:
        # 1. the three informers' initial syncs, from the assemble call
        informers = {
            "taspolicy": controller.informer,
            "pods": planner.feed.informers[0],
            "nodes": planner.feed.informers[1],
        }
        synced = {}

        def all_synced():
            for name, informer in informers.items():
                if name not in synced and informer.has_synced():
                    synced[name] = time.perf_counter() - t_assemble
            return len(synced) == len(informers)

        wait_for(all_synced, 120, "the informers' initial sync", poll_s=0.005)
        out["sync_s"] = synced
        # the main applies the GC posture here, once the initial lists are in
        start = time.perf_counter()
        tune_for_serving()
        out["tune_s"] = time.perf_counter() - start

        # 2. the policies through the CRD; each one's first Filter that
        # excludes exactly its dontschedule violators
        t_create = time.perf_counter()
        for name, strategies in pols.items():
            kube.create_taspolicy(make_policy(name, strategies=strategies))
        wait_for(
            lambda: len(enforcer.registered_strategies.get("deschedule", {})) == len(pols),
            10,
            "the controller to register the policies",
            poll_s=0.001,
        )
        propagation = {}
        expected = {name: np_violators(np, s["dontschedule"], values, nodes) for name, s in pols.items()}

        def filters_current():
            for name in pols:
                if name in propagation:
                    continue
                status, data = send("filter", args_body(f"probe-{name}", name, nodes))
                if status == 200 and set(json.loads(data)["FailedNodes"]) == expected[name]:
                    propagation[name] = time.perf_counter() - t_create
            return len(propagation) == len(pols)

        # a poll is four 10,000-name Filters: polled more often, the
        # harness would take the interpreter from the cycles it measures
        wait_for(filters_current, 6 * period, "the policies to reach Filter", poll_s=0.2)
        out["propagation_s"] = propagation

        # 3. churn, then a quiescent cycle: the labels equal the host
        # evaluation and the numpy reference
        churner.start()
        time.sleep(SERVICE_CHURN_PERIODS * period)
        churn_stop.set()
        churner.join(timeout=30)
        check(not churner.is_alive(), "service: the churn thread did not stop")
        after(last_write[0])
        between_periods()

        def labels_of():
            return {node.name: node.get_labels() for node in kube.list_nodes()}

        def labels_match(name, rules_, labels, cache_=cache):
            host = set(
                deschedule.Strategy(name, [TASPolicyRule.from_obj(r) for r in rules_]).violated(cache_)
            )
            violating = {n for n, lab in labels.items() if lab.get(name) == "violating"}
            stale = {n for n, lab in labels.items() if name in lab and lab[name] not in ("violating", "null")}
            nulls = {n for n, lab in labels.items() if lab.get(name) == "null"}
            return violating == host == np_violators(np, rules_, values, nodes) and not stale, len(nulls)

        out["nulls"] = {}
        with checking():
            labels = labels_of()
            matches = {name: labels_match(name, s["deschedule"], labels) for name, s in pols.items()}
        for name, (ok, out["nulls"][name]) in matches.items():
            check(ok, f"service: {name}'s labels differ from the host evaluation after a quiescent cycle")
            check(out["nulls"][name] > 0, f"service: no node of {name} stopped violating and carries =null")

        # 4. the pending set, and the plan against a CPU planner (built below)
        with checking():
            pending = [
                p for p in kube.list_pods() if not p.spec_node_name and "telemetry-policy" in p.get_labels()
            ]
        check(
            planner.pending_keys() == [object_key(p) for p in pending] and len(pending) == NUM_PODS,
            "service: the planner's pending set differs from the API server's pending pods",
        )
        planned = [(p, planner.planned_node(p)) for p in pending]
        planned = [(p, node) for p, node in planned if node is not None]
        check(len(planned) >= BOUND_BY_SCHEDULER, f"service: only {len(planned)} pods planned")
        out["planned_quiescent"] = len(planned)

        # 5. kube-scheduler binds 20 planned pods: the extender's Bind (a
        # 404, feedback only) and then the API binding
        before = dict([r for r in replans if r["solved"]][-1])
        chosen = planned[:BOUND_BY_SCHEDULER]
        for pod, node in chosen:
            bind = {"PodName": pod.name, "PodNamespace": pod.namespace, "PodUID": pod.uid, "Node": node}
            status, _data = send("bind", json.dumps(bind).encode())
            check(status == 404, f"service: Bind answered {status}")
            kube.bind_pod(pod.namespace, pod.name, pod.uid, node)
        gone = {object_key(p) for p, _node in chosen}
        out["bind_observed_s"] = wait_for(
            lambda: planner.pending_count() == NUM_PODS - BOUND_BY_SCHEDULER
            and not gone & set(planner.pending_keys()),
            2 * period,
            "the pod informer to see the bindings",
        )
        # the CPU control's pods and nodes (step 7), taken now, in a gap of
        # their own: neither changes after the bindings
        between_periods()
        with checking():
            control_cache = AutoUpdatingCache()
            control_mirror = TensorStateMirror(device="cpu")
            control_mirror.attach(control_cache)
            control_planner = BatchPlanner(control_cache, control_mirror, device="cpu")
            for node in kube.list_nodes():
                control_planner.node_changed(node)
            for pod in kube.list_pods():
                control_planner.pod_observed(pod)
                control_planner.pod_added(pod)

        # 6. the controller: update pol-0's deschedule target, delete pol-3
        updated_rules = [rule("metric0", "GreaterThan", UPDATED_DESCHEDULE_TARGET)]
        obj = kube.get_taspolicy("default", "pol-0")
        obj["spec"]["strategies"]["deschedule"]["rules"] = updated_rules
        t_update = time.perf_counter()
        kube.update_taspolicy(obj)
        wait_for(
            lambda: any(
                s.rules[0].target == UPDATED_DESCHEDULE_TARGET
                for s in enforcer.registered_strategies["deschedule"].values()
            ),
            10,
            "the controller to apply the update",
            poll_s=0.001,
        )
        # polled through the label selector (a few hundred nodes), not a
        # listing of all 10,000, for the same reason as above; the values no
        # longer churn, so the reference is fixed
        want_pol0 = np_violators(np, updated_rules, values, nodes)
        wait_for(
            lambda: {n.name for n in kube.list_nodes(label_selector="pol-0=violating")} == want_pol0,
            2 * period + ENFORCE_CYCLE_LIMIT_S,
            "pol-0's labels to follow its update",
            poll_s=0.05,
        )
        out["update_follow_s"] = time.perf_counter() - t_update
        between_periods()
        with checking():
            pol0_ok = labels_match("pol-0", updated_rules, labels_of())[0]
        check(pol0_ok, "service: pol-0's labels differ from the host evaluation after its update")
        kube.delete_taspolicy("default", "pol-3")

        def deleted():
            try:
                cache.read_policy("default", "pol-3")
            except CacheMissError:
                return True
            return False

        wait_for(deleted, 10, "the controller to delete pol-3", poll_s=0.001)
        t_changed = time.perf_counter()
        remaining = {name: s for name, s in pols.items() if name != "pol-3"}
        remaining["pol-0"] = {**remaining["pol-0"], "deschedule": updated_rules}
        between_periods()
        with checking():
            survived = [n for n, lab in labels_of().items() if lab.get("pol-3") == "violating"]
        check(not survived, f"service: pol-3=violating labels survived its deletion on {len(survived)} nodes")
        want_metrics = {r["metricname"] for s in remaining.values() for rs in s.values() for r in rs}
        check(
            set(cache.registered_metric_names()) == want_metrics,
            f"service: registered metrics {sorted(cache.registered_metric_names())} after the delete",
        )
        check(mirror.policy("default", "pol-3") is None, "service: the mirror kept pol-3")
        after(t_changed)
        next_solve = next(r for r in replans if r["start"] > t_changed)
        cap_before, cap_after = before["capacity"], next_solve["capacity"]
        index = next_solve["node_index"]
        want = cap_before.copy()
        for _pod, node in chosen:
            want[index[node]] -= 1
        check(
            index == before["node_index"] and (cap_after == want).all(),
            "service: the next solve's capacity does not take the 20 bindings",
        )

        # 7. the CPU control, from the API server's state: the same plan,
        # and every verb answer byte for byte
        between_periods()
        with checking():
            for item in kube.list_taspolicies()["items"]:
                policy = TASPolicy.from_obj(item)
                control_cache.write_policy(policy.namespace, policy.name, policy)
                for strat in policy.strategies.values():
                    for r in strat.rules:
                        control_cache.write_metric(r.metricname, None)
            control_cache.update_all_metrics(CustomMetricsClient(kube))
            control_planner.replan()
        still_pending = [p for p in pending if object_key(p) not in gone]
        check(
            all(planner.planned_node(p) == control_planner.planned_node(p) for p in still_pending),
            "service: the live plan differs from the CPU planner's",
        )
        out["planned_final"] = sum(planner.planned_node(p) is not None for p in still_pending)
        control = Server(MetricsExtender(control_cache, mirror=control_mirror, planner=control_planner,
                                         node_cache_capable=True))
        by_policy = {}
        for pod in still_pending:
            by_policy.setdefault(pod.get_labels()["telemetry-policy"], []).append(pod)
        mix = []
        for name in sorted(by_policy):
            for pod in by_policy[name][:2]:
                for verb in ("filter", "prioritize"):
                    mix.append((verb, args_body(pod.name, name, nodes)))
        check(len(mix) == 16, f"service: {len(mix)} requests in the mix")
        for verb, body in mix:
            got = send(verb, body)
            with checking():
                want_resp = control.route(
                    HTTPRequest("POST", f"/scheduler/{verb}", {"Content-Type": "application/json"}, body)
                )
            check(got == (want_resp.status, want_resp.body), f"service {verb}: differs from the CPU control")
        deleted_pod = by_policy["pol-3"][0].name
        check(
            send("filter", args_body(deleted_pod, "pol-3", nodes)) == (404, b"null\n"),
            "service: Filter for a deleted policy's pod is not the unknown-policy answer",
        )
        out["requests"] = len(mix) + 1
        check(
            trace.COUNTERS.get("pas_prioritize_host_fallback_total") == 0
            and trace.COUNTERS.get("pas_filter_host_fallback_total") == 0,
            "service: a verb fell back to the host",
        )
        check(a.elector.is_leader(), "service: replica A does not lead")

        # the phases' boundary, taken while no loop pass is in flight (new
        # passes wait for it): the service phase's counts are read, and the
        # faults phase's start from 0
        with busy:
            check(busy.wait_for(lambda: in_flight[0] == 0, timeout=6 * period), "service: the loops did not pause")
            out["launches"] = greedy_assign_cuda.LAUNCHES
            greedy_assign_cuda.LAUNCHES = 0
            calls = rule_ops.violated_nodes.CALLS
            at_boundary = dict(per_thread)
            split = {"cycles": len(cycles), "periods": len(periods), "replans": len(replans),
                     "refreshes": len(refreshes)}
            t_boundary = time.perf_counter()
        trace.SPAN_OBSERVERS.remove(served)
        out["paths"] = served.line()
        check(
            "prioritize native" in served.counts and any(k.startswith("filter native/") for k in served.counts),
            f"service: the verbs did not go through the native wire path ({out['paths']})",
        )
        check(
            calls - calls_at_start == everyone("violated_nodes") and out["launches"] == everyone("greedy_assign_cuda"),
            "service: a violated_nodes call or greedy_assign launch was not counted for its thread",
        )
        if faults:
            ctx = SimpleNamespace(
                torch=torch, np=np, kube=kube, plan=plan, period=period, device=device, a=a, replica=replica,
                cycles=cycles, periods=periods, replans=replans, refreshes=refreshes, send=send,
                labels_of=labels_of, labels_match=labels_match, between_periods=between_periods,
                policies={name: s["deschedule"] for name, s in remaining.items()}, pods=by_policy,
                nodes=nodes,
            )
            out["faults"] = run_faults(ctx)
            check(
                trace.COUNTERS.get("pas_prioritize_host_fallback_total") == 0
                and trace.COUNTERS.get("pas_filter_host_fallback_total") == 0,
                "faults: a verb fell back to the host",
            )
    finally:
        if served in trace.SPAN_OBSERVERS:
            trace.SPAN_OBSERVERS.remove(served)
        churn_stop.set()
        with busy:
            closing.set()
            busy.wait_for(lambda: in_flight[0] == 0, timeout=6 * period)
        for r in replicas:
            r.stop.set()
            r.server.shutdown()
        gc.callbacks.remove(on_gc)
        for name, method in originals.items():
            setattr(deschedule.Strategy, name, method)
        for module, fn in callers.items():
            module.violated_nodes = fn
        batch_scheduler.greedy_assign = greedy_assign
        DegradedModeController.evictions_allowed = evictions_allowed
        del kube.patch_node, kube.list_nodes

    # the whole run's cycles and replans, checked one by one
    check(cycles and periods and replans and refreshes, "service: no enforcement cycle, replan or refresh ran")
    for c in cycles:
        check(c["fallbacks"] == 0 and c["host_calls"] == 0, "service: the enforcer took the host path")
        check(c["device"] == device, f"service: a cycle evaluated on {c['device']}")
        check(
            c["calls"] == c["evaluated"] == c["policies"],
            f"service: {c['calls']} violated_nodes calls in a cycle that evaluated {c['evaluated']} of "
            f"{c['policies']} policies",
        )
        if device == "cuda":
            check(c["cuda_calls"] == c["calls"], "service: a cycle evaluated a view that is not on the card")
    seen = {c["policies"] for c in cycles[: split["cycles"]]}
    check({len(pols), len(pols) - 1} <= seen, f"service: cycles of {sorted(seen)} policies only")
    for r in replans:
        solves = 1 if r["solved"] else 0
        if device == "cuda":
            check(r["launches"] == solves, f"service: a replan launched greedy_assign {r['launches']} times")
        check(r["calls"] == solves, f"service: {r['calls']} violated_nodes calls in a replan")
    if faults:
        # every call of the faults phase went through the per-thread counts
        f = out["faults"]
        f["launches"] = greedy_assign_cuda.LAUNCHES
        check(
            rule_ops.violated_nodes.CALLS - calls == everyone("violated_nodes", since=at_boundary)
            and f["launches"] == everyone("greedy_assign_cuda", since=at_boundary),
            "faults: a violated_nodes call or greedy_assign launch was not counted for its thread",
        )
        records = {"cycles": cycles, "periods": periods, "replans": replans, "refreshes": refreshes}
        for key, n in split.items():
            f[key] = records[key][n:]
        f["full_collections"] = [g for g in full_collections if g["start"] >= t_boundary]
        f["launches_by_replica"] = {
            name: sum(r["launches"] for r in f["replans"] if r["replica"] == name) for name in ("replica-a", "replica-b")
        }
    out.update(
        cycles=cycles[: split["cycles"]],
        periods=periods[: split["periods"]],
        replans=replans[: split["replans"]],
        refreshes=refreshes[: split["refreshes"]],
        full_collections=[g for g in full_collections if g["start"] < t_boundary],
        checks=checks,
    )
    return out


def service_lines(s: dict, card: str) -> list:
    # the label cycles: a cycle is suspended while telemetry is not yet
    # fresh (a new policy's metrics before their first refresh)
    cycles = [c for c in s["cycles"] if c["policies"] and c["branch"] == "labels"]
    suspended = sum(c["branch"] == "suspended" for c in s["cycles"])
    total = [(c["end"] - c["start"]) * 1e3 for c in cycles]
    stage = {k: statistics.median(c[k] * 1e3 for c in cycles) for k in ("evaluate", "list", "patch")}
    patches = [c["patches"] for c in cycles]
    period = [(p["end"] - p["start"]) * 1e3 for p in s["periods"]]
    refresh = [(r["end"] - r["start"]) * 1e3 for r in s["refreshes"]]
    replan = [(r["end"] - r["start"]) * 1e3 for r in s["replans"] if r["solved"]]
    sync = ", ".join(f"{k} {v:.3f} s" for k, v in s["sync_s"].items())
    prop = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(s["propagation_s"].items()))
    return [
        f"service {NUM_NODES} nodes, {s['bound_pods']} bound and {NUM_PODS} pending pods, sync period "
        f"{SERVICE_SYNC_PERIOD_S:.0f} s: seeded in {s['seed_s']:.3f} s; initial syncs {sync}; policy "
        f"to Filter {prop}; {s['planned_quiescent']} pods planned at the quiescent point, "
        f"{s['planned_final']} at the end; bindings seen by the pod informer in "
        f"{s['bind_observed_s']:.3f} s; pol-0's labels followed its update in {s['update_follow_s']:.3f} s; "
        f"null labels left after the quiescent cycle {s['nulls']} [{card}]",
        f"service enforcement: {len(cycles)} deschedule label cycles ({suspended} suspended while a new "
        f"policy's telemetry was not yet fresh) p50 {statistics.median(total):.3f} ms "
        f"max {max(total):.3f} ms (stage medians: device evaluation {stage['evaluate']:.3f} ms, "
        f"node listing {stage['list']:.3f} ms, patches {stage['patch']:.3f} ms; patches a cycle p50 "
        f"{statistics.median(patches):.0f} max {max(patches)}); {len(period)} enforcement periods (one cycle "
        f"per deschedule policy) p50 {statistics.median(period):.3f} ms max {max(period):.3f} ms; "
        f"violated_nodes calls = policies in every cycle, on the card, 0 host evaluations; refresh through "
        f"CustomMetricsClient p50 {statistics.median(refresh):.3f} ms max {max(refresh):.3f} ms over "
        f"{len(refresh)}; live replan p50 {statistics.median(replan):.3f} ms over {len(replan)}, one "
        f"greedy_assign launch each, {s['launches']} in all; {s['requests']} verb responses equal to the "
        f"CPU control; the verbs' paths (span path/filter cache): {s['paths']} [{card}]",
        worst_cycle_line(s, card),
    ]


def overlap_s(a: dict, spans: list) -> float:
    """Seconds of span ``a`` that any of ``spans`` covers (spans of one
    kind do not overlap each other)."""
    return sum(max(0.0, min(a["end"], b["end"]) - max(a["start"], b["start"])) for b in spans)


def worst_cycle_line(s: dict, card: str) -> str:
    """The slowest enforcement cycle, split, with what ran beside it: a
    refresh pass and the smoke's own checks share the interpreter, a full
    collection stops it."""
    cycles = [c for c in s["cycles"] if c["policies"]]
    worst = max(cycles, key=lambda c: c["end"] - c["start"])
    first = min(c["start"] for c in cycles)
    during = [g for g in s["full_collections"] if g["start"] >= first]
    pauses = [(g["end"] - g["start"]) * 1e3 for g in during]
    return (
        f"service worst cycle ({worst['branch']}): {(worst['end'] - worst['start']) * 1e3:.3f} ms, "
        f"{worst['start'] - first:.3f} s into enforcement (device evaluation {worst['evaluate'] * 1e3:.3f} ms, "
        f"node listing {worst['list'] * 1e3:.3f} ms, patches {worst['patch'] * 1e3:.3f} ms, {worst['patches']} "
        f"patches); beside it a refresh pass for {overlap_s(worst, s['refreshes']) * 1e3:.3f} ms, full "
        f"collections for {overlap_s(worst, s['full_collections']) * 1e3:.3f} ms and the smoke's own checks for "
        f"{overlap_s(worst, s['checks']) * 1e3:.3f} ms; GC posture applied after the "
        f"initial syncs in {s['tune_s'] * 1e3:.3f} ms; full collections during enforcement {len(pauses)}"
        + (f" (max {max(pauses):.3f} ms)" if pauses else "")
        + f" [{card}]"
    )


def check_service_limits(s: dict) -> None:
    """PERF.md section 2: every enforcement cycle within its limit."""
    worst = max(c["end"] - c["start"] for c in s["cycles"])
    check(
        worst <= ENFORCE_CYCLE_LIMIT_S,
        f"an enforcement cycle took {worst * 1e3:.3f} ms, over its {ENFORCE_CYCLE_LIMIT_S * 1e3:.0f} ms limit",
    )


# -- phase 8: the fault planes, two replicas ----------------------------------------


def http_get(port: int, path: str):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def run_faults(ctx) -> dict:
    """The service's fault planes on the service phase's world, with
    replica A still running: replica B joins, assembled by the same
    ``assemble`` on the card; then a metrics-API outage, its recovery, a
    kube-API outage and a failover, each injected through the fault plan
    both replicas' FaultyClients share.  Every check is the one
    ``PERF.md`` section 4 lists for the phase."""
    import http.client

    from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest, Server
    from platform_aware_scheduling_tpu_torch.kube.lease import parse_lease_time
    from platform_aware_scheduling_tpu_torch.kube.retry import (
        FENCED_WRITE_VERBS,
        GROUP_KUBE,
        READ_VERBS,
        STATE_CLOSED,
        WRITE_VERBS,
        verb_group,
    )
    from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
    from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
    from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy
    from platform_aware_scheduling_tpu_torch.tas.telemetryscheduler import MetricsExtender
    from platform_aware_scheduling_tpu_torch.utils import trace
    from platform_aware_scheduling_tpu_torch.utils.gctuning import tune_for_serving

    period, a, plan, kube = ctx.period, ctx.a, ctx.plan, ctx.kube
    out = {}
    now = time.perf_counter

    def cycles_of(name=None, branch=None, after=0.0, before=float("inf")):
        return [
            c for c in list(ctx.cycles)
            if (name is None or c["replica"] == name) and (branch is None or c["branch"] == branch)
            and c["start"] >= after and c["start"] < before
        ]

    def decision(r, which="prioritize"):
        return getattr(r.ext.degraded, f"{which}_decision")()[0]

    def conditions(r):
        _status, body = http_get(r.server.port, "/readyz")
        return {c["name"]: c for c in json.loads(body)["conditions"]}

    def labels_hold(r, what):
        """After a label cycle of ``r`` (the leader) that started now or
        later and the end of its period, every policy's labels equal the
        host evaluation over ``r``'s cache."""
        t0 = now()
        wait_for(lambda: cycles_of(r.name, "labels", after=t0), 3 * period, f"a label cycle of {r.name} {what}")
        ctx.between_periods(r.name)
        labels = ctx.labels_of()
        for name, rules_ in ctx.policies.items():
            ok, _nulls = ctx.labels_match(name, rules_, labels, r.cache)
            check(ok, f"faults: {name}'s labels differ from the host evaluation {what}")

    # the requests both replicas answer: 2 pods of each remaining policy
    mix = [
        (verb, args_body(pod.name, name, ctx.nodes))
        for name in sorted(ctx.policies)
        for pod in ctx.pods[name][:2]
        for verb in ("filter", "prioritize")
    ]

    # 1. replica B, and the roles
    b = ctx.replica("replica-b")
    informers = {"taspolicy": b.controller.informer, "pods": b.planner.feed.informers[0],
                 "nodes": b.planner.feed.informers[1]}
    synced = {}

    def b_synced():
        for name, informer in informers.items():
            if name not in synced and informer.has_synced():
                synced[name] = now() - b.t_assemble
        return len(synced) == len(informers)

    wait_for(b_synced, 120, "replica B's initial syncs", poll_s=0.005)
    out["b_sync_s"] = synced
    out["b_assembled_at"] = b.t_assemble
    # B's main would apply the GC posture here, after its initial lists
    tune_for_serving()
    for r in (a, b):
        r.ext.degraded.lkg_max_age_s = LKG_MAX_AGE_S
    wait_for(lambda: b.cache.telemetry_freshness()[0] and len(b.cache.registered_metric_names()) > 0,
             3 * period, "replica B's first refresh")
    t_fresh = now()
    wait_for(
        lambda: any(r["replica"] == b.name and r["solved"] and r["start"] > t_fresh for r in ctx.replans)
        and len(cycles_of(b.name, after=t_fresh)) >= 3,
        3 * period,
        "replica B's first replan and 3 cycles on fresh telemetry",
    )
    out["b_ready_s"] = now() - b.t_assemble
    check(a.elector.is_leader() and not b.elector.is_leader(), "faults: replica A does not lead, or B does")
    check(b.elector.status()["lease"]["holder"] == a.name, "faults: B does not see A hold the lease")
    for r in (a, b):
        for _attempt in range(5):  # a tick between the two reads moves the tick count
            got, want = http_get(r.server.port, "/debug/leader"), (200, r.elector.to_json())
            if got == want:
                break
        check(got == want, f"faults: {r.name}'s /debug/leader is not its elector's state")
    pre = {}
    for verb, body in mix:
        got = ctx.send(verb, body, to=a)
        check(got[0] == 200 and got == ctx.send(verb, body, to=b), f"faults: B's {verb} differs from A's")
        pre[body, verb] = got
    follower = cycles_of(b.name, after=t_fresh)
    check(all(c["branch"] == "follower" and c["patches"] == 0 for c in follower),
          "faults: the follower wrote labels")

    # 2. the metrics-API outage
    spans = {}
    served = PathsServed()  # the phase's verbs, by the path that served them
    trace.SPAN_OBSERVERS.append(served)
    trace.SPAN_OBSERVERS.append(lambda span: spans.__setitem__(span.trace_id, span))

    def send_id(r, verb, body, rid):
        conn = http.client.HTTPConnection("127.0.0.1", r.server.port, timeout=120)
        try:
            conn.request("POST", f"/scheduler/{verb}", body=body,
                         headers={"Content-Type": "application/json", "X-Request-ID": rid})
            resp = conn.getresponse()
            got = resp.status, resp.read()
        finally:
            conn.close()
        wait_for(lambda: rid in spans, 5, f"the span of {rid}", poll_s=0.005)
        return got, spans[rid]

    try:
        t_out = now()
        plan.outage("get_node_custom_metric")
        out["to_degraded_s"] = wait_for(lambda: not conditions(a)["degraded_mode"]["ok"], 3 * period,
                                        "/readyz to show degraded_mode", poll_s=0.05)
        t_degraded = now()
        lkg = 0
        for i, (verb, body) in enumerate(mix):
            if decision(a) != "last_known_good":
                break
            got, span = send_id(a, verb, body, f"lkg-{i}")
            if decision(a) != "last_known_good":
                break  # the window closed under the request
            check(got == pre[body, verb], f"faults: a last-known-good {verb} differs from the answer before the outage")
            if verb == "prioritize":
                check(span.attrs.get("path") == "native" and span.attrs.get("degraded"),
                      f"faults: a last-known-good Prioritize took path {span.attrs.get('path')}")
                lkg += 1
        check(lkg > 0, "faults: no Prioritize was answered within the last-known-good window")
        out["lkg_requests"] = lkg
        wait_for(lambda: decision(a) == "neutral" and decision(b) == "neutral", LKG_MAX_AGE_S + 3 * period,
                 "Prioritize to turn neutral")
        out["to_neutral_s"] = now() - t_out
        check(decision(a, "filter") == "fail_open", "faults: Filter does not fail open past the window")
        # the CPU-mirror twin in the same state: the policies from the API
        # server, the replica's own degraded-mode controller
        twin_cache = AutoUpdatingCache()
        twin_mirror = TensorStateMirror(device="cpu")
        twin_mirror.attach(twin_cache)
        for item in kube.list_taspolicies()["items"]:
            policy = TASPolicy.from_obj(item)
            twin_cache.write_policy(policy.namespace, policy.name, policy)
        twin = MetricsExtender(twin_cache, mirror=twin_mirror, node_cache_capable=True)
        twin.degraded = a.ext.degraded
        twin_server = Server(twin)
        for verb, body in mix:
            got = ctx.send(verb, body, to=a)
            want = twin_server.route(HTTPRequest("POST", f"/scheduler/{verb}", {"Content-Type": "application/json"}, body))
            check(got == (want.status, want.body) == ctx.send(verb, body, to=b),
                  f"faults: a neutral or fail-open {verb} differs from the CPU twin's")
            if verb == "prioritize":
                check({e["Score"] for e in json.loads(got[1])} == {0}, "faults: Prioritize is not neutral")
            else:
                check(json.loads(got[1])["FailedNodes"] == {}, "faults: Filter does not fail open")
        # the verbs' times in this state, over one keep-alive connection
        conn = http.client.HTTPConnection("127.0.0.1", a.server.port, timeout=120)
        times = {}
        try:
            for verb in ("filter", "prioritize"):
                bodies = [body for v, body in mix if v == verb]
                times[verb] = []
                for i in range(FAULTS_TIMED_REQUESTS):
                    t0 = now()
                    conn.request("POST", f"/scheduler/{verb}", body=bodies[i % len(bodies)],
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    resp.read()
                    times[verb].append((now() - t0) * 1e3)
                    check(resp.status == 200, f"faults: a timed {verb} answered {resp.status}")
        finally:
            conn.close()
        check(decision(a) == "neutral" and decision(a, "filter") == "fail_open",
              "faults: the state changed while the verbs were timed")
        out["verbs"] = {verb: {"p50_ms": statistics.median(t), "p99_ms": percentile(t, 0.99), "max_ms": max(t)}
                        for verb, t in times.items()}

        # no warm pass raised on a cache whose refreshes fail
        warm_ok = lambda: all(r.ext.readiness_conditions()[0][1]() == (True, "fastpath warmed") for r in (a, b))  # noqa: E731
        check(warm_ok(), "faults: a warm pass failed during the metrics outage")

        # 3. recovery
        t_clear = now()
        plan.clear("get_node_custom_metric")
        for r in (a, b):
            wait_for(lambda r=r: r.breakers.states().get("metrics") == STATE_CLOSED and conditions(r)["degraded_mode"]["ok"],
                     CIRCUIT_RESET_S + 3 * period, f"{r.name}'s telemetry to recover")
            out[f"recovery_s_{r.name}"] = now() - t_clear
        t_recovered = now()
        # while the outage lasted, every cycle wrote nothing and the
        # leader's were suspended (after it, recovery may come at any time)
        window = cycles_of(after=t_degraded, before=t_clear)
        check(all(c["patches"] == 0 for c in window), "faults: a cycle wrote labels during the metrics outage")
        check(all(c["branch"] == "suspended" for c in window if c["replica"] == a.name)
              and cycles_of(a.name, "suspended", t_degraded, t_clear),
              "faults: the leader's cycles were not suspended during the metrics outage")
        out["metrics_suspended_cycles"] = len(cycles_of(a.name, "suspended", t_degraded, t_recovered))
        labels_hold(a, "after the metrics outage")
        check(warm_ok(), "faults: a warm pass failed after the recovery")

        # 4. the kube-API outage, from just after a renew of the leader, so
        # its grant outlasts the outage
        kube_verbs = sorted(v for v in READ_VERBS | WRITE_VERBS | FENCED_WRITE_VERBS if verb_group(v) == GROUP_KUBE)
        leader = a if a.elector.is_leader() else b
        ticks = leader.elector.status()["ticks"]
        wait_for(lambda: leader.elector.status()["ticks"] > ticks, 2 * LEASE_RENEW_S, "a renew of the leader")
        t_kube = now()
        for verb in kube_verbs:
            plan.outage(verb)
        wait_for(lambda: leader.breakers.states().get("kube", STATE_CLOSED) != STATE_CLOSED, 3 * period,
                 "the kube circuit to open")
        t_open = now()
        out["kube_open_s"] = t_open - t_kube
        # held until a suspended cycle of the leader, and cleared before the
        # circuit's first half-open probe, which would fail and re-arm it
        while not cycles_of(leader.name, "suspended", t_open) and now() < t_open + CIRCUIT_RESET_S - 0.5:
            time.sleep(0.02)
        for verb, body in mix[:2]:
            check(ctx.send(verb, body, to=leader) == pre[body, verb], f"faults: {verb} differs during the kube outage")
        t_kube_clear = now()
        plan.clear()
        wait_for(lambda: leader.breakers.states().get("kube") == STATE_CLOSED, CIRCUIT_RESET_S + 2 * period,
                 "the kube circuit to close")
        t_closed = now()
        out["kube_held_s"] = t_kube_clear - t_kube
        out["kube_close_s"] = t_closed - t_kube_clear
        check(out["kube_close_s"] <= CIRCUIT_RESET_S + period,
              f"faults: the kube circuit closed {out['kube_close_s']:.3f} s after the outage")
        # no circuit can close while the outage lasts: no label pass then
        window = cycles_of(after=t_open, before=t_kube_clear)
        check(all(c["branch"] != "labels" and c["patches"] == 0 for c in window),
              "faults: a cycle ran its label pass while the kube circuit was open")
        out["kube_suspended_cycles"] = len(cycles_of(branch="suspended", after=t_open, before=t_closed))
        check(out["kube_suspended_cycles"] > 0, "faults: no cycle was suspended while the kube circuit was open")
        out["kube_probes"] = sum(c["probes"] for c in cycles_of(branch="suspended", after=t_kube_clear, before=t_closed))
        wait_for(lambda: a.elector.is_leader() or b.elector.is_leader(), LEASE_DURATION_S + 2 * period,
                 "a leader after the kube outage")
        leader = a if a.elector.is_leader() else b
        out["leader_after_kube"] = leader.name
        wait_for(lambda: any(c["patches"] for c in cycles_of(leader.name, "labels", t_closed)), 3 * period,
                 "the labels to resume")
        out["labels_resume_s"] = now() - t_closed

        # 5. failover: the leader crashes, its lease not released
        old, new = (a, b) if leader is a else (b, a)
        token = old.elector.fencing_token()
        lease = kube.get_lease(old.elector.namespace, old.elector.lease_name)["spec"]
        t_crash = now()
        t_expiry = t_crash + parse_lease_time(lease["renewTime"]) + lease["leaseDurationSeconds"] - time.time()
        old.stop.set()
        old.server.shutdown()
        bound = LEASE_DURATION_S + LEASE_RENEW_S + period
        out["failover_s"] = wait_for(lambda: new.elector.is_leader(), bound + period, "the follower to lead")
        check(out["failover_s"] <= bound, f"faults: failover took {out['failover_s']:.3f} s, over its {bound:.0f} s bound")
        check(new.elector.fencing_token() == token + 1,
              f"faults: fencing token {new.elector.fencing_token()} after {token}")
        out["failover"] = f"{old.name} -> {new.name}, token {token} -> {token + 1}"
        labels_hold(new, "after the failover")
        check(not any(c["patches"] for c in ctx.cycles if c["replica"] == old.name and c["end"] > t_expiry),
              "faults: the old leader wrote labels after its lease ran out")
        check(not cycles_of(old.name, after=t_crash), "faults: the crashed replica kept enforcing")
    finally:
        trace.SPAN_OBSERVERS.pop()
        trace.SPAN_OBSERVERS.remove(served)
        plan.clear()
    out["paths"] = served.line()
    out["seconds"] = now() - b.t_assemble
    return out


def faults_lines(s: dict, card: str) -> list:
    f = s["faults"]
    ms = lambda cs: [(c["end"] - c["start"]) * 1e3 for c in cs]  # noqa: E731
    suspended = ms([c for c in f["cycles"] if c["branch"] == "suspended"])
    follower = ms([c for c in f["cycles"] if c["branch"] == "follower"])
    sync = ", ".join(f"{k} {v:.3f} s" for k, v in f["b_sync_s"].items())
    verbs = "; ".join(
        f"{verb} p50 {t['p50_ms']:.3f} ms p99 {t['p99_ms']:.3f} ms max {t['max_ms']:.3f} ms"
        for verb, t in f["verbs"].items()
    )
    launches = ", ".join(f"{k} {v}" for k, v in f["launches_by_replica"].items())
    worst = max((c for c in f["cycles"] if c["branch"] == "follower"), key=lambda c: c["end"] - c["start"])
    return [
        f"faults replica B: initial syncs {sync}; ready (3 cycles and a replan on fresh telemetry) "
        f"{f['b_ready_s']:.3f} s after its assemble; one leader (replica-a), /debug/leader = each elector's "
        f"state, the follower's answers = the leader's, 0 follower patches [{card}]",
        f"faults metrics outage: /readyz degraded_mode after {f['to_degraded_s']:.3f} s, "
        f"{f['lkg_requests']} Prioritize last-known-good answers = the pre-outage bytes on the native path, "
        f"neutral after {f['to_neutral_s']:.3f} s; neutral and fail-open bytes = the CPU twin's; "
        f"{FAULTS_TIMED_REQUESTS} requests each: {verbs}; {f['metrics_suspended_cycles']} suspended leader cycles, "
        f"0 patches; recovered in {f['recovery_s_replica-a']:.3f} s (A), {f['recovery_s_replica-b']:.3f} s (B); "
        f"labels = host evaluation [{card}]",
        f"faults kube outage: circuit open after {f['kube_open_s']:.3f} s, outage held {f['kube_held_s']:.3f} s, "
        f"{f['kube_suspended_cycles']} suspended cycles with 0 patches ({f['kube_probes']} probes reached the API "
        f"after the outage), closed {f['kube_close_s']:.3f} s after it (limit {CIRCUIT_RESET_S + SERVICE_SYNC_PERIOD_S:.0f} s), "
        f"leader after it {f['leader_after_kube']}, labels resumed in {f['labels_resume_s']:.3f} s [{card}]",
        f"faults failover {f['failover']}: {f['failover_s']:.3f} s (bound "
        f"{LEASE_DURATION_S + LEASE_RENEW_S + SERVICE_SYNC_PERIOD_S:.0f} s); labels = host evaluation; no patch by "
        f"the old leader after its lease ran out [{card}]",
        f"faults cycles: {len(suspended)} suspended p50 {statistics.median(suspended):.3f} ms max "
        f"{max(suspended):.3f} ms; {len(follower)} follower p50 {statistics.median(follower):.3f} ms max "
        f"{max(follower):.3f} ms (the worst {worst['start'] - f['b_assembled_at']:.3f} s after B's assemble, beside "
        f"the replicas' refresh passes for {overlap_s(worst, f['refreshes']) * 1e3:.3f} ms, full collections for "
        f"{overlap_s(worst, f['full_collections']) * 1e3:.3f} ms); violated_nodes calls = policies in every cycle, "
        f"on the card; greedy_assign "
        f"launches {f['launches']} ({launches}), one a solved replan; phase {f['seconds']:.3f} s [{card}]",
        f"faults verbs' paths (span path/filter cache; degraded Filters bypass the cache, last-known-good "
        f"Prioritize is native, neutral is neither): {f['paths']} [{card}]",
    ]


def check_faults_limits(s: dict) -> None:
    """PERF.md section 2: the verbs' p99 in the degraded state and every
    cycle of the phase within their limits."""
    f = s["faults"]
    for verb, t in f["verbs"].items():
        check(t["p99_ms"] <= VERB_P99_LIMIT_MS, f"faults: {verb} p99 {t['p99_ms']:.3f} ms over {VERB_P99_LIMIT_MS} ms")
    worst = max(c["end"] - c["start"] for c in f["cycles"])
    check(worst <= ENFORCE_CYCLE_LIMIT_S, f"faults: a cycle took {worst * 1e3:.3f} ms, over its limit")


# -- phase 9: the GAS extender -----------------------------------------------------

GAS_CARDS = 8
GAS_BURST = 300
GAS_NO_GPU_SHARE = 0.01  # nodes without the cards label
GAS_VANISHED_SHARE = 0.01  # nodes whose label lost a card that still carries usage
GAS_BOOKED_CARD_SHARE = 0.8  # cards with a booked share
GAS_SHARE_MILLICORES = (250, 500, 750, 1000)  # a booked card's millicores, of 1000
GAS_RANDOM_PARITY_STATES = 64
INT64_MAX = 2**63 - 1


def gas_node_names() -> list:
    return [f"gpu-node-{i:05d}" for i in range(NUM_NODES)]


def gas_template_pod(name: str) -> dict:
    """The two-container pod of the JAX package's GAS load
    (``benchmarks/gas_load.make_bodies``): per GPU, c0 asks 250 millicores
    on 2 cards and c1 1500 on one, over a card's 1000, so it fits no node."""
    return {
        "metadata": {"name": name, "namespace": "default", "uid": f"uid-{name}"},
        "spec": {
            "containers": [
                {"name": "c0", "resources": {"requests": {"gpu.intel.com/i915": "2", "gpu.intel.com/millicores": "500"}}},
                {"name": "c1", "resources": {"requests": {"gpu.intel.com/i915": "1", "gpu.intel.com/millicores": "1500"}}},
            ]
        },
        "status": {"phase": "Pending"},
    }


def gas_single_pod(name: str) -> dict:
    """One container asking 1 GPU and 250 millicores."""
    return {
        "metadata": {"name": name, "namespace": "default", "uid": f"uid-{name}"},
        "spec": {
            "containers": [
                {"name": "c0", "resources": {"requests": {"gpu.intel.com/i915": "1", "gpu.intel.com/millicores": "250"}}}
            ]
        },
        "status": {"phase": "Pending"},
    }


def build_gas_world(np, kube) -> dict:
    """The JAX package's GAS world at the smoke's node count: 8 cards a
    node, ``i915: 8``, ``millicores: 8000``, ``memory.max: 64000``; 1% of
    nodes without the cards label and 1% whose label lost card7 while a
    bound pod still books it; on the rest, each card booked with
    probability 0.8 by one bound, annotated pod a node (``i915`` = its
    cards, the same 250-1000 millicores on each).  Then the burst's pending
    pods.  Objects go straight into the fake's store, as one list would
    bring them."""
    rng = np.random.default_rng(SEED + 7)
    names = gas_node_names()
    kinds = rng.random(NUM_NODES)
    all_cards = [f"card{c}" for c in range(GAS_CARDS)]
    allocatable = {
        "gpu.intel.com/i915": str(GAS_CARDS),
        "gpu.intel.com/millicores": str(1000 * GAS_CARDS),
        "gpu.intel.com/memory.max": str(8000 * GAS_CARDS),
    }
    booked_mc = 0
    pods = 0
    counts = {"no_gpu": 0, "vanished": 0}
    booked_cards = rng.random((NUM_NODES, GAS_CARDS)) < GAS_BOOKED_CARD_SHARE
    share = rng.choice(GAS_SHARE_MILLICORES, size=NUM_NODES)
    for i, name in enumerate(names):
        labels = {"gpu.intel.com/cards": ".".join(all_cards)}
        cards = [c for c, on in zip(all_cards, booked_cards[i]) if on]
        if kinds[i] < GAS_NO_GPU_SHARE:
            labels, cards = {}, []
            counts["no_gpu"] += 1
        elif kinds[i] < GAS_NO_GPU_SHARE + GAS_VANISHED_SHARE:
            labels = {"gpu.intel.com/cards": ".".join(all_cards[:-1])}
            if all_cards[-1] not in cards:
                cards.append(all_cards[-1])
            counts["vanished"] += 1
        kube.add_node({"metadata": {"name": name, "labels": labels}, "status": {"allocatable": dict(allocatable)}})
        if not cards:
            continue
        m = int(share[i])
        kube.add_pod({
            "metadata": {
                "name": f"booked-{i:05d}",
                "namespace": "default",
                "uid": f"uid-booked-{i:05d}",
                "annotations": {"gas-container-cards": ",".join(cards), "gas-ts": "1"},
            },
            "spec": {
                "nodeName": name,
                "containers": [{"name": "c0", "resources": {"requests": {
                    "gpu.intel.com/i915": str(len(cards)), "gpu.intel.com/millicores": str(m * len(cards))}}}],
            },
            "status": {"phase": "Running"},
        })
        pods += 1
        booked_mc += m * len([c for c in cards if c in labels.get("gpu.intel.com/cards", "").split(".")])
    burst = [gas_template_pod(f"gas-burst-{i:03d}") if i % 2 == 0 else gas_single_pod(f"gas-burst-{i:03d}")
             for i in range(GAS_BURST)]
    warm = [gas_single_pod(f"gas-warm-{i}") for i in range(2)]
    for pod in burst + warm:
        kube.add_pod(pod)
    gpu_nodes = NUM_NODES - counts["no_gpu"]
    return {
        "names": names,
        "burst": burst,
        "warm": warm,
        "booked_pods": pods,
        "booked_millicores_share": booked_mc / (gpu_nodes * GAS_CARDS * 1000 - counts["vanished"] * 1000),
        **counts,
    }


def gas_request(mirror, pod_raw: dict, device):
    """The staged bin-pack request of a pod over the mirror's resources,
    as ``DeviceBinpacker`` stages it: (request, K)."""
    from platform_aware_scheduling_tpu_torch.gas import device as gas_device
    from platform_aware_scheduling_tpu_torch.gas import scheduler as gas_scheduler
    from platform_aware_scheduling_tpu_torch.gas.utils import container_requests
    from platform_aware_scheduling_tpu_torch.kube.objects import Pod

    requests = container_requests(Pod(pod_raw))
    shares = [gas_scheduler.get_per_gpu_resource_request(r) for r in requests]
    state = mirror.snapshot()[0]
    return gas_device.stage_request(requests, shares, mirror.resource_index(), state.capacity.shape[-1], device)


def gas_parity_cases(torch, np):
    """(name, state, request, K) on the card, from numpy seeds: int64
    edges, zero-card nodes, a request equal to the per-card capacity,
    repeat picks, card order unlike lane order, T=4 K=8, a grown C=16
    R=8 mirror, random states near the int64 bounds, a state for every
    instance of the kernel and the JAX tie at order 2^30."""
    from platform_aware_scheduling_tpu_torch.ops.binpack import BinpackNodeState, BinpackRequest

    rng = np.random.default_rng(SEED + 8)

    def case(name, k, used, capacity, need, cap_present=None, card_valid=None, card_real=None,
             card_order=None, need_active=None, num_gpus=None, container_active=None):
        used = np.asarray(used, np.int64)
        capacity = np.asarray(capacity, np.int64)
        need = np.asarray(need, np.int64)
        n, c, r = used.shape
        t = need.shape[0]

        def put(array, dtype):
            return torch.from_numpy(np.ascontiguousarray(np.asarray(array, dtype))).cuda()

        state = BinpackNodeState(
            used=put(used, np.int64),
            capacity=put(capacity, np.int64),
            cap_present=put(np.ones((n, r), bool) if cap_present is None else cap_present, bool),
            card_valid=put(np.ones((n, c), bool) if card_valid is None else card_valid, bool),
            card_real=put(np.ones((n, c), bool) if card_real is None else card_real, bool),
            card_order=put(np.broadcast_to(np.arange(c), (n, c)) if card_order is None else card_order, np.int32),
        )
        request = BinpackRequest(
            need=put(need, np.int64),
            need_active=put(need != 0 if need_active is None else need_active, bool),
            num_gpus=put(np.ones(t) if num_gpus is None else num_gpus, np.int32),
            container_active=put(np.ones(t, bool) if container_active is None else container_active, bool),
        )
        return name, state, request, k

    def rand(shape, hi):
        v = rng.integers(0, hi, size=shape, dtype=np.int64)
        pick = rng.random(shape)
        v = np.where(pick < 0.06, INT64_MAX - rng.integers(0, 4, size=shape), v)
        return np.where((pick >= 0.06) & (pick < 0.09), -rng.integers(1, 4, size=shape), v)

    def perms(n, c):
        return np.stack([rng.permutation(c) for _ in range(n)])

    cases = [
        case("int64: capacity INT64_MAX, need INT64_MAX", 1, [[[0]]], [[INT64_MAX]], [[INT64_MAX]]),
        case("int64: used near the maximum", 1, [[[INT64_MAX - 2]], [[INT64_MAX - 1]]], [[INT64_MAX]] * 2, [[2]]),
        case("int64: an add that overflows", 1, [[[INT64_MAX]], [[2**62]]], [[INT64_MAX]] * 2, [[2**62 + 1]]),
        case("zero-card nodes", 1, [[[0], [0]]] * 3, [[100]] * 3, [[10]],
             card_real=[[False, False], [True, True], [True, True]], card_valid=[[True, True], [False, False], [True, False]]),
        case("request equal to the per-card capacity", 2, [[[0], [0]], [[1], [0]]], [[100]] * 2, [[100]], num_gpus=[2]),
        case("repeat picks on one card", 4, [[[0], [0]]], [[100]], [[25]], num_gpus=[4]),
        case("card_order unlike lane order", 3, [[[0]] * 4] * 2, [[100]] * 2, [[60]], num_gpus=[3],
             card_order=[[3, 1, 1, 0], [2**30 + 1, 0, 2, 1]]),
        case("T=4, K=8", 8, rng.integers(0, 40, (64, 8, 4)), rng.integers(50, 200, (64, 4)),
             rng.integers(0, 30, (4, 4)), num_gpus=[8, 3, 0, 5], container_active=[True, True, True, False]),
        case("mirror grown to C=16, R=8", 4, rng.integers(0, 40, (64, 16, 8)), rng.integers(50, 200, (64, 8)),
             rng.integers(0, 30, (2, 8)), need_active=rng.random((2, 8)) < 0.6, cap_present=rng.random((64, 8)) < 0.9,
             card_valid=rng.random((64, 16)) < 0.9, card_real=np.arange(16)[None, :] < rng.integers(1, 17, (64, 1)),
             card_order=perms(64, 16), num_gpus=[4, 2]),
    ]
    for i in range(GAS_RANDOM_PARITY_STATES):
        n, c, r, t, k = ((256, 4, 4, 2, 2), (256, 8, 4, 2, 4), (256, 4, 2, 4, 2), (256, 40, 4, 2, 2))[i % 4]
        cases.append(case(
            f"random {i}", k, rand((n, c, r), 60), rand((n, r), 120), rand((t, r), 50),
            cap_present=rng.random((n, r)) < 0.9, card_valid=rng.random((n, c)) < 0.9,
            card_real=rng.random((n, c)) < 0.9,
            card_order=np.where(rng.random((n, c)) < 0.05, 2**30 + rng.integers(0, 2, (n, c)), perms(n, c)),
            need_active=rng.random((t, r)) < 0.7, num_gpus=rng.integers(0, k + 1, size=t),
            container_active=rng.random(t) < 0.9,
        ))

    # every instance of the kernel: groups of 1 to 32 lanes (padding lanes
    # at C = 3, 5, 31), two cards a lane (C = 33, 64), rooms in registers
    # (R = 4, 8) and past them in shared memory (R = 12, 100) or the
    # wrapper's scratch (R = 300); 101 nodes leave a ragged last block
    for c, r in [(c, r) for c in (1, 2, 3, 5, 8, 16, 31, 32, 33, 64) for r in (4, 8, 12)] + [
        (8, 100), (5, 300), (40, 300),
    ]:
        n, t, k = 101, 3, 3
        wide = r > 12  # cards that fit somewhere in every resource, so shares are booked past R = 8
        cases.append(case(
            f"width C={c} R={r}", k, rng.integers(0, 40, (n, c, r)) if wide else rand((n, c, r), 60),
            rng.integers(100 if wide else 60, 200, (n, r)), rng.integers(0, 30, (t, r)),
            cap_present=rng.random((n, r)) < (1.0 if wide else 0.98),
            card_valid=rng.random((n, c)) < 0.9, card_real=np.arange(c)[None, :] < rng.integers(1, c + 1, (n, 1)),
            card_order=np.where(rng.random((n, c)) < 0.05, 2**30 + rng.integers(-1, 2, (n, c)), perms(n, c)),
            need_active=rng.random((t, r)) < 0.5, num_gpus=[3, 1, 2],
        ))

    # the JAX tie: best is the min over real lanes of where(fits, order,
    # 2^30), the pick the lowest fitting lane with that order
    big = 2**30
    cases.append(case(
        "tie: a fitting lane of order 2^30 above a lower lane that does not fit", 2,
        [[[0] * 4] * 8, [[50] + [0] * 3] + [[0] * 4] * 7, [[0] * 4] * 8, [[0] * 4, [90] + [0] * 3] + [[0] * 4] * 6],
        [[100] * 4] * 4, [[60, 0, 0, 0]], num_gpus=[2],
        card_valid=[[False] + [True] * 7] + [[True] * 8] * 3,
        card_order=[[0, big] + [big + 1] * 6, [0, big, big] + [big + 1] * 5,
                    [big + 2, big + 1, big + 1] + [big + 3] * 5, [big, 7, 9, big] + [big + 5] * 4],
    ))
    cases.append(case(
        "padding lanes (C=5 in a group of 8) beside orders past 2^30", 2,
        [[[0] * 4] * 5] * 4, [[100] * 4] * 4, [[40, 0, 0, 0]], num_gpus=[2],
        card_valid=[[True, False, False, False, False]] + [[True] * 5] * 3,
        card_real=[[True] * 5, [True] * 5, [True, True, True, False, False], [True] * 5],
        card_order=[[big + 1, 0, 1, 2, 3], [big + 3, big + 1, big + 2, big + 1, big + 5],
                    [big + 1, big + 2, big + 3, 0, 1], [5, big + 1, 3, big + 1, big + 2]],
    ))
    return cases


def run_gas_parity(torch, cases) -> int:
    """The bin-pack kernel against its plain version on the card, exactly,
    on every case; returns the largest absolute difference (0 when exact).
    These launches are not the main path's."""
    from platform_aware_scheduling_tpu_torch.ops.binpack import binpack_reference
    from platform_aware_scheduling_tpu_torch.ops.cuda_binpack import binpack_cuda

    max_err = 0
    randoms = 0
    for name, state, request, k in cases:
        got = binpack_cuda(state, request, k)
        want = binpack_reference(state, request, k)
        torch.cuda.synchronize()
        for out, ref in zip(got, want):
            check(out.dtype == ref.dtype and out.shape == ref.shape, f"gas parity {name}: output form")
            if out.numel():
                max_err = max(max_err, (out.long() - ref.long()).abs().max().item())
            check(torch.equal(out, ref), f"gas parity {name}: kernel disagrees with the plain version")
        if name.startswith("random"):
            randoms += 1
        else:
            booked = int((got.cards >= 0).sum())
            print(f"gas parity {name}: exact ({int(got.fits.sum())} of {got.fits.numel()} nodes fit, "
                  f"{booked} cards booked)")
    print(f"gas parity: {len(cases)} cases exact, {randoms} of them random states near the int64 bounds")
    return max_err


def start_ptxas_report(name: str):
    """Start ``nvcc -Xptxas -v`` on ``csrc/<name>.cu`` (a cubin under the
    build directory, beside the kernels' build); :func:`binpack_ptxas_report`
    and :func:`forecast_ptxas_report` read it."""
    from platform_aware_scheduling_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    command = [
        _build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin",
        "-Xptxas", "-v", "-o", str(_build.BUILD_DIR / f"{name}-ptxas.cubin"), str(_build.CSRC / f"{name}.cu"),
    ]
    return subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def forecast_ptxas_report(proc) -> dict:
    """The ring kernel's registers, stack bytes and spill bytes from
    ptxas's report; fails unless it has no stack and no spills."""
    output, _ = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"forecast: nvcc -Xptxas -v exited {proc.returncode}\n{output}")
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", output)
    used = re.search(r"Used (\d+) registers", output)
    check(frame is not None and used is not None, f"forecast: no ptxas report in\n{output}")
    stack, stores, loads = (int(x) for x in frame.groups())
    check(stack == 0 and stores + loads == 0, f"forecast: {stack} bytes of stack, {stores + loads} of spills")
    return {"registers": int(used.group(1)), "stack": stack, "spills": stores + loads}


def binpack_ptxas_report(proc) -> dict:
    """(G, cards a lane, resources in registers) -> registers, stack bytes
    and spill bytes of each instance of the bin-pack kernel, from ptxas's
    report; fails unless the main path's instance (G = 8, one card a lane,
    4 resources) has no stack and no spills."""
    output, _ = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"binpack: nvcc -Xptxas -v exited {proc.returncode}\n{output}")
    instances, current = {}, None
    for line in output.splitlines():
        named = re.search(r"(?:Compiling entry function '|Function properties for )\S*?binpack_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
        if named:
            current = instances.setdefault(tuple(int(x) for x in named.groups()), {})
            continue
        if current is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if frame:
            current["stack"], stores, loads = (int(x) for x in frame.groups())
            current["spills"] = stores + loads
        used = re.search(r"Used (\d+) registers", line)
        if used:
            current["registers"] = int(used.group(1))
    check(len(instances) == 14 and all(len(v) == 3 for v in instances.values()),
          f"binpack: ptxas reported {len(instances)} kernel instances, want 14")
    main = instances[(8, 1, 4)]
    check(main["stack"] == 0 and main["spills"] == 0,
          f"binpack: the main path's instance has {main['stack']} bytes of stack, {main['spills']} of spills")
    return instances


def fused_ptxas_report(proc) -> dict:
    """Registers, stack bytes and spill bytes of the fused scan's two
    kernels, from ptxas's report."""
    output, _ = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"fused: nvcc -Xptxas -v exited {proc.returncode}\n{output}")
    kernels, current = {}, None
    for line in output.splitlines():
        named = re.search(r"(?:Compiling entry function '|Function properties for )\S*?(candidates_kernel|resolve_kernel)", line)
        if named:
            current = kernels.setdefault(named.group(1), {})
            continue
        if current is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if frame:
            current["stack"], stores, loads = (int(x) for x in frame.groups())
            current["spills"] = stores + loads
        used = re.search(r"Used (\d+) registers", line)
        if used:
            current["registers"] = int(used.group(1))
    check(sorted(kernels) == ["candidates_kernel", "resolve_kernel"] and all(len(v) == 3 for v in kernels.values()),
          f"fused: no ptxas report of both kernels in\n{output}")
    return kernels


def check_card_limit(torch) -> None:
    from platform_aware_scheduling_tpu_torch.ops.binpack import BinpackNodeState, BinpackRequest
    from platform_aware_scheduling_tpu_torch.ops.cuda_binpack import binpack_cuda, max_cards

    n, c, r = 1, max_cards() + 1, 4
    z = torch.zeros((n, c, r), dtype=torch.int64, device="cuda")
    state = BinpackNodeState(z, z[:, 0], z[:, 0].bool(), z[..., 0].bool(), z[..., 0].bool(), z[..., 0].int())
    request = BinpackRequest(z[0, :2], z[0, :2].bool(), z[0, :2, 0].int(), z[0, :2, 0].bool())
    launches = binpack_cuda.LAUNCHES
    try:
        binpack_cuda(state, request, 2)
    except ValueError:
        check(binpack_cuda.LAUNCHES == launches, "gas: a refused shape counted a launch")
        print(f"gas parity: C={c} refused above the kernel's {c - 1}-card limit")
        return
    raise SmokeError("C beyond the kernel's card limit was not refused")


def time_binpack(torch, state, request, k: int) -> dict:
    """Kernel and plain-version times on the main path's state, and the
    least time the card could take: the bytes the function must move (the
    state's arrays read once, fits and cards written once) over the card's
    memory rate.  ``ms`` is the kernel's device time (:func:`graph_ms`),
    ``call_ms`` the time of wrapper calls one after another, as the main
    path makes them on every fits-cache miss; ``profiler_ms`` is
    ``torch.profiler``'s reading of the kernel; ``floor_ms`` is what
    :func:`graph_ms` reads for a one-element add, the least any kernel
    takes so measured."""
    from platform_aware_scheduling_tpu_torch.ops.binpack import binpack_reference
    from platform_aware_scheduling_tpu_torch.ops.cuda_binpack import binpack_cuda

    n, c, r = state.used.shape
    t = request.need.shape[0]
    bytes_needed = sum(x.numel() * x.element_size() for x in (*state, *request)) + n + 4 * n * t * k
    launches = binpack_cuda.LAUNCHES
    call = lambda: binpack_cuda(state, request, k)  # noqa: E731
    device_ms = graph_ms(torch, call, 50)
    one = torch.zeros(1, device=state.used.device)
    out = {
        "shape": [n, c, r, t, k],
        "ms": device_ms,
        "device_ms": device_ms,
        "floor_ms": graph_ms(torch, lambda: one.add_(1), 50),
        "call_ms": cuda_ms(torch, call, 50),
        "profiler_ms": profiled_ms(torch, call, ("binpack_kernel",), 50),
        "plain_ms": cuda_ms(torch, lambda: binpack_reference(state, request, k), 5),
        "bound_ms": bytes_needed / HBM_BYTES_PER_S * 1e3,
        "bytes": bytes_needed,
    }
    binpack_cuda.LAUNCHES = launches  # the timing's launches are not the main path's
    return out


def mirror_row_matches(np, mirror, cache, node: str) -> bool:
    """Whether the mirror's used row of ``node`` holds the cache's booking."""
    with mirror._lock:
        row = mirror._node_index[node]
        want = np.zeros_like(mirror._used[row])
        for card, rm in cache.get_node_resource_status(node).items():
            for name, value in rm.items():
                want[mirror._card_index[row][card], mirror._res_index[name]] = value
        return bool(np.array_equal(mirror._used[row], want))


GAS_FULL_HOST_EVERY = 50  # a Filter held against the host loop walking every node


class RememberedHostLogic:
    """A control extender's host-loop logic per node (``GASExtender.
    _run_scheduling_logic``), remembered per (pod request, node) and
    forgotten for a node whose booking changes.  The control's Filter still
    runs its own host loop over every candidate, reasons and encoding
    included; only a node whose verdict cannot have changed is not walked
    again, which keeps 300 Filters of 10,000 nodes within the smoke's time."""

    def __init__(self, extender):
        self.inner = extender._run_scheduling_logic
        extender._run_scheduling_logic = self
        self.memo = {}
        self._pod = (None, None)

    def __call__(self, pod, node_name):
        if self._pod[0] is not pod:
            self._pod = (pod, json.dumps(pod.containers, sort_keys=True))
        key = (self._pod[1], node_name)
        hit = self.memo.get(key)
        if hit is None:
            try:
                hit = (None, self.inner(pod, node_name))
            except Exception as exc:  # noqa: BLE001 — the verdict is the exception
                hit = (type(exc), exc.args)  # not the exception: its traceback holds the walk's frames
            self.memo[key] = hit
        if hit[0] is None:
            return hit[1]
        raise hit[0](*hit[1])

    def forget(self, node_name) -> None:
        for key in [k for k in self.memo if k[1] == node_name]:
            del self.memo[key]


def run_gas(torch, np, device: str) -> dict:
    """The GAS extender as ``cmd/gas.main`` wires it: ``assemble`` on
    ``device`` behind the fault-tolerant client of the default flags,
    ``build_server`` on 127.0.0.1, over the port's fake API server holding
    :func:`build_gas_world`.  A burst of pods, the JAX load's two-container
    template alternating with a 1-GPU pod: each is filtered over all node
    names on a keep-alive socket, its answer held byte for byte against a
    CPU-mirror twin and the host loop over the same cache, and, where a
    node fits, bound to a seeded choice among them, the annotation held
    against the twin's choice and the booking checked in the mirror.
    Every Filter must miss the fits cache once and launch the kernel once,
    and none may take the host path."""
    import http.client
    import threading

    from platform_aware_scheduling_tpu_torch.cmd import common, gas
    from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest
    from platform_aware_scheduling_tpu_torch.gas.scheduler import GASExtender
    from platform_aware_scheduling_tpu_torch.ops.cuda_binpack import binpack_cuda
    from platform_aware_scheduling_tpu_torch.testing.fake_kube import FakeKubeClient
    from platform_aware_scheduling_tpu_torch.utils import trace
    from platform_aware_scheduling_tpu_torch.utils.gctuning import tune_for_serving

    out = {}
    rng = np.random.default_rng(SEED + 9)
    # the reference logs each node without GPUs and each vanished card on
    # every host-loop walk (the control walks 10,000 nodes a Filter): such
    # lines are counted, not printed
    expected_lines = ("gpulist label not found from node", "GPUs have vanished", "has vanished")
    quiet = {"lines": 0}

    def drop_expected(record) -> bool:
        if any(text in record.getMessage() for text in expected_lines):
            quiet["lines"] += 1
            return False
        return True

    logger = logging.getLogger("pas_tpu_torch")
    logger.addFilter(drop_expected)
    start = time.perf_counter()
    kube = FakeKubeClient()
    world = build_gas_world(np, kube)
    out["world"] = {k: v for k, v in world.items() if k not in ("names", "burst", "warm")}
    out["seed_s"] = time.perf_counter() - start
    names = world["names"]

    args = gas.build_arg_parser().parse_args(["--unsafe", "--port=0"])
    policy, breakers = common.build_fault_tolerance(args)
    api = common.wrap_kube_client(kube, policy, breakers)
    start = time.perf_counter()
    cache, ext = gas.assemble(api, retry_policy=policy, device=device)
    server = None
    try:
        # the worker books every bound pod; the cache's own hook says when
        booked = threading.Event()

        def on_booking(_node):
            if len(cache.annotated_pods) >= world["booked_pods"]:
                booked.set()

        cache.on_booking_change(on_booking)
        on_booking(None)
        check(booked.wait(120), "gas: the cache did not book every bound pod")
        out["assemble_s"] = time.perf_counter() - start
        tune_for_serving()  # as cmd/gas.main does once the lists are in
        mirror, packer = ext._device.mirror, ext._device
        check(mirror.device.type == device, f"gas: the mirror is not on {device}")
        # a vanished card keeps its lane: still 8 a node
        check(mirror._used.shape[1] == GAS_CARDS, f"gas: mirror shape {mirror._used.shape}")
        # the controls: a CPU-mirror twin and the host loop over the same
        # cache, the latter walking every node on the first Filter of each
        # request and every GAS_FULL_HOST_EVERY-th, and between them only
        # the nodes whose booking changed
        twin = GASExtender(api, cache=cache, retry_policy=policy, device="cpu")
        host = GASExtender(api, cache=cache, retry_policy=policy, use_device=False)
        host_walked = GASExtender(api, cache=cache, retry_policy=policy, use_device=False)
        remembered = RememberedHostLogic(host_walked)
        cache.work_queue.recorder = ext.recorder
        # the controls are the smoke's, not the service's: their start-up
        # heap is frozen out of collections too, and the garbage each
        # control step leaves is collected before the next timed request
        gc.collect()
        gc.freeze()
        server = gas.build_server(ext)
        server.start_server(port="0", unsafe=True, host="127.0.0.1", block=False)
        check(server.wait_ready(), "gas: the extender server did not start")
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)

        def send(path, body, request_id=None):
            headers = {"Content-Type": "application/json"}
            if request_id is not None:
                headers["X-Request-ID"] = request_id
            t0 = time.perf_counter()
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data, time.perf_counter() - t0

        def control(extender, body):
            return extender.filter(HTTPRequest("POST", "/scheduler/filter", {"Content-Type": "application/json"}, body))

        def settled(name, node):
            """The Bind's updates have reached the cache's pod informer and
            its worker, as they would before the scheduler's next pod."""
            wait_for(
                lambda: cache.fetch_pod("default", name).spec_node_name == node and len(cache.work_queue) == 0,
                30, f"gas: {name}'s bind to reach the cache",
            )

        # warm-up, not counted: each kind of Filter and a Bind after which
        # the next Filter rebuilds the mirror's device state from a dirty row
        template = json.dumps({"Pod": world["burst"][0], "NodeNames": names}).encode()
        for pod in world["warm"]:
            check(send("/scheduler/filter", template)[0] == 200, "gas: warm-up Filter failed")
            body = json.dumps({"Pod": pod, "NodeNames": names}).encode()
            status, data, _s = send("/scheduler/filter", body)
            check(status == 200 and json.loads(data)["NodeNames"], "gas: warm-up Filter failed")
            name, node = pod["metadata"]["name"], json.loads(data)["NodeNames"][0]
            binding = {"PodName": name, "PodNamespace": "default", "PodUID": pod["metadata"]["uid"], "Node": node}
            check(send("/scheduler/bind", json.dumps(binding).encode())[0] == 200, "gas: warm-up Bind failed")
            settled(name, node)
        gc.collect()
        status, data = http_get(server.port, "/readyz")
        check(status == 200, f"gas: /readyz answered {status}: {data[:200]!r}")

        # the server's spans as they complete, matched by X-Request-ID, and
        # the device path's own parts: the bin-pack call and in it the
        # mirror's snapshot
        spans, parts = [], {"batch_fit": [], "snapshot": []}

        def timed(label, fn):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    parts[label].append((time.perf_counter() - t0) * 1e3)

            return wrapper

        packer.batch_fit = timed("batch_fit", packer.batch_fit)
        mirror.snapshot = timed("snapshot", mirror.snapshot)
        trace.SPAN_OBSERVERS.append(spans.append)
        binpack_cuda.LAUNCHES = 0
        hits0, misses0 = packer.fits_hits, packer.fits_misses
        device_host = 0
        filter_ms, bind_ms, failed_counts, bound = [], [], [], 0
        t_burst = time.perf_counter()
        full_host = 0
        for i, pod in enumerate(world["burst"]):
            body = json.dumps({"Pod": pod, "NodeNames": names}).encode()
            before = trace.COUNTERS.get("pas_gas_filter_host_total")
            status, data, seconds = send("/scheduler/filter", body, request_id=f"gas-filter-{i}")
            device_host += trace.COUNTERS.get("pas_gas_filter_host_total") - before
            check(status == 200, f"gas: Filter answered {status}")
            filter_ms.append(seconds * 1e3)
            check(control(twin, body).body == data, f"gas: {pod['metadata']['name']}: Filter differs from the CPU twin")
            check(control(host_walked, body).body == data,
                  f"gas: {pod['metadata']['name']}: Filter differs from the host loop")
            if i % GAS_FULL_HOST_EVERY == 0 or i == GAS_BURST - 1:
                check(control(host, body).body == data,
                      f"gas: {pod['metadata']['name']}: Filter differs from the host loop over every node")
                full_host += 1
            result = json.loads(data)
            fitting = result["NodeNames"] or []
            failed_counts.append(len(result["FailedNodes"]))
            node = name = want = None
            if fitting:
                node = fitting[int(rng.integers(len(fitting)))]
                name = pod["metadata"]["name"]
                want = twin._run_scheduling_logic(cache.fetch_pod("default", name), node)
            del result, data
            gc.collect()
            if node is None:
                continue
            version = mirror.version
            binding = {"PodName": name, "PodNamespace": "default", "PodUID": pod["metadata"]["uid"], "Node": node}
            status, data, seconds = send("/scheduler/bind", json.dumps(binding).encode())
            check((status, data) == (200, b'{"Error": ""}\n'), f"gas: Bind answered {status} {data[:200]!r}")
            bind_ms.append(seconds * 1e3)
            got = kube.get_pod("default", name).get_annotations().get("gas-container-cards")
            check(got == want, f"gas: {name} annotated {got!r}, the twin chose {want!r}")
            check(mirror.version > version and mirror_row_matches(np, mirror, cache, node),
                  f"gas: {name}'s booking did not reach the mirror")
            check(mirror_row_matches(np, twin._device.mirror, cache, node), f"gas: {name}'s booking missed the twin")
            remembered.forget(node)
            settled(name, node)
            bound += 1
        out["burst_s"] = time.perf_counter() - t_burst
        out["full_host_filters"] = full_host
        del packer.batch_fit, mirror.snapshot
        deadline = time.perf_counter() + 5.0
        while len({sp.trace_id for sp in spans if sp.trace_id.startswith("gas-filter-")}) < GAS_BURST:
            check(time.perf_counter() < deadline, "gas: Filter spans missing")
            time.sleep(0.01)  # the last span is added after its response is sent
        trace.SPAN_OBSERVERS.remove(spans.append)
        by_id = {sp.trace_id: sp for sp in spans}
        check(all(by_id[f"gas-filter-{i}"].attrs.get("path") == "device" for i in range(GAS_BURST)),
              "gas: a timed Filter span is not on the device path")
        # stage medians by kind (even: the template, odd: the 1-GPU pod)
        out["stages"] = {}
        for kind, first in (("template", 0), ("1-GPU", 1)):
            ids = range(first, GAS_BURST, 2)
            per = {}
            for i in ids:
                for stage, sec in by_id[f"gas-filter-{i}"].stage_seconds().items():
                    per.setdefault(stage, []).append(sec * 1e3)
            per["client"] = [filter_ms[i] for i in ids]
            per["outside the server span"] = [filter_ms[i] - by_id[f"gas-filter-{i}"].duration_s * 1e3 for i in ids]
            per["batch_fit"] = parts["batch_fit"][first::2]
            per["snapshot"] = parts["snapshot"][first::2]
            out["stages"][kind] = {stage: statistics.median(ms) for stage, ms in per.items()}
        slowest = sorted(range(GAS_BURST), key=filter_ms.__getitem__)[-3:][::-1]
        out["tail"] = [
            (i, filter_ms[i], {k: v * 1e3 for k, v in by_id[f"gas-filter-{i}"].stage_seconds().items()},
             parts["batch_fit"][i])
            for i in slowest
        ]
        out["launches"] = binpack_cuda.LAUNCHES
        out["hits"] = packer.fits_hits - hits0
        out["misses"] = packer.fits_misses - misses0
        out["device_host_filters"] = device_host
        check(device_host == 0, f"gas: {device_host} Filters took the host path")
        if device == "cuda":
            check(out["launches"] > 0 and out["launches"] == out["misses"],
                  f"gas: {out['launches']} binpack launches for {out['misses']} fits-cache misses")
        check(out["hits"] + out["misses"] == GAS_BURST, "gas: a Filter skipped the fits cache")
        check(bound > 0, "gas: no pod was bound")
        out["bound"] = bound
        out["failed_nodes"] = (min(failed_counts), max(failed_counts))
        out["filter"] = {"p50_ms": statistics.median(filter_ms), "p99_ms": percentile(filter_ms, 0.99),
                         "max_ms": max(filter_ms), "n": len(filter_ms)}
        out["bind"] = {"p50_ms": statistics.median(bind_ms), "p99_ms": percentile(bind_ms, 0.99),
                       "max_ms": max(bind_ms), "n": len(bind_ms)}
        conn.close()

        # the kernel on the main path's state: held against its plain
        # version, then timed
        state = mirror.snapshot()[0]
        main_cases = []
        for pod in world["burst"][:2]:
            request, k = gas_request(mirror, pod, mirror.device)
            main_cases.append((f"main path, {pod['metadata']['name']}", state, request, k))
        if device == "cuda":
            launches = binpack_cuda.LAUNCHES
            out["max_abs_err"] = run_gas_parity(torch, main_cases)
            binpack_cuda.LAUNCHES = launches
            out["times"] = time_binpack(torch, *main_cases[0][1:])
    finally:
        if server is not None:
            server.shutdown()
        cache.stop()
        for hub in kube._hubs.values():
            hub.publish("BOOKMARK", {})  # an idle watch returns to see its stop
        logger.removeFilter(drop_expected)
    out["expected_log_lines"] = quiet["lines"]
    return out


def gas_lines(g: dict, card: str) -> list:
    w, f, b = g["world"], g["filter"], g["bind"]
    lines = [
        f"gas world: {NUM_NODES} nodes x {GAS_CARDS} cards, {w['no_gpu']} without GPUs, {w['vanished']} with a "
        f"vanished card, {w['booked_pods']} bound pods booking {w['booked_millicores_share']:.3f} of the "
        f"millicores; seeded in {g['seed_s']:.3f} s, assembled and booked in {g['assemble_s']:.3f} s",
        f"gas burst: {GAS_BURST} pods, {g['bound']} bound; FailedNodes {g['failed_nodes'][0]}-{g['failed_nodes'][1]} "
        f"a Filter; every Filter equal to the CPU twin and the host loop ({g['full_host_filters']} walking every "
        f"node, the rest the nodes a Bind changed); binpack launches {g['launches']} = "
        f"fits-cache misses {g['misses']} (hits {g['hits']}); device Filters on the host path "
        f"{g['device_host_filters']}; {g['burst_s']:.3f} s ({g['expected_log_lines']} expected log lines of "
        f"GPU-less nodes and vanished cards not printed)",
        f"gas verbs {NUM_NODES} nodes over a socket: filter p50 {f['p50_ms']:.3f} ms p99 {f['p99_ms']:.3f} ms "
        f"max {f['max_ms']:.3f} ms (n={f['n']}), bind p50 {b['p50_ms']:.3f} ms p99 {b['p99_ms']:.3f} ms "
        f"max {b['max_ms']:.3f} ms (n={b['n']}) [{card}]",
    ]
    for kind, st in g["stages"].items():
        lines.append(
            f"gas filter stages, {kind} pods (medians, ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
            + f" [{card}]"
        )
    lines.append(
        "gas filter tail (the 3 slowest): "
        + "; ".join(
            f"#{i} client {ms:.3f} ms (" + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
            + f", batch_fit {bf:.3f})"
            for i, ms, st, bf in g["tail"]
        )
        + f" [{card}]"
    )
    if "times" in g:
        t = g["times"]
        n, c, r, tt, k = t["shape"]
        lines.append(
            f"binpack main path {n}x{c}x{r}, T={tt} K={k}: kernel device {t['device_ms']:.4f} ms "
            f"(torch.profiler {ms_or_not_measured(t['profiler_ms'])}; a one-element add so timed "
            f"{t['floor_ms']:.4f} ms), a wrapper call {t['call_ms']:.4f} ms, "
            f"plain PyTorch {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bytes']} bytes, "
            f"{t['bound_ms'] / t['device_ms']:.3f} of it); no single PyTorch call computes this function [{card}]"
        )
    return lines


def check_gas_limits(g: dict) -> None:
    check(g["filter"]["p99_ms"] <= VERB_P99_LIMIT_MS,
          f"gas: Filter p99 {g['filter']['p99_ms']:.3f} ms over {VERB_P99_LIMIT_MS} ms")


# -- the forecast phase --------------------------------------------------------------

FORECAST_WINDOW = 32  # --forecastWindow's default
FORECAST_PASSES = 40  # churned refresh passes: more than the window, so every ring wraps
FORECAST_CALM_PASSES = FORECAST_WINDOW  # calm passes that flush the churn before the outage
FORECAST_RAMP_SHARE = 0.10  # nodes that ramp up, and as many that ramp down
FORECAST_RAMP_MILLI = 300  # benchmarks/forecast_load.py's riser slope
FORECAST_TIMED_REQUESTS = 500
FORECAST_DEGRADED_REQUESTS = 20
FORECAST_REFIT_P50_LIMIT_MS = 100.0  # 2% of the 5 s period, the share the replan is held to
FORECAST_FLAGS = ["--forecast=on", "--degradedMode=last-known-good", "--batchPlanner", "--nodeCacheCapable"]


def forecast_parity_cases(np):
    """(label, values int32 [M, N, W], valid bool [M, N, W]) cases the
    kernel must match the plain version on, bit for bit: nothing valid,
    W = 1 and 64, ragged series with gaps, constant series, values at
    +-2^30 and at INT32_MIN, and random histories like the JAX package's
    parity test (values in +-2^30, 70% valid)."""
    rng = np.random.default_rng(SEED + 4)
    i32min = np.iinfo(np.int32).min
    cases = [(f"all invalid W={w}", np.full((2, 5, w), 7, np.int32), np.zeros((2, 5, w), bool)) for w in (1, 32)]
    cases.append(("W=1", rng.integers(-(2**30), 2**30, size=(3, 300, 1)).astype(np.int32), np.ones((3, 300, 1), bool)))
    cases.append(
        ("W=64", rng.integers(-(2**30), 2**30, size=(3, 300, 64)).astype(np.int32), rng.random((3, 300, 64)) < 0.8)
    )
    ragged = np.zeros((4, 257, 32), bool)
    for n in range(257):
        ragged[:, n, 32 - (n % 33):] = True
    ragged[1, ::3, 20] = False
    cases.append(("ragged", rng.integers(-5000, 5000, size=(4, 257, 32)).astype(np.int32), ragged))
    cases.append(("constant", np.full((2, 300, 32), 54321, np.int32), np.ones((2, 300, 32), bool)))
    ceiling = (rng.integers(0, 2, size=(2, 300, 32)) * (2**31 - 2) - (2**30 - 1)).astype(np.int32)
    cases.append(("+-2^30", ceiling, np.ones((2, 300, 32), bool)))
    extremes = np.array([i32min, 2**31 - 1, i32min, -(2**30), 2**30, i32min, 0, 2**31 - 1], np.int32)
    cases.append(("INT32_MIN", np.tile(extremes, (2, 300, 4)), rng.random((2, 300, 32)) < 0.9))
    for k in range(8):
        m, n, w = int(rng.integers(1, 9)), int(rng.integers(1, 2000)), int(rng.integers(1, 41))
        values = rng.integers(-(2**30), 2**30, size=(m, n, w)).astype(np.int32)
        cases.append((f"random {k}", values, rng.random((m, n, w)) < 0.7))
    return cases


def ring_form(np, values, valid, variant: int):
    """A parity case's ``[M, N, W]`` staging as a history ring: slot
    ``(head[m] + i) % W`` holds sample ``i``, the heads 0, a middle slot and
    ``W - 1`` by row.  Variant 0 widens the values with shift 0; variant 1
    shifts each row's values up by 1-32 bits with random low bits below
    them (``raw >> shift`` gives the values back) and cuts ``n_live`` by a
    quarter, with stray valid bytes past it.  Returns ``(values int64,
    valid uint8 [M, W, N], head int32, shift int32, n_live)``."""
    m, n, w = values.shape
    rng = np.random.default_rng(SEED + 5 + variant)
    head = np.array([(0, w // 2, w - 1)[(row + variant) % 3] for row in range(m)], np.int32)
    shift = np.zeros(m, np.int32)
    raw = values.astype(np.int64)
    n_live = n
    if variant == 1:
        shift = (np.arange(m, dtype=np.int32) * 13 + 7) % 32 + 1
        up = shift.astype(np.int64)[:, None, None]
        raw = (raw << up) + rng.integers(0, 1 << 62, size=raw.shape) % (np.int64(1) << up)
        n_live = n - n // 4
    order = (head.astype(np.int64)[:, None] + np.arange(w)) % w  # step i's slot
    ring_values = np.zeros((m, w, n), np.int64)
    ring_valid = np.zeros((m, w, n), np.uint8)
    rows = np.arange(m)[:, None]
    ring_values[rows, order] = raw.transpose(0, 2, 1)
    ring_valid[rows, order] = valid.transpose(0, 2, 1)
    if variant == 1:
        ring_valid[:, :, n_live:] = 1
    return ring_values, ring_valid, head, shift, n_live


def run_forecast_parity(torch, np) -> int:
    """Each case at horizons 0, 1, W and 2W + 1: its ``[M, N, W]`` staging
    through ``forecast_cuda`` against the plain version on the CPU, then
    in two ring forms (:func:`ring_form`) through the ring kernel against
    the plain ring version on the CPU; returns the max |difference|."""
    from platform_aware_scheduling_tpu_torch.ops.cuda_forecast import forecast_cuda, forecast_ring_cuda
    from platform_aware_scheduling_tpu_torch.ops.forecast import forecast_reference, forecast_ring_reference

    launches = forecast_ring_cuda.LAUNCHES
    worst = 0

    def held(label, got, want):
        nonlocal worst
        for name, g, x in zip(want._fields, got.cpu(), want):
            worst = max(worst, int((g.to(torch.int64) - x.to(torch.int64)).abs().max()) if g.numel() else 0)
            check(g.dtype == torch.int32 and torch.equal(g, x), f"forecast parity {label}: {name} differs")

    cases = forecast_parity_cases(np)
    for label, values, valid in cases:
        w = values.shape[2]
        host_values, host_valid = torch.from_numpy(values), torch.from_numpy(valid)
        dev_values, dev_valid = host_values.cuda(), host_valid.cuda()
        rings = []
        for variant in (0, 1):
            *arrays, n_live = ring_form(np, values, valid, variant)
            rings.append(([torch.from_numpy(a) for a in arrays], n_live))
        for horizon in (0, 1, w, 2 * w + 1):
            want = forecast_reference(host_values, host_valid, horizon)
            held(f"{label} [M, N, W] h={horizon}", forecast_cuda(dev_values, dev_valid, horizon), want)
            for variant, (ring, n_live) in enumerate(rings):
                plain = forecast_ring_reference(*ring, n_live, horizon)
                if variant == 0:
                    for name, p, x in zip(want._fields, plain, want):
                        check(torch.equal(p, x), f"forecast parity {label}: the plain ring version's {name} differs")
                got = forecast_ring_cuda(*(t.cuda() for t in ring), n_live, horizon)
                held(f"{label} ring {variant} h={horizon}", got, plain)
    forecast_ring_cuda.LAUNCHES = launches  # parity launches are not the main path's
    print(
        f"forecast parity: {len(cases)} cases x 4 horizons exact on the card, as [M, N, W] stagings and as rings "
        f"(heads 0, W/2 and W-1; shifts 0, and 1-32 with n_live cut by a quarter) (max |diff| {worst})"
    )
    return worst


class DrivenMetrics:
    """The phase's metrics API: serves ``store`` to the smoke run's own
    thread, which drives every refresh pass with the cache's
    ``update_all_metrics`` (what the service's refresh loop calls each sync
    period).  The loop's own thread is held at its first fetch until the
    phase ends, so each pass is one call of the smoke run's; ``outage``
    fails every fetch, as an unreachable metrics API does."""

    def __init__(self, pass_thread: int, store: dict, released):
        self.pass_thread = pass_thread
        self.store = store
        self.released = released
        self.outage = False
        self.held = False  # the loop's thread waits at its fetch

    def get_node_metric(self, metric_name: str):
        import threading

        from platform_aware_scheduling_tpu_torch.tas.metrics import MetricsError

        if threading.get_ident() != self.pass_thread:
            self.held = True
            self.released.wait()
            raise MetricsError("the smoke run drives the refresh passes")
        if self.outage:
            raise MetricsError(f"metrics API unavailable: no metric {metric_name} fetched")
        return dict(self.store[metric_name])


def forecast_world(kube) -> list:
    """The verbs phase's world in the fake API server: 10,000 nodes with
    ``pods: 110``, the 4 policies as TASPolicy objects, 1,000 pending
    labelled pods for the planner."""
    from platform_aware_scheduling_tpu_torch.testing.builders import make_policy

    nodes = [f"node-{i:05d}" for i in range(NUM_NODES)]
    for name in nodes:
        kube.add_node(
            {"metadata": {"name": name, "labels": {}}, "status": {"allocatable": {"pods": str(ALLOCATABLE_PODS)}}}
        )
    for i in range(NUM_PODS):
        kube.add_pod(
            {
                "metadata": {"name": f"pending-{i}", "namespace": "default", "uid": f"uid-pending-{i}",
                             "labels": {"telemetry-policy": f"pol-{i % 4}"}},
                "spec": {"containers": [{"name": "c"}]},
                "status": {"phase": "Pending"},
            }
        )
    for name, strategies in policies(rule).items():
        kube.create_taspolicy(make_policy(name, strategies=strategies))
    return nodes


class TimedLock:
    """A lock's stand-in that records each acquisition: the thread, when it
    asked, when it got the lock and when it let go (``perf_counter``
    seconds).  It takes and gives back the lock it wraps, so code that
    holds the lock itself still excludes it."""

    def __init__(self, inner):
        self.inner = inner
        self.records = []
        self._held = None

    def acquire(self, blocking=True, timeout=-1):
        asked = time.perf_counter()
        got = self.inner.acquire(blocking, timeout)
        if got:
            self._held = (threading.get_ident(), asked, time.perf_counter())
        return got

    def release(self):
        thread, asked, got = self._held
        released = time.perf_counter()
        self.inner.release()
        self.records.append({"thread": thread, "asked": asked, "got": got, "released": released})

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


@contextlib.contextmanager
def collection_spans():
    """The interpreter's collections inside the block, as ``{"generation",
    "start", "end"}`` (``perf_counter`` seconds)."""
    spans, started = [], []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            spans.append({"generation": info["generation"], "start": started.pop(), "end": time.perf_counter()})

    gc.callbacks.append(on_gc)
    try:
        yield spans
    finally:
        gc.callbacks.remove(on_gc)


def lock_summary(locks: dict, passes_thread: int) -> dict:
    """Each lock's holds by the thread that drives the passes (p50, max ms)
    and the longest wait of any other thread."""
    out = {}
    for name, lock in locks.items():
        holds = [(r["released"] - r["got"]) * 1e3 for r in lock.records if r["thread"] == passes_thread]
        waits = [(r["got"] - r["asked"]) * 1e3 for r in lock.records if r["thread"] != passes_thread]
        out[name] = {
            "holds": len(holds), "hold_p50_ms": percentile(holds, 0.5) if holds else 0.0,
            "hold_max_ms": max(holds, default=0.0), "waits": len(waits), "wait_max_ms": max(waits, default=0.0),
        }
    return out


def attribution(a: float, b: float, t: dict) -> dict:
    """What the request from ``a`` to ``b`` (``perf_counter`` seconds)
    overlapped, in ms: the smoke's metrics source publishing a pass's
    samples (80,000 ``NodeMetric`` objects, the metrics API's work, which
    a deployment runs in another process), the pass's writes into the
    cache and the mirror (up to its refit), each refit stage (laid end to
    end from the refit's start), the ranking warm after it, collections by
    generation, and on each lock the waits of other threads than the one
    driving the passes and that thread's holds."""

    def over(x0, x1):
        return max(0.0, min(b, x1) - max(a, x0)) * 1e3

    out = {
        "ms": (b - a) * 1e3,
        "source_ms": sum(over(p0, p1) for p0, p1, _p2 in t["passes"]),
        "writes_ms": sum(over(p1, r0) for (_p0, p1, _p2), (r0, _r1) in zip(t["passes"], t["refits"])),
    }
    stage_ms = {}
    for (r0, _r1), stages in zip(t["refits"], t["stages"]):
        start = r0
        for name, ms in stages.items():
            stage_ms[name] = stage_ms.get(name, 0.0) + over(start, start + ms / 1e3)
            start += ms / 1e3
    out["refit_ms"] = sum(over(r0, r1) for r0, r1 in t["refits"])
    out["stages_ms"] = stage_ms
    out["warm_ms"] = sum(over(w0, w1) for w0, w1 in t["warms"])
    out["gc_ms"] = [
        sum(over(c["start"], c["end"]) for c in t["collections"] if c["generation"] == generation)
        for generation in range(3)
    ]
    out["locks"] = {
        name: {
            "waited_ms": sum(over(r["asked"], r["got"]) for r in lock.records if r["thread"] != t["passes_thread"]),
            "held_by_passes_ms": sum(over(r["got"], r["released"]) for r in lock.records if r["thread"] == t["passes_thread"]),
        }
        for name, lock in t["locks"].items()
    }
    return out


def attribution_text(x: dict) -> str:
    stages = ", ".join(f"{k} {v:.3f}" for k, v in x["stages_ms"].items())
    locks = "; ".join(
        f"{name} lock waited {v['waited_ms']:.3f}, held by the passes {v['held_by_passes_ms']:.3f}"
        for name, v in x["locks"].items()
    )
    gc_ms = ", ".join(f"gen {g} {ms:.3f}" for g, ms in enumerate(x["gc_ms"]))
    return (
        f"{x['ms']:.3f} ms, overlapping the smoke's metrics source {x['source_ms']:.3f}, the pass's writes "
        f"{x['writes_ms']:.3f}, a refit {x['refit_ms']:.3f} ({stages}), the ranking warm {x['warm_ms']:.3f}, "
        f"collections {gc_ms}; {locks}"
    )


def run_forecast(torch, np, device: str) -> dict:
    """The TAS service with ``--forecast=on`` as ``cmd/tas.main`` wires it:
    ``assemble`` with the forecast options of the flags (window 32, the
    horizon one sync period, band bound 0.25), the planner and
    last-known-good degraded mode on ``device``, over the verbs phase's
    world in the fake API server, served by ``build_server`` on 127.0.0.1;
    beside it a twin assembly on the CPU.  Both forecasters run on one
    fake clock that moves one sync period a pass.  40 refresh passes (10%
    of the nodes ramp up 300 milli-units a pass, 10% down, the rest churn
    30%), each holding one forecast launch, one fit pass and the fit equal
    to the plain ring version over a host copy of the forecaster's ring
    and to the twin's (on three passes the ring, materialised, byte for
    byte equal to ``build_history_tensor``'s staging); then 500 native
    Prioritize requests ranked on the forecasts, each equal to the twin's
    and to the host path's with the extension off, beside 500 ranked on
    the snapshot; then 32 calm passes, their refits overlapped by
    forecast-ranked Prioritize sent back to back from a second thread and
    connection, with every acquisition of the forecaster's and the
    mirror's locks, each collection and each refit's stages recorded, so
    the slowest requests are printed with what they overlapped; and a
    metrics-API outage past the cut last-known-good window, served by
    extrapolation until the horizon passes the window.  The refit's stages
    are the card's forecaster's own timers
    (``Forecaster.refit_stages_ms``), read after each pass.  The plain
    versions record the device of each call: the card's path must make
    none."""
    import http.client
    import threading

    from platform_aware_scheduling_tpu_torch.cmd import common, tas
    from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest, Server
    from platform_aware_scheduling_tpu_torch.ops import forecast as ops_forecast
    from platform_aware_scheduling_tpu_torch.ops.cuda_forecast import forecast_ring_cuda
    from platform_aware_scheduling_tpu_torch.ops.forecast import forecast_ring_reference
    from platform_aware_scheduling_tpu_torch.ops.state import build_history_tensor
    from platform_aware_scheduling_tpu_torch.tas.metrics import NodeMetric
    from platform_aware_scheduling_tpu_torch.tas.telemetryscheduler import MetricsExtender
    from platform_aware_scheduling_tpu_torch.testing.fake_kube import FakeKubeClient
    from platform_aware_scheduling_tpu_torch.testing.faults import FakeClock
    from platform_aware_scheduling_tpu_torch.utils import trace
    from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity
    from platform_aware_scheduling_tpu_torch.utils.tracing import CounterSet

    out = {}
    real_plain = {name: getattr(ops_forecast, name) for name in ("forecast_reference", "forecast_ring_reference")}
    period = SERVICE_SYNC_PERIOD_S
    rng = np.random.default_rng(SEED + 3)
    kube = FakeKubeClient()
    start = time.perf_counter()
    nodes = forecast_world(kube)
    values = rng.integers(0, 100_000, size=(NUM_METRICS, NUM_NODES))
    order = rng.permutation(NUM_NODES)
    ramp = int(NUM_NODES * FORECAST_RAMP_SHARE)
    step = np.zeros(NUM_NODES, dtype=np.int64)
    step[order[:ramp]] = FORECAST_RAMP_MILLI
    step[order[ramp : 2 * ramp]] = -FORECAST_RAMP_MILLI
    churners = np.ones(NUM_NODES, dtype=bool)
    churners[order[: 2 * ramp]] = False
    store = {}

    def publish():
        for j, metric in enumerate(METRIC_NAMES):
            store[metric] = {n: NodeMetric(value=Quantity(f"{int(v)}m")) for n, v in zip(nodes, values[j].tolist())}

    def advance(churn: bool):
        values[...] += step[None, :]
        if churn:
            moved = (rng.random(values.shape) < CHURN) & churners[None, :]
            values[...] = np.where(moved, rng.integers(0, 100_000, size=values.shape), values)
        publish()

    publish()
    released = threading.Event()
    clock = FakeClock()
    args = tas.build_arg_parser().parse_args([*FORECAST_FLAGS, f"--syncPeriod={period:g}s"])
    assemblies = {}
    for side, dev in (("dut", device), ("twin", "cpu")):
        options = common.forecast_options(args, period)
        options["clock"] = clock
        if side == "twin":
            options["counters"] = CounterSet()  # the process counters count the card's service alone
        client = DrivenMetrics(threading.get_ident(), store, released)
        cache, mirror, ext, _controller, _enforcer, stop = tas.assemble(
            kube,
            client,
            period,
            enable_batch_planner=args.batchPlanner and side == "dut",
            node_cache_capable=args.nodeCacheCapable,
            degraded_mode=args.degradedMode,
            forecast_options=options,
            device=dev,
        )
        ext.degraded.lkg_max_age_s = LKG_MAX_AGE_S
        assemblies[side] = SimpleNamespace(
            cache=cache, mirror=mirror, ext=ext, fc=ext.forecaster, stop=stop, client=client
        )
    dut, twin = assemblies["dut"], assemblies["twin"]
    released_loops = threading.Event()
    ended = []

    def loop_ended():
        """The last hook of a pass: one made by a held loop, after release."""
        if threading.get_ident() != dut.client.pass_thread:
            ended.append(1)
            if len(ended) == len(assemblies):
                released_loops.set()

    server = tas.build_server(dut.ext)
    conns = []
    try:
        check(dut.fc is not None and dut.ext.degraded.forecaster is dut.fc, "forecast: the assembly wired no forecaster")
        check(dut.fc.window == FORECAST_WINDOW, f"forecast: window {dut.fc.window}")
        check(dut.mirror.device.type == device, f"forecast: the mirror is not on {device}")
        hooks = dut.cache.on_refresh_pass
        check(
            hooks.index(dut.fc.refresh) < hooks.index(dut.ext.warm_forecast_rankings),
            "forecast: the ranking warm does not follow the refit on the refresh-pass hook",
        )
        for side in assemblies.values():
            wait_for(
                lambda s=side: len(s.cache.registered_metric_names()) == NUM_METRICS
                and all(s.mirror.policy("default", f"pol-{k}") is not None for k in range(4)),
                60,
                "the policies through the CRD informer",
            )
            # the loop's first pass runs at once: it is held at its first
            # fetch, or it found no metric yet and its refit has ended
            wait_for(
                lambda s=side: s.client.held
                or (s.fc.ensure_current() is not None and s.fc.ensure_current().generation == s.cache.history_generation()),
                60,
                "the refresh loop's first pass",
            )
            side.cache.on_refresh_pass.append(loop_ended)
        out["setup_s"] = time.perf_counter() - start

        # each hook of the card's pass, timed where it runs: (start, end)
        refit_spans, warm_spans = [], []

        def timed(fn, into):
            def wrapper():
                t0 = time.perf_counter()
                fn()
                into.append((t0, time.perf_counter()))

            return wrapper

        def span_ms(spans):
            return [(b - a) * 1e3 for a, b in spans]

        hooks[hooks.index(dut.fc.refresh)] = timed(dut.fc.refresh, refit_spans)
        hooks[hooks.index(dut.ext.warm_forecast_rankings)] = timed(dut.ext.warm_forecast_rankings, warm_spans)

        def drive(sides, churn=True, outage=False, spans=None):
            """One refresh pass of each side; ``spans`` gets (start, the
            source's samples published, end)."""
            t0 = time.perf_counter()
            clock.advance(period)
            if not outage:
                advance(churn)
            t1 = time.perf_counter()
            for side in sides:
                side.client.outage = outage
                side.cache.update_all_metrics(side.client)
            if spans is not None:
                spans.append((t0, t1, time.perf_counter()))

        server.start_server(port="0", unsafe=True, host="127.0.0.1", block=False)
        check(server.wait_ready(), "forecast: the extender server did not start")
        # one connection a stretch of requests: the server closes an idle
        # one, as across the outage's wait

        def connect():
            for old in conns:
                old.close()
            conns[:] = [http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)]

        def send(method, path, body=b"", request_id=None):
            headers = {"Content-Type": "application/json"} if method == "POST" else {}
            if request_id is not None:
                headers["X-Request-ID"] = request_id
            t0 = time.perf_counter()
            conns[0].request(method, path, body=body, headers=headers)
            resp = conns[0].getresponse()
            data = resp.read()
            return resp.status, data, time.perf_counter() - t0

        # the plain versions, each call's device recorded: the card's
        # forecaster must never reach them (the CPU twin does)
        plain_devices = []

        def recorded(fn):
            def plain(values, *args, **kwargs):
                plain_devices.append(values.device.type)
                return fn(values, *args, **kwargs)

            return plain

        for name, fn in real_plain.items():
            setattr(ops_forecast, name, recorded(fn))

        # -- 40 churned passes, each held against the plain version --------------------
        forecast_ring_cuda.LAUNCHES = 0
        fits = trace.COUNTERS.get("pas_forecast_fit_passes_total")
        out["max_abs_err"] = 0
        out["staging_checks"] = 0
        stages, slots_lookups = [], []  # the card's refit stages, and its new slots and node lookups, a pass each
        ring = dut.fc._ring
        for p in range(FORECAST_PASSES):
            launches, slots, lookups = forecast_ring_cuda.LAUNCHES, ring.slots, ring.lookups
            drive(assemblies.values())
            stages.append(dict(dut.fc.refit_stages_ms))
            slots_lookups.append((ring.slots - slots, ring.lookups - lookups))
            if device == "cuda":
                check(forecast_ring_cuda.LAUNCHES - launches == 1,
                      f"forecast pass {p}: {forecast_ring_cuda.LAUNCHES - launches} kernel launches")
            check(trace.COUNTERS.get("pas_forecast_fit_passes_total") - fits == p + 1,
                  f"forecast pass {p}: pas_forecast_fit_passes_total did not move by one")
            fit, twin_fit = dut.fc.ensure_current(), twin.fc.ensure_current()
            check(fit.generation == dut.cache.history_generation(), f"forecast pass {p}: the fit is not current")
            # the plain version on a host copy of the card's ring, as the
            # refit left it
            want = forecast_ring_reference(
                ring.values.cpu(), ring.valid.cpu(), ring.head.cpu(), ring.shift_dev.cpu(), ring.n_live,
                fit.horizon_steps,
            )
            check(np.array_equal(fit.shift, ring.shift), f"forecast pass {p}: the fit's shift is not the ring's")
            if p in (0, FORECAST_WINDOW - 1, FORECAST_PASSES - 1):
                # the ring byte for byte against the whole staging of the same rings
                staged = build_history_tensor(fit.view, dut.cache.history_snapshot()[1], dut.fc.window)
                for name, got, x in zip(staged._fields, ring.to_history_tensor(), staged):
                    check(np.array_equal(got, x, equal_nan=name == "last_stamp"),
                          f"forecast pass {p}: the ring's {name} differs from build_history_tensor's")
                out["staging_checks"] += 1
            for name, got, x, t in zip(want._fields, fit.scaled, want, twin_fit.scaled):
                check(torch.equal(got, x), f"forecast pass {p}: the kernel's {name} differs from the plain version")
                check(torch.equal(got, t), f"forecast pass {p}: {name} differs from the CPU twin's")
                out["max_abs_err"] = max(out["max_abs_err"], int((got.long() - x.long()).abs().max()))
            check(np.array_equal(fit.predicted, twin_fit.predicted), f"forecast pass {p}: predictions differ")
        out["churn_refit_ms"] = span_ms(refit_spans)
        out["churn_warm_ms"] = span_ms(warm_spans)
        out["slots_lookups"] = slots_lookups
        # the split of the refits with full rings, each timed inside the refit
        out["split"] = {k: statistics.median(st[k] for st in stages[FORECAST_WINDOW - 1 :]) for k in stages[0]}
        out["churn_extrapolation"] = dut.fc.extrapolation_ok()
        out["ring_shape"] = list(ring.values.shape)

        # -- serving: native Prioritize ranked on the forecasts ---------------------------
        serve_start = time.perf_counter()
        connect()
        host_ext = MetricsExtender(twin.cache, node_cache_capable=True)  # the host path, on the twin's forecasts
        host_ext.forecaster = twin.fc
        twin_server, host_server = Server(twin.ext), Server(host_ext)
        pods = [(f"pol-{k}", f"forecast-probe-{k}-{j}") for k in range(4) for j in range(2)]
        bodies = [args_body(pod, policy, nodes) for policy, pod in pods]
        check(dut.ext.readiness_conditions()[0][1]() == (True, "fastpath warmed"), "forecast: not warmed")

        def answer(srv, body):
            with native_off() if srv is host_server else contextlib.nullcontext():
                r = srv.route(HTTPRequest("POST", "/scheduler/prioritize", {"Content-Type": "application/json"}, body))
            return r.status, r.body

        wants = {}
        for body in bodies:
            status, data, _s = send("POST", "/scheduler/prioritize", body)
            wants[body] = (status, data)
            check(status == 200, f"forecast: Prioritize answered {status}")
            check(answer(twin_server, body) == (status, data), "forecast: Prioritize differs from the CPU twin's")
            check(answer(host_server, body) == (status, data), "forecast: Prioritize differs from the host path's")
        spans = []
        trace.SPAN_OBSERVERS.append(spans.append)
        timed_runs, differs = {}, set()
        try:
            # four blocks, forecast / snapshot / snapshot / forecast, so
            # neither ranking always runs first
            block = FORECAST_TIMED_REQUESTS // 2
            times = {"forecast": [], "snapshot": []}
            pauses = {"forecast": [], "snapshot": []}
            for k, label in enumerate(("forecast", "snapshot", "snapshot", "forecast")):
                forecaster = dut.fc if label == "forecast" else None
                dut.ext.forecaster = forecaster  # the snapshot blocks: --forecast=off's ranking
                for body in bodies + bodies:  # warm-up: intern the lists, seed the caches
                    send("POST", "/scheduler/prioritize", body)
                spans.clear()
                before = trace.COUNTERS.get("pas_prioritize_native_total")
                with collections() as collected:
                    for i in range(block):
                        body = bodies[i % len(bodies)]
                        status, data, s = send("POST", "/scheduler/prioritize", body, request_id=f"{label}-{k}-{i}")
                        times[label].append(s * 1e3)
                        if label == "forecast":
                            check((status, data) == wants[body], f"forecast request {i}: the body changed")
                        elif (status, data) != wants[body]:
                            differs.add(body)
                pauses[label] += full(collected)
                moved = trace.COUNTERS.get("pas_prioritize_native_total") - before
                check(moved == block, f"forecast {label}: pas_prioritize_native_total moved {moved}")
                mine = [sp for sp in spans if sp.attrs.get("verb") == "prioritize"]
                check(len(mine) == block, f"forecast {label}: {len(mine)} spans")
                check(all(sp.attrs.get("path") == "native" for sp in mine), f"forecast {label}: a request left the native path")
                rankings = {sp.attrs.get("ranking") for sp in mine}
                check(rankings == ({"forecast"} if forecaster else {None}), f"forecast {label}: span rankings {rankings}")
            for label, ms in times.items():
                timed_runs[label] = {
                    "p50_ms": percentile(ms, 0.5), "p99_ms": percentile(ms, 0.99), "max_ms": max(ms),
                    "n": len(ms), "gc_ms": pauses[label],
                }
        finally:
            trace.SPAN_OBSERVERS.remove(spans.append)
            dut.ext.forecaster = dut.fc
        check(len(differs) >= 1, "forecast: no body differs from the snapshot ranking of the same request")
        out["timed"], out["differs"] = timed_runs, len(differs)
        out["serve_s"] = time.perf_counter() - serve_start
        check(dut.ext.degraded.prioritize_decision()[0] == "normal", "forecast: telemetry went stale while serving")
        status, data, _s = send("GET", "/debug/forecast")
        check(status == 200, f"forecast: /debug/forecast answered {status}")
        debug = json.loads(data)
        check(sorted(debug["metrics"]) == sorted(METRIC_NAMES), f"forecast: /debug/forecast names {sorted(debug['metrics'])}")

        # -- calm passes, each overlapped by forecast-ranked Prioritize -----------------
        # a second connection sends requests back to back from its own
        # thread while this one drives the passes, as kube-scheduler does
        # while the refresh loop refits
        overlap, client_errors = [], []
        passes_done = threading.Event()

        def client():
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
            try:
                i = 0
                while not passes_done.is_set():
                    t0 = time.perf_counter()
                    conn.request("POST", "/scheduler/prioritize", body=bodies[i % len(bodies)],
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    resp.read()
                    overlap.append((t0, time.perf_counter()))
                    if resp.status != 200:
                        client_errors.append(f"Prioritize answered {resp.status}")
                    i += 1
            except Exception as exc:  # noqa: BLE001 — reported below, the phase fails
                client_errors.append(repr(exc))
            finally:
                conn.close()

        calm_refits, calm_warms = len(refit_spans), len(warm_spans)
        spans.clear()
        trace.SPAN_OBSERVERS.append(spans.append)
        sender = threading.Thread(target=client, name="forecast-overlap-client", daemon=True)
        # each acquisition of the forecaster's and the mirror's locks, each
        # pass and its refit's stages, each collection: what a slow request
        # overlapped
        locks = {"forecaster": TimedLock(dut.fc._lock), "mirror": TimedLock(dut.mirror._lock)}
        dut.fc._lock, dut.mirror._lock = locks["forecaster"], locks["mirror"]
        pass_spans, calm_stages = [], []
        try:
            with collection_spans() as collected:
                sender.start()
                while not overlap and sender.is_alive():
                    time.sleep(0.01)
                for _p in range(FORECAST_CALM_PASSES):
                    launches = forecast_ring_cuda.LAUNCHES
                    drive([dut], churn=False, spans=pass_spans)
                    calm_stages.append(dict(dut.fc.refit_stages_ms))
                    if device == "cuda":
                        check(forecast_ring_cuda.LAUNCHES - launches == 1,
                              "forecast: a calm pass did not launch the kernel once")
        finally:
            passes_done.set()
            sender.join(120)
            trace.SPAN_OBSERVERS.remove(spans.append)
            dut.fc._lock, dut.mirror._lock = locks["forecaster"].inner, locks["mirror"].inner
        check(not client_errors, f"forecast overlap: {client_errors[:3]}")
        rankings = {sp.attrs.get("ranking") for sp in spans if sp.attrs.get("verb") == "prioritize"}
        check(rankings == {"forecast"}, f"forecast overlap: span rankings {rankings}")
        refits = refit_spans[calm_refits:]
        check(len(refits) == len(pass_spans), f"forecast overlap: {len(refits)} refits in {len(pass_spans)} passes")
        during = [(b - a, a, b) for a, b in overlap if any(a < r1 and b > r0 for r0, r1 in refits)]
        check(during, "forecast overlap: no request overlapped a refit")
        every = [(b - a) * 1e3 for a, b in overlap]
        during_ms = [d * 1e3 for d, _a, _b in during]
        timeline = {
            "passes": pass_spans, "refits": refits, "stages": calm_stages, "warms": warm_spans[calm_warms:],
            "collections": collected, "locks": locks, "passes_thread": threading.get_ident(),
        }
        slowest_during = max(during)
        slowest = max((b - a, a, b) for a, b in overlap)
        out["overlap"] = {
            "refit_p50_ms": statistics.median(span_ms(refits)),
            "stages": {k: statistics.median(st[k] for st in calm_stages) for k in calm_stages[0]},
            "n": len(every), "p50_ms": percentile(every, 0.5), "p99_ms": percentile(every, 0.99),
            "max_ms": max(every), "during_n": len(during), "during_p50_ms": percentile(during_ms, 0.5),
            "during_p99_ms": percentile(during_ms, 0.99), "during_max_ms": max(during_ms),
            "gc_ms": [
                [(c["end"] - c["start"]) * 1e3 for c in collected if c["generation"] == generation]
                for generation in range(3)
            ],
            "locks": lock_summary(locks, timeline["passes_thread"]),
            "slowest_during": attribution(slowest_during[1], slowest_during[2], timeline),
            "slowest": attribution(slowest[1], slowest[2], timeline),
        }
        out["calm_extrapolation"] = dut.fc.extrapolation_ok()

        # -- then an outage past the last-known-good window -------------------------------
        serves = trace.COUNTERS.get("pas_forecast_extrapolated_serves_total")
        outage_start = time.perf_counter()
        outage_passes = 0
        while max(age for age in dut.cache.metric_ages().values()) <= LKG_MAX_AGE_S + 0.5:
            drive([dut], outage=True)
            outage_passes += 1
            time.sleep(1.0)
        out["outage_passes"] = outage_passes
        connect()
        spans.clear()
        trace.SPAN_OBSERVERS.append(spans.append)
        try:
            for i in range(FORECAST_DEGRADED_REQUESTS):
                status, _data, _s = send("POST", "/scheduler/prioritize", bodies[i % len(bodies)])
                check(status == 200, f"forecast outage: Prioritize answered {status}")
            mine = [sp for sp in spans if sp.attrs.get("verb") == "prioritize"]
            check(len(mine) == FORECAST_DEGRADED_REQUESTS, f"forecast outage: {len(mine)} spans")
            for sp in mine:
                check("extrapolating" in str(sp.attrs.get("degraded", "")),
                      f"forecast outage: a request was not served by extrapolation ({sp.attrs.get('degraded')})")
                check(sp.attrs.get("path") == "native" and sp.attrs.get("ranking") == "forecast",
                      f"forecast outage: a request took path {sp.attrs.get('path')} ranking {sp.attrs.get('ranking')}")
            moved = trace.COUNTERS.get("pas_forecast_extrapolated_serves_total") - serves
            check(moved >= FORECAST_DEGRADED_REQUESTS, f"forecast outage: pas_forecast_extrapolated_serves_total moved {moved}")
            out["extrapolated_serves"] = moved
            out["outage_extrapolation"] = dut.fc.extrapolation_ok()
            # past the window's reach the horizon cap trips: neutral Prioritize
            clock.advance(period * (dut.fc.window + 1))
            spans.clear()
            status, data, _s = send("POST", "/scheduler/prioritize", bodies[0])
            sp = [s for s in spans if s.attrs.get("verb") == "prioritize"][-1]
            check(sp.attrs.get("path") == "neutral" and all(e["Score"] == 0 for e in json.loads(data)),
                  "forecast outage: past the horizon cap Prioritize is not neutral")
            out["capped_extrapolation"] = dut.fc.extrapolation_ok()
            out["outage_s"] = time.perf_counter() - outage_start
            drive([dut], churn=False)  # the metrics API is back: one good pass
            spans.clear()
            send("POST", "/scheduler/prioritize", bodies[0])
            sp = [s for s in spans if s.attrs.get("verb") == "prioritize"][-1]
            check(sp.attrs.get("ranking") == "forecast" and "degraded" not in sp.attrs,
                  "forecast: Prioritize did not recover after the outage")
        finally:
            trace.SPAN_OBSERVERS.remove(spans.append)
        out["launches"] = forecast_ring_cuda.LAUNCHES
        out["plain_on_card"] = plain_devices.count("cuda")
        out["fit_passes"] = trace.COUNTERS.get("pas_forecast_fit_passes_total") - fits
        out["refit_ms"] = span_ms(refit_spans)
        if device == "cuda":
            out["times"] = time_forecast(torch, dut.fc)
    finally:
        for name, fn in real_plain.items():
            setattr(ops_forecast, name, fn)
        for conn in conns:
            conn.close()
        server.shutdown()
        for side in assemblies.values():
            side.stop.set()
        released.set()  # the held loops raise, end their pass and stop
        released_loops.wait(60)
    return out


def time_forecast(torch, fc) -> dict:
    """The kernel's times on the forecaster's own history ring, the main
    path's input, beside the plain ring version's and the least time the
    card could take for this ring: the bytes the function must move over
    the card's memory rate (a valid byte for each slot of the live columns,
    8 bytes for each valid sample, head and shift, six int32 planes written
    once), or its operations (a test a slot, ~12 integer operations a valid
    sample, a tail of 8 a series) over the table's non-tensor-core rate,
    the larger of the two.  Beside it the bound of the ``[M, N, W]`` int32
    staging the earlier kernel read (the shift done on the host, valid
    read in every column).  ``ms`` is the kernel's device time
    (:func:`graph_ms`, 50 calls in one CUDA graph), ``call_ms`` wrapper
    calls back to back, ``profiler_ms`` ``torch.profiler``'s reading."""
    from platform_aware_scheduling_tpu_torch.ops.cuda_forecast import forecast_ring_cuda
    from platform_aware_scheduling_tpu_torch.ops.forecast import forecast_ring_reference

    ring = fc._ring
    inputs = (ring.values, ring.valid, ring.head, ring.shift_dev, ring.n_live)
    m, w, n = ring.values.shape
    n_live = ring.n_live
    samples = int(ring.valid[:, :, :n_live].sum())
    bytes_needed = m * w * n_live + 8 * samples + 8 * m + 6 * 4 * m * n
    staging_bytes = m * w * n + 4 * samples + 6 * 4 * m * n
    operations = m * w * n_live + 12 * samples + 8 * m * n
    bytes_ms = bytes_needed / HBM_BYTES_PER_S * 1e3
    operations_ms = operations / VECTOR_OPS_PER_S * 1e3
    launches = forecast_ring_cuda.LAUNCHES
    call = lambda: forecast_ring_cuda(*inputs, 1)  # noqa: E731
    device_ms = graph_ms(torch, call, 50)
    out = {
        "shape": [m, w, n],
        "n_live": n_live,
        "ms": device_ms,
        "device_ms": device_ms,
        "call_ms": cuda_ms(torch, call, 50),
        "profiler_ms": profiled_ms(torch, call, ("forecast_ring_kernel",), 50),
        "plain_ms": cuda_ms(torch, lambda: forecast_ring_reference(*inputs, 1), 5),
        "bound_ms": max(bytes_ms, operations_ms),
        "bound_by": "bytes" if bytes_ms >= operations_ms else "operations",
        "bytes": bytes_needed,
        "operations_ms": operations_ms,
        "staging_bound_ms": staging_bytes / HBM_BYTES_PER_S * 1e3,
        "staging_bytes": staging_bytes,
        "samples": samples,
    }
    forecast_ring_cuda.LAUNCHES = launches  # the timing's launches are not the main path's
    return out


def forecast_lines(f: dict, card: str) -> list:
    refit = f["churn_refit_ms"]
    full_rings = refit[FORECAST_WINDOW - 1 :]
    t = f["timed"]
    s = f["split"]
    o = f["overlap"]
    lines = [
        f"forecast world: {NUM_NODES} nodes x {NUM_METRICS} metrics, 4 policies, the planner; history ring "
        f"{'x'.join(map(str, f['ring_shape']))} on the card; set-up {f['setup_s']:.3f} s; {FORECAST_PASSES} churned "
        f"passes ({FORECAST_RAMP_SHARE:.0%} ramp up and {FORECAST_RAMP_SHARE:.0%} down {FORECAST_RAMP_MILLI} milli a "
        f"pass, the rest churn {CHURN:.0%}), each one launch, one fit pass, exact against the plain ring version and "
        f"the CPU twin (max |diff| {f['max_abs_err']}); the ring byte for byte equal to build_history_tensor's "
        f"staging on {f['staging_checks']} passes; new slots and node lookups a pass: the first "
        f"{f['slots_lookups'][0]}, the later ones {sorted(set(f['slots_lookups'][1:]))} (a sample that lists the row's last "
        f"sample's nodes in order takes its columns); forecast launches {f['launches']} = fit passes "
        f"{f['fit_passes']}; plain-version calls on the card {f['plain_on_card']}",
        f"forecast refit (a churned pass, ms): p50 {statistics.median(refit):.3f} max {max(refit):.3f} (with full "
        f"rings, passes {FORECAST_WINDOW}-{FORECAST_PASSES}: p50 {statistics.median(full_rings):.3f} max "
        f"{max(full_rings):.3f}, limit {FORECAST_REFIT_P50_LIMIT_MS:g}; split medians timed inside those refits: "
        f"snapshot and the new samples' staging {s['staging']:.3f}, upload of the new slots {s['upload']:.3f}, fit "
        f"with readback {s['fit']:.3f}, unscale and view {s['view']:.3f}); the first pass, which stages every "
        f"ring, {refit[0]:.3f}; the ranking warm after it p50 {statistics.median(f['churn_warm_ms']):.3f} ms [{card}]",
        f"forecast prioritize native over a socket ({NUM_NODES} names): p50 {t['forecast']['p50_ms']:.3f} ms "
        f"p99 {t['forecast']['p99_ms']:.3f} ms max {t['forecast']['max_ms']:.3f} ms (n={t['forecast']['n']}); "
        f"snapshot-ranked p50 {t['snapshot']['p50_ms']:.3f} ms p99 {t['snapshot']['p99_ms']:.3f} ms "
        f"max {t['snapshot']['max_ms']:.3f} ms (n={t['snapshot']['n']}); {f['differs']} of 8 bodies differ from "
        f"the snapshot ranking; every body equal to the CPU twin's and the host path's; served in "
        f"{f['serve_s']:.3f} s after the last pass, inside the {3 * SERVICE_SYNC_PERIOD_S:g} s freshness bound [{card}]",
        f"forecast prioritize native while the refresh thread refits ({FORECAST_CALM_PASSES} calm passes, refit p50 "
        f"{o['refit_p50_ms']:.3f} ms: {', '.join(f'{k} {v:.3f}' for k, v in o['stages'].items())}; requests back "
        f"to back from a second connection): overlapping a refit p50 {o['during_p50_ms']:.3f} ms p99 "
        f"{o['during_p99_ms']:.3f} ms (limit {VERB_P99_LIMIT_MS:g}) max {o['during_max_ms']:.3f} ms "
        f"(n={o['during_n']}); all in the stretch p50 {o['p50_ms']:.3f} ms p99 {o['p99_ms']:.3f} ms max "
        f"{o['max_ms']:.3f} ms (n={o['n']}), no limit on the max [{card}]",
        "forecast overlap stretch: collections "
        + ", ".join(
            f"gen {g} {len(ms)} ({sum(ms):.3f} ms, max {max(ms, default=0.0):.3f})" for g, ms in enumerate(o["gc_ms"])
        )
        + "; "
        + "; ".join(
            f"{name} lock held by the passes {v['holds']} times p50 {v['hold_p50_ms']:.3f} max {v['hold_max_ms']:.3f} "
            f"ms, {v['waits']} acquisitions by other threads waiting up to {v['wait_max_ms']:.3f} ms"
            for name, v in o["locks"].items()
        )
        + f" [{card}]",
        f"forecast overlap, the slowest request overlapping a refit: {attribution_text(o['slowest_during'])} [{card}]",
        f"forecast overlap, the slowest request of the stretch: {attribution_text(o['slowest'])} [{card}]",
        f"forecast degraded: after the churn {f['churn_extrapolation']}; after {FORECAST_CALM_PASSES} calm passes "
        f"{f['calm_extrapolation']}; an outage of {f['outage_s']:.1f} s ({f['outage_passes']} failed passes) past "
        f"the {LKG_MAX_AGE_S:g} s last-known-good window: {f['extrapolated_serves']} extrapolated serves, "
        f"{f['outage_extrapolation']}; past the window's reach {f['capped_extrapolation']}, Prioritize neutral",
    ]
    if "times" in f:
        k = f["times"]
        lines.append(
            f"forecast main path, the forecaster's ring {'x'.join(map(str, k['shape']))} ({k['n_live']} live "
            f"columns): kernel device {k['device_ms']:.4f} ms (torch.profiler {ms_or_not_measured(k['profiler_ms'])}), "
            f"a wrapper call {k['call_ms']:.4f} ms, plain PyTorch {k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms "
            f"by {k['bound_by']} ({k['bytes']} bytes for {k['samples']} valid samples; operations "
            f"{k['operations_ms']:.4f} ms), {k['bound_ms'] / k['device_ms']:.3f} of it; the [M, N, W] int32 staging's "
            f"bound {k['staging_bound_ms']:.4f} ms ({k['staging_bytes']} bytes) is lower because the host shifted "
            f"the values to 4 bytes there, where the ring holds 8-byte milli values and the kernel shifts them (and "
            f"it read valid in the padding columns too); no single PyTorch call computes this function [{card}]"
        )
    return lines


def check_forecast_limits(f: dict) -> None:
    check(f["timed"]["forecast"]["p99_ms"] <= VERB_P99_LIMIT_MS,
          f"forecast: native Prioritize p99 {f['timed']['forecast']['p99_ms']:.3f} ms over {VERB_P99_LIMIT_MS} ms")
    full_rings = statistics.median(f["churn_refit_ms"][FORECAST_WINDOW - 1 :])
    check(full_rings <= FORECAST_REFIT_P50_LIMIT_MS,
          f"forecast: full-ring refit p50 {full_rings:.3f} ms over {FORECAST_REFIT_P50_LIMIT_MS} ms")
    o = f["overlap"]
    check(o["during_p99_ms"] <= VERB_P99_LIMIT_MS,
          f"forecast: Prioritize overlapping a refit p99 {o['during_p99_ms']:.3f} ms over {VERB_P99_LIMIT_MS} ms")


# -- phase 11: the batch planner's other solvers ---------------------------------------

SOLVER_PERIODS = 4
SOLVER_SYNC_PERIOD_S = 3600.0  # the assemblies' loops never tick here: the phase drives each period itself
# micro-nats between the card's quantised guide and the CPU twin's: logsumexp
# sums in another order on the card (tests/test_torch_sinkhorn.py holds the
# CPU against JAX at 16, measured 4)
SINKHORN_GUIDE_TOL = 100


def run_solvers(torch, np, device: str, main_inputs=None) -> dict:
    """The TAS batch planner with ``--batchSolver=sinkhorn``, assembled by
    ``cmd/tas.assemble`` on ``device`` beside a CPU twin, over the verbs
    phase's world in the fake API server (10,000 nodes, 8 metrics, 4
    policies, 1,000 pending pods; the mirror 8 x 16384); the metrics API
    is the smoke run's own source, which it drives a pass a period.  Each
    of ``SOLVER_PERIODS`` periods churns 30% of the values, refreshes both
    sides and replans both; every Sinkhorn solve is recorded.  Each card
    replan must launch the greedy kernel once and the plain greedy never on
    the card; the card's assignment must be feasible, its quantised guide
    within ``SINKHORN_GUIDE_TOL`` micro-nats of the twin's, its rounding
    equal to the plain greedy on its own guide, and every pod that lands
    elsewhere than on the twin must sit on a near-tie of the twin's guide.
    Then, given the planner phase's kernel inputs, the auction fixpoint on
    the card must equal the greedy kernel."""
    from platform_aware_scheduling_tpu_torch.cmd import tas
    from platform_aware_scheduling_tpu_torch.ops import assign as assign_ops
    from platform_aware_scheduling_tpu_torch.ops import sinkhorn
    from platform_aware_scheduling_tpu_torch.ops.cuda_assign import greedy_assign_cuda
    from platform_aware_scheduling_tpu_torch.tas.metrics import NodeMetric
    from platform_aware_scheduling_tpu_torch.testing.fake_kube import FakeKubeClient
    from platform_aware_scheduling_tpu_torch.utils.duration import parse_duration
    from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity

    out = {}
    rng = np.random.default_rng(SEED + 4)
    kube = FakeKubeClient()
    start = time.perf_counter()
    nodes = forecast_world(kube)
    values = rng.integers(0, 100_000, size=(NUM_METRICS, NUM_NODES))
    store = {}

    def publish():
        for j, metric in enumerate(METRIC_NAMES):
            store[metric] = {n: NodeMetric(value=Quantity(f"{int(v)}m")) for n, v in zip(nodes, values[j].tolist())}

    publish()
    released = threading.Event()
    args = tas.build_arg_parser().parse_args(
        ["--batchPlanner", "--batchSolver=sinkhorn", f"--syncPeriod={SOLVER_SYNC_PERIOD_S:g}s"]
    )
    solves = []  # (device type, (score, eligible, capacity), SinkhornResult) of each solve
    plain_devices = []  # the device of each plain greedy call
    real_sinkhorn, real_plain = sinkhorn.sinkhorn_assign, assign_ops.greedy_assign_reference

    def recorded_sinkhorn(score, eligible, capacity, *a, **kw):
        result = real_sinkhorn(score, eligible, capacity, *a, **kw)
        solves.append((score.device.type, (score, eligible, capacity), result))
        return result

    def recorded_plain(score, eligible, capacity):
        plain_devices.append(score.device.type)
        return real_plain(score, eligible, capacity)

    sides = {}
    sinkhorn.sinkhorn_assign = recorded_sinkhorn
    assign_ops.greedy_assign_reference = recorded_plain
    try:
        for side, dev in (("dut", device), ("twin", "cpu")):
            client = DrivenMetrics(threading.get_ident(), store, released)
            cache, mirror, ext, _controller, _enforcer, stop = tas.assemble(
                kube,
                client,
                parse_duration(args.syncPeriod),
                enable_batch_planner=args.batchPlanner,
                batch_solver=args.batchSolver,
                device=dev,
            )
            sides[side] = SimpleNamespace(cache=cache, mirror=mirror, planner=ext.planner, stop=stop, client=client)
        dut, twin = sides["dut"], sides["twin"]
        check(dut.planner.solver == twin.planner.solver == "sinkhorn", "solvers: the assembly's planner is not Sinkhorn")
        check(dut.planner.device.type == device, f"solvers: the planner is not on {device}")
        for side in sides.values():
            wait_for(
                lambda s=side: len(s.cache.registered_metric_names()) == NUM_METRICS
                and all(s.mirror.policy("default", f"pol-{k}") is not None for k in range(4)),
                60,
                "solvers: the policies through the CRD informer",
            )
            wait_for(
                lambda s=side: s.planner.pending_count() == NUM_PODS and len(s.planner._node_alloc) == NUM_NODES,
                60,
                "solvers: the pods and nodes through the planner's informers",
            )

        def drive():
            moved = rng.random(values.shape) < CHURN
            values[...] = np.where(moved, rng.integers(0, 100_000, size=values.shape), values)
            publish()
            for side in sides.values():
                side.cache.update_all_metrics(side.client)

        drive()
        out["setup_s"] = time.perf_counter() - start
        dut.planner.replan()  # warm-up: the first view upload and solve
        twin.planner.replan()
        keys = dut.planner.pending_keys()
        out.update(walls=[], launches=[], plain_on_card=0, planned=[], differing=[], guide_err=[], plan_err=[],
                   near_tie_gap=[], twin_s=[])
        for _period in range(SOLVER_PERIODS):
            drive()
            solves.clear()
            plain_devices.clear()
            before = greedy_assign_cuda.LAUNCHES
            t0 = time.perf_counter()
            planned = dut.planner.replan()
            if device != "cpu":
                torch.cuda.synchronize()
            out["walls"].append(time.perf_counter() - t0)
            out["launches"].append(greedy_assign_cuda.LAUNCHES - before)
            out["plain_on_card"] += plain_devices.count("cuda")
            t0 = time.perf_counter()
            twin_planned = twin.planner.replan()
            out["twin_s"].append(time.perf_counter() - t0)
            check(twin_planned == planned, f"solvers: {planned} pods planned on the card, {twin_planned} on the CPU")
            check([d for d, _i, _r in solves] == [device, "cpu"], f"solvers: solves on {[d for d, _i, _r in solves]}")
            (_d, (score, eligible, capacity), card), (_d2, (score_c, eligible_c, capacity_c), cpu) = solves
            check(
                torch.equal(score.cpu(), score_c) and torch.equal(eligible.cpu(), eligible_c)
                and torch.equal(capacity.cpu(), capacity_c),
                "solvers: the card and the CPU twin solved different problems",
            )
            got = card.assignment.node_for_pod.cpu()
            want = cpu.assignment.node_for_pod
            placed = got >= 0
            rows = torch.nonzero(placed).flatten()
            check(bool(eligible_c[rows, got[placed].long()].all()), "solvers: a pod planned onto an ineligible node")
            counts = torch.bincount(got[placed].long(), minlength=capacity_c.shape[0])
            check(bool((counts <= capacity_c.long()).all()), "solvers: a node planned past its capacity")
            guide_err = int((card.guide.cpu() - cpu.guide).abs().max())
            check(guide_err <= SINKHORN_GUIDE_TOL,
                  f"solvers: the card's guide is {guide_err} micro-nats from the twin's (limit {SINKHORN_GUIDE_TOL})")
            rounded = real_plain(card.guide, eligible, capacity)
            check(
                torch.equal(rounded.node_for_pod, card.assignment.node_for_pod)
                and torch.equal(rounded.capacity_left, card.assignment.capacity_left),
                "solvers: the card's rounding differs from the plain greedy on its own guide",
            )
            differing = torch.nonzero(got != want).flatten().tolist()
            gap = 0
            for pod in differing:
                a, b = int(got[pod]), int(want[pod])
                check(a >= 0 and b >= 0, f"solvers: pod {pod} placed on one side only ({a}, {b})")
                gap = max(gap, abs(int(cpu.guide[pod, a]) - int(cpu.guide[pod, b])))
            check(gap <= 2 * SINKHORN_GUIDE_TOL,
                  f"solvers: a pod off the twin's node is {gap} micro-nats from a tie (limit {2 * SINKHORN_GUIDE_TOL})")
            plans = {k: dut.planner._plan.get(k, (None,))[0] for k in keys}
            twin_plans = {k: twin.planner._plan.get(k, (None,))[0] for k in keys}
            check(sum(plans[k] != twin_plans[k] for k in keys) == len(differing),
                  "solvers: the planners' plans differ beyond the solves' assignments")
            out["planned"].append(planned)
            out["differing"].append(len(differing))
            out["near_tie_gap"].append(gap)
            out["guide_err"].append(guide_err)
            out["plan_err"].append(float((card.plan.cpu() - cpu.plan).abs().max()))
        want_launches = [int(device != "cpu")] * SOLVER_PERIODS
        check(out["launches"] == want_launches, f"solvers: greedy_assign launches a replan {out['launches']}")
        check(out["plain_on_card"] == 0, f"solvers: the plain greedy ran {out['plain_on_card']} times on the card's path")
        out["shape"] = list(score.shape)
        if device != "cpu":
            launches = greedy_assign_cuda.LAUNCHES
            logits = sinkhorn.sinkhorn_logits(score, eligible, 0.05)
            out["iterations_ms"] = cuda_ms(
                torch, lambda: sinkhorn.sinkhorn_scaling(logits, eligible, capacity, sinkhorn.DEFAULT_ITERATIONS), 3
            )
            out["solve_ms"] = cuda_ms(torch, lambda: real_sinkhorn(score, eligible, capacity), 3)
            greedy_assign_cuda.LAUNCHES = launches  # the timing's launches are not the main path's
        if main_inputs is not None:
            launches = greedy_assign_cuda.LAUNCHES
            auction, rounds = assign_ops.auction_assign(*main_inputs)
            greedy = assign_ops.greedy_assign(*main_inputs)
            check(
                torch.equal(auction.node_for_pod, greedy.node_for_pod)
                and torch.equal(auction.capacity_left, greedy.capacity_left),
                "solvers: the auction fixpoint differs from the greedy kernel on the planner phase's inputs",
            )
            out["auction_rounds"] = rounds
            out["auction_placed"] = int((auction.node_for_pod >= 0).sum())
            if device != "cpu":
                out["auction_ms"] = cuda_ms(torch, lambda: assign_ops.auction_assign(*main_inputs), 3)
            greedy_assign_cuda.LAUNCHES = launches
    finally:
        sinkhorn.sinkhorn_assign = real_sinkhorn
        assign_ops.greedy_assign_reference = real_plain
        for side in sides.values():
            side.stop.set()
        released.set()  # a held refresh loop raises, ends its pass and stops
    return out


def solver_lines(v: dict, card: str) -> list:
    walls = [w * 1e3 for w in v["walls"]]
    lines = [
        f"solvers world: {NUM_NODES} nodes x {NUM_METRICS} metrics x {NUM_PODS} pending pods, 4 policies, "
        f"--batchSolver=sinkhorn through cmd/tas.assemble beside a CPU twin; set-up {v['setup_s']:.3f} s; "
        f"{SOLVER_PERIODS} churned periods, solve {'x'.join(map(str, v['shape']))}, planned {v['planned']}; "
        f"greedy_assign launches a replan {v['launches']}, plain greedy on the card {v['plain_on_card']}",
        f"solvers sinkhorn: replan wall p50 {statistics.median(walls):.3f} ms (all: "
        f"{', '.join(f'{t:.3f}' for t in walls)}); the CPU twin's replan {statistics.median(v['twin_s']):.3f} s; "
        f"every assignment feasible and equal to the plain greedy on the card's own guide; guide |card - CPU| "
        f"max {v['guide_err']} micro-nats (limit {SINKHORN_GUIDE_TOL}); plan |card - CPU| max "
        f"{max(v['plan_err']):.3g}; pods off the twin's node {v['differing']}, the widest gap of their two nodes' "
        f"CPU guides {v['near_tie_gap']} micro-nats (limit {2 * SINKHORN_GUIDE_TOL}) [{card}]",
    ]
    if "iterations_ms" in v:
        lines.append(
            f"solvers sinkhorn device: {v['iterations_ms']:.3f} ms the 50 iterations, {v['solve_ms']:.3f} ms the "
            f"whole solve with its greedy rounding (CUDA events, 3 calls) [{card}]"
        )
    if "auction_rounds" in v:
        timed = f", {v['auction_ms']:.3f} ms a call (CUDA events, one host read a round)" if "auction_ms" in v else ""
        lines.append(
            f"solvers auction on the planner phase's inputs: equal to the greedy kernel, {v['auction_placed']} pods "
            f"placed in {v['auction_rounds']} rounds{timed} [{card}]"
        )
    return lines


# -- phase 12: the fused TAS+GAS solve -----------------------------------------------

FusedProblem = namedtuple("FusedProblem", "state pods req_class gas requests max_gpus")
FUSED_SOLVES = 3  # main-path solves, each T bin-pack launches and one scan launch


def fused_problem(torch, np, device: str, num_nodes=10_000, num_pods=1_000, num_cards=8, num_res=3,
                  num_classes=3, seed=21) -> FusedProblem:
    """BASELINE config #4 (the fused TAS+GAS solve, 10,000 nodes x 1,000
    pods): a numpy copy of ``benchmarks/configs._fused_problem``'s recipe,
    the same draws in the same order, over the port's ``example_inputs``
    (4 metrics); 8 cards a node, 3 resources, 3 request classes of 2
    containers with 1-2 GPUs each."""
    from platform_aware_scheduling_tpu_torch.models.batch_scheduler import example_inputs
    from platform_aware_scheduling_tpu_torch.models.fused import FusedRequests
    from platform_aware_scheduling_tpu_torch.ops.binpack import BinpackNodeState

    rng = np.random.default_rng(seed)
    state, pods = example_inputs(num_metrics=4, num_nodes=num_nodes, num_pods=num_pods, seed=seed, device=device)
    cap = rng.integers(600, 1200, size=(num_nodes, num_res)).astype(np.int64)
    used = rng.integers(0, 400, size=(num_nodes, num_cards, num_res)).astype(np.int64)
    used = np.minimum(used, cap[:, None, :])
    need = rng.integers(40, 260, size=(num_classes, 2, num_res)).astype(np.int64)
    need_active = rng.random((num_classes, 2, num_res)) > 0.2
    num_gpus = rng.integers(1, 3, size=(num_classes, 2)).astype(np.int32)
    container_active = np.ones((num_classes, 2), dtype=bool)
    req_class = rng.integers(0, num_classes, size=num_pods).astype(np.int32)

    def put(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    gas = BinpackNodeState(
        used=put(used),
        capacity=put(cap),
        cap_present=put(np.ones((num_nodes, num_res), dtype=bool)),
        card_valid=put(np.ones((num_nodes, num_cards), dtype=bool)),
        card_real=put(np.ones((num_nodes, num_cards), dtype=bool)),
        card_order=put(np.broadcast_to(np.arange(num_cards, dtype=np.int32), (num_nodes, num_cards))),
    )
    requests = FusedRequests(put(need), put(need_active), put(num_gpus), put(container_active))
    return FusedProblem(state, pods, put(req_class), gas, requests, int(num_gpus.max()))


def fused_edge_cases(torch, np, device: str) -> list:
    """(name, FusedProblem): small problems at the edges the kernel must
    keep, each from :func:`fused_problem` edited in numpy."""
    int64_max = 2**63 - 1

    def edited(seed, num_nodes=300, num_pods=120, edit=None, **kw):
        base = fused_problem(torch, np, "cpu", num_nodes=num_nodes, num_pods=num_pods, seed=seed, **kw)
        parts = {
            "state": {k: v.numpy().copy() for k, v in base.state._asdict().items() if k != "dontschedule"},
            "pods": {k: v.numpy().copy() for k, v in base.pods._asdict().items()},
            "gas": {k: v.numpy().copy() for k, v in base.gas._asdict().items()},
            "requests": {k: v.numpy().copy() for k, v in base.requests._asdict().items()},
            "req_class": base.req_class.numpy().copy(),
        }
        rng = np.random.default_rng(seed)
        if edit is not None:
            edit(parts, rng)

        def put(array):
            return torch.from_numpy(np.ascontiguousarray(array)).to(device)

        rules = type(base.state.dontschedule)(*(v.to(device) for v in base.state.dontschedule))
        state = base.state._replace(dontschedule=rules, **{k: put(v) for k, v in parts["state"].items()})
        pods = type(base.pods)(**{k: put(v) for k, v in parts["pods"].items()})
        gas = type(base.gas)(**{k: put(v) for k, v in parts["gas"].items()})
        requests = type(base.requests)(**{k: put(v) for k, v in parts["requests"].items()})
        max_gpus = int(parts["requests"]["num_gpus"].max())
        return FusedProblem(state, pods, put(parts["req_class"]), gas, requests, max_gpus)

    def near_wrap(parts, rng):
        gas = parts["gas"]
        gas["capacity"][:] = int64_max - rng.integers(0, 200, size=gas["capacity"].shape)
        near = rng.random(gas["used"].shape[:2]) < 0.5
        gas["used"][:] = np.where(near[..., None], int64_max - rng.integers(0, 300, size=gas["used"].shape),
                                  gas["used"])

    def order_past_2_30(parts, rng):
        gas = parts["gas"]
        gas["card_order"][::3, 0] = 2**30 + 1 + rng.integers(0, 5, size=gas["card_order"][::3, 0].shape)
        gas["card_order"][1::3, 1] = 2**30
        gas["card_order"][2::3] = gas["card_order"][2::3, ::-1]  # order unlike lane order
        gas["used"][::2, 4:, :] = gas["capacity"][::2, None, :]  # full cards beside them
        gas["card_valid"][5::7, 3] = False
        gas["card_real"][6::7, 2] = False

    def fits_nowhere(parts, rng):
        parts["requests"]["need"][1, 0, 0] = 10**6
        parts["requests"]["need_active"][1, 0, 0] = True

    def capacity_zero(parts, rng):
        parts["state"]["capacity"][::4] = 0
        parts["gas"]["cap_present"][1::5, 0] = False
        parts["gas"]["capacity"][2::5, 1] = 0

    def inactive(parts, rng):
        parts["requests"]["container_active"][0, 1] = False
        parts["requests"]["need_active"][:, :, 1] = False
        parts["requests"]["need"][:, :, 1] = 10**15

    def contention(parts, rng):
        parts["state"]["capacity"][:] = 1
        parts["state"]["metric_values"] //= 200_000  # five values: ties broken by index
        parts["pods"]["candidates"][::9] = False  # pods with no candidate

    def wide(parts, rng):
        parts["requests"]["num_gpus"][:, 0] = 3
        parts["gas"]["used"][:, ::2, :] = 0

    def revival(parts, rng):
        # three cards of room (10, 10); on every other node they hold (0, 0),
        # (10, 10), (0, 5), where class 1 ((1, 5) then (0, 8)) fits only once
        # class 0 ((10, 0)) has booked the first card
        gas, req = parts["gas"], parts["requests"]
        gas["capacity"][:] = 10
        gas["used"][:] = 0
        gas["used"][::2] = [[0, 0], [10, 10], [0, 5]]
        req["need"][:] = [[[10, 0], [0, 0]], [[1, 5], [0, 8]]]
        req["need_active"][:] = True
        req["num_gpus"][:] = 1
        req["container_active"][:] = [[True, False], [True, True]]
        parts["req_class"][:] = rng.random(parts["req_class"].shape) < 0.6

    def overflow(parts, rng):
        # class 0 pod i may use node i alone, so 300 nodes revive class 1,
        # more than its revived list holds; the class 1 pods then rescan
        revival(parts, rng)
        parts["gas"]["used"][:] = [[0, 0], [10, 10], [0, 5]]
        parts["state"]["capacity"][:] = 2
        parts["state"]["metric_values"][:2] //= 2  # no node breaks a dontschedule rule
        parts["state"]["metric_present"][:] = True
        parts["req_class"][:] = np.arange(parts["req_class"].shape[0]) >= 300
        parts["pods"]["candidates"][:300] = np.eye(300, parts["pods"]["candidates"].shape[1], dtype=bool)
        parts["pods"]["candidates"][300:] = True

    def shared_row(parts, rng):
        # every pod scores the nodes alike and each node takes one pod, so
        # the pods after the first 128 find their lists used up
        parts["state"]["capacity"][:] = 1
        parts["pods"]["metric_row"][:] = 0
        parts["pods"]["op_id"][:] = parts["pods"]["op_id"][0]
        parts["pods"]["candidates"][:] = True

    def exhausted(parts, rng):
        # every pod may use only the first 40 nodes, fewer than a list holds
        parts["state"]["capacity"][:] = 1
        parts["pods"]["candidates"][:] = False
        parts["pods"]["candidates"][:, :40] = True

    return [
        ("near-wrap usage", edited(31, edit=near_wrap)),
        ("card_order past 2^30", edited(32, edit=order_past_2_30)),
        ("a class that fits nowhere", edited(33, edit=fits_nowhere)),
        ("capacity 0 and absent resources", edited(34, edit=capacity_zero)),
        ("inactive containers and resources", edited(35, edit=inactive)),
        ("contention and ties", edited(36, num_nodes=64, num_pods=200, edit=contention)),
        ("33 cards, 5 resources, 5 classes, 3 GPUs", edited(37, num_nodes=500, num_pods=150, num_cards=33,
                                                          num_res=5, num_classes=5, edit=wide)),
        ("5 nodes", edited(38, num_nodes=5, num_pods=40)),
        ("1000 nodes, 1 pod", edited(39, num_nodes=1000, num_pods=1)),
        ("a booking revives a fit", edited(40, num_nodes=60, num_pods=200, num_cards=3, num_res=2, num_classes=2,
                                           edit=revival)),
        ("the revived list overflows", edited(43, num_nodes=400, num_pods=400, num_cards=3, num_res=2,
                                              num_classes=2, edit=overflow)),
        ("lists of 128 run out", edited(41, num_nodes=600, num_pods=300, edit=shared_row)),
        ("an exhausted complete list", edited(42, num_nodes=400, num_pods=100, edit=exhausted)),
    ]


# what each new edge case is there to exercise: every count named must be > 0
FUSED_CASE_WANTS = {
    "a booking revives a fit": ("revived placements", "revivals"),
    "the revived list overflows": ("revived placements", "revivals", "rescans"),
    "lists of 128 run out": ("rescans",),
    "an exhausted complete list": ("exhausted lists",),
}


def fused_scan_args(torch, problem) -> tuple:
    """The scan's inputs of a fused problem, on its device: (score,
    eligible, capacity, req_class, fits0, gas, requests, max_gpus)."""
    from platform_aware_scheduling_tpu_torch.models.batch_scheduler import score_and_filter
    from platform_aware_scheduling_tpu_torch.models.fused import _all_fits

    _violating, score, eligible = score_and_filter(problem.state, problem.pods)
    fits0 = _all_fits(problem.gas, problem.requests, problem.max_gpus)
    return (score, eligible, problem.state.capacity, problem.req_class, fits0, problem.gas, problem.requests,
            problem.max_gpus)


def on_cpu(args) -> tuple:
    """The scan's inputs moved to the CPU (NamedTuples of tensors kept)."""
    return tuple(
        type(x)(*(v.cpu() for v in x)) if isinstance(x, tuple) else x.cpu() if hasattr(x, "cpu") else x for x in args
    )


def check_fused_stages(torch, name: str, args, want, on_card: bool) -> dict:
    """The kernel's two launches against their plain model: the staged
    model (run on the CPU) equal to the plain scan ``want`` on the four
    scan outputs; on the card the kernel equal to both and its (rescans,
    revivals) equal to the model's.  Returns :func:`fused_case_facts` and
    checks :data:`FUSED_CASE_WANTS` for the case."""
    from platform_aware_scheduling_tpu_torch.models.fused import fused_scan_staged_reference
    from platform_aware_scheduling_tpu_torch.ops.cuda_fused import (
        LIST_SIZE,
        REVIVED_SIZE,
        fused_schedule_cuda_with_stats,
    )

    cpu_args = on_cpu(args)
    t0 = time.perf_counter()
    model, model_stats = fused_scan_staged_reference(*cpu_args, LIST_SIZE, REVIVED_SIZE)
    model_s = time.perf_counter() - t0
    for label, m, w in zip(model._fields, model, want):
        check(torch.equal(m, w.cpu()), f"fused {name}: the staged model's {label} differs from the plain version")
    stats = tuple(model_stats)
    if on_card:
        scan, kernel_stats = fused_schedule_cuda_with_stats(*args)
        for label, g, m in zip(scan._fields, scan, model):
            check(torch.equal(g.cpu(), m), f"fused {name}: the kernel's {label} differs from the staged model")
        kernel_stats = tuple(int(x) for x in kernel_stats.tolist())
        check(kernel_stats == stats,
              f"fused {name}: the kernel counted (rescans, revivals) {kernel_stats}, the staged model {stats}")
    facts = fused_case_facts(torch, cpu_args, want.node_for_pod, stats)
    for key in FUSED_CASE_WANTS.get(name, ()):
        check(facts[key] > 0, f"fused {name}: the case has no {key}")
    facts["model_s"] = model_s
    return facts


def fused_case_facts(torch, args, node_for_pod, stats) -> dict:
    """What a solve exercised: pods placed on a node their class did not
    fit at the start, pods left at -1 with a complete list (1 to L
    starting-ok lanes), and the resolve's rescans and revivals (``stats``,
    from the kernel or the staged model)."""
    from platform_aware_scheduling_tpu_torch.ops.cuda_fused import LIST_SIZE

    _score, eligible, capacity, req_class, fits0 = (x.cpu() for x in args[:5])
    node_for_pod = node_for_pod.cpu()
    cls = req_class.long()
    counts = (eligible & (capacity > 0) & fits0[cls]).sum(dim=1)
    placed = node_for_pod >= 0
    revived = placed & ~fits0[cls, node_for_pod.clamp(min=0).long()]
    rescans, revivals = (int(x) for x in stats)
    return {
        "revived placements": int(revived.sum()),
        "exhausted lists": int((~placed & (counts > 0) & (counts <= LIST_SIZE)).sum()),
        "rescans": rescans,
        "revivals": revivals,
    }


def fused_outputs_equal(torch, name: str, got, want) -> float:
    """All five outputs of a fused solve, exactly; returns the largest
    absolute difference seen (0 when exact)."""
    err = 0.0
    for label, g, w in zip(got._fields, got, want):
        check(g.dtype == w.dtype and g.shape == w.shape, f"fused {name}: {label} has another form")
        if g.numel():
            err = max(err, float((g.to(torch.float64) - w.to(torch.float64)).abs().max()))
        check(torch.equal(g, w), f"fused {name}: {label} differs from the plain version")
    return err


def check_fused_limits(torch, problem) -> None:
    """Shapes past the kernel's limits and classes outside [0, T) are
    refused before a launch; so is N past the resolve block's shared
    memory, which must take the mirror's 16,384 nodes at the main path's
    shape."""
    from platform_aware_scheduling_tpu_torch.ops import cuda_fused
    from platform_aware_scheduling_tpu_torch.ops.binpack import BinpackNodeState

    score, eligible, capacity, req_class, fits0, gas, requests, max_gpus = fused_scan_args(torch, problem)
    t, tc, _r = requests.need.shape
    launches = cuda_fused.fused_schedule_cuda.LAUNCHES
    bad = req_class.clone()
    bad[-1] = t
    n, c, r = gas.used.shape
    device = score.device
    ones = torch.ones((n, 65), dtype=torch.bool, device=device)
    wide = gas._replace(
        used=torch.zeros((n, 65, r), dtype=torch.int64, device=device),
        card_valid=ones,
        card_real=ones,
        card_order=torch.zeros((n, 65), dtype=torch.int32, device=device),
    )
    limit = cuda_fused.max_nodes(device, c, r, t, tc)
    check(limit >= 16384, f"fused: the resolve block takes {limit} nodes at C={c}, R={r}, T={t}, Tc={tc}, under 16,384")
    big = limit + 1
    big_gas = BinpackNodeState(
        used=torch.zeros((big, c, r), dtype=torch.int64, device=device),
        capacity=torch.ones((big, r), dtype=torch.int64, device=device),
        cap_present=torch.ones((big, r), dtype=torch.bool, device=device),
        card_valid=torch.ones((big, c), dtype=torch.bool, device=device),
        card_real=torch.ones((big, c), dtype=torch.bool, device=device),
        card_order=torch.zeros((big, c), dtype=torch.int32, device=device),
    )
    past_limit = (
        torch.zeros((1, big), dtype=torch.int64, device=device),
        torch.ones((1, big), dtype=torch.bool, device=device),
        torch.ones(big, dtype=torch.int32, device=device),
        req_class[:1].clone(),
        torch.ones((t, big), dtype=torch.bool, device=device),
        big_gas,
    )
    for what, args, says in (
        ("a class outside [0, T)", (score, eligible, capacity, bad, fits0, gas), "classes span"),
        ("65 cards", (score, eligible, capacity, req_class, fits0, wide), "card lanes"),
        (f"N={big} nodes", past_limit, "shared memory"),
    ):
        try:
            cuda_fused.fused_schedule_cuda(*args, requests, max_gpus)
        except ValueError as exc:
            check(says in str(exc), f"fused: {what} refused for another reason: {exc}")
            continue
        raise SmokeError(f"fused: {what} was not refused")
    check(cuda_fused.fused_schedule_cuda.LAUNCHES == launches, "fused: a refused call counted a launch")
    print(
        f"fused parity: a class outside [0, T), 65 cards and N={big} refused before a launch (the resolve block "
        f"takes {limit} nodes at C={c}, R={r}, T={t}, Tc={tc}: {cuda_fused.shared_bytes(limit, c, r, t, tc)} of "
        f"{cuda_fused.max_shared(device)} bytes of shared memory)"
    )


def run_fused(torch, np, device: str = "cuda", num_nodes: int = 10_000, num_pods: int = 1_000) -> dict:
    """BASELINE config #4 on the card: the fused kernel held exactly
    against the plain solve and against the staged model of its two
    launches, rescans and revivals included, on edge cases; then the main
    path, :func:`fused_problem` at full size, solved ``FUSED_SOLVES`` times
    by ``models/fused.fused_schedule`` with every count set to 0 just
    before (each solve T bin-pack launches and one scan launch), then once
    by the plain version on the card, all five outputs equal, and the
    kernel's counts against the staged model's; then the times.  A CPU
    rehearsal passes ``device="cpu"`` and a smaller ``num_nodes`` and
    ``num_pods``."""
    from platform_aware_scheduling_tpu_torch.models import fused
    from platform_aware_scheduling_tpu_torch.ops import cuda_fused
    from platform_aware_scheduling_tpu_torch.ops.cuda_binpack import binpack_cuda

    on_card = device != "cpu"
    out = {"cases": 0, "max_abs_err": 0.0, "edge_rescans": 0, "edge_revivals": 0}
    for name, problem in fused_edge_cases(torch, np, device):
        got = fused.fused_schedule(*problem)
        want = fused.fused_schedule_reference(*problem)
        err = fused_outputs_equal(torch, f"parity {name}", got, want)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["cases"] += 1
        facts = check_fused_stages(torch, name, fused_scan_args(torch, problem), want, on_card)
        out["edge_rescans"] += facts["rescans"]
        out["edge_revivals"] += facts["revivals"]
        print(
            f"fused parity {name}: exact ({int((got.node_for_pod >= 0).sum())} of {got.node_for_pod.numel()} pods "
            f"placed, {int((got.used != problem.gas.used).any(dim=-1).sum())} cards booked, "
            f"{int(got.fits.sum())} of {got.fits.numel()} class fits left; {facts['rescans']} rescans, "
            f"{facts['revivals']} revivals, {facts['revived placements']} pods on a revived node, "
            f"{facts['exhausted lists']} complete lists used up, as the staged model counts)"
        )
    problem = fused_problem(torch, np, device, num_nodes=num_nodes, num_pods=num_pods)
    if on_card:
        check_fused_limits(torch, problem)
    t = problem.requests.need.shape[0]
    fused_kernel = cuda_fused.fused_schedule_cuda
    fused_kernel.LAUNCHES = 0
    binpack_cuda.LAUNCHES = 0
    walls = []
    for _ in range(FUSED_SOLVES):
        t0 = time.perf_counter()
        result = fused.fused_schedule(*problem)
        if on_card:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["launches"] = fused_kernel.LAUNCHES
    out["binpack_launches"] = binpack_cuda.LAUNCHES
    solves = FUSED_SOLVES if on_card else 0
    check(out["launches"] == solves, f"fused: {out['launches']} scan launches for {solves} solves")
    check(out["binpack_launches"] == solves * t,
          f"fused: {out['binpack_launches']} bin-pack launches for {solves} solves of {t} classes")
    nodes = result.node_for_pod
    p, n = problem.pods.candidates.shape
    placed = nodes >= 0
    check(bool((nodes < n).all()), "fused: a pod placed past the last node")
    booked = torch.bincount(nodes[placed].long(), minlength=n).to(torch.int32)
    check(torch.equal(result.capacity_left, problem.state.capacity - booked), "fused: capacity_left is not capacity - bookings")
    check(bool((result.capacity_left >= 0).all()), "fused: a node booked past its capacity")
    check(bool((result.used >= problem.gas.used).all()), "fused: a card's usage went down")
    check(bool((result.used <= problem.gas.capacity.unsqueeze(1)).all()), "fused: a card booked past its capacity")
    out["placed"] = int(placed.sum())
    out["walls"] = walls
    t0 = time.perf_counter()
    want = fused.fused_schedule_reference(*problem)
    if on_card:
        torch.cuda.synchronize()
    out["plain_solve_s"] = time.perf_counter() - t0
    err = fused_outputs_equal(torch, f"main path {n} x {p}", result, want)
    out["max_abs_err"] = max(out["max_abs_err"], err)
    args = fused_scan_args(torch, problem)
    facts = check_fused_stages(torch, f"main path {n} x {p}", args, want, on_card)
    out["rescans"], out["revivals"], out["model_s"] = facts["rescans"], facts["revivals"], facts["model_s"]
    out["list_size"], out["revived_size"] = cuda_fused.LIST_SIZE, cuda_fused.REVIVED_SIZE
    out["shape"] = [p, n, *problem.gas.used.shape[1:], t, problem.requests.need.shape[1], problem.max_gpus]
    if on_card:
        out["times"] = time_fused(torch, args)
    return out


def time_fused(torch, args) -> dict:
    """The scan kernel's times on the main path's inputs, beside the plain
    scan's and the least time the card could take: the bytes the function
    must move (each input read once, each output written once) over the
    card's memory rate.  ``ms`` is the kernel's device time, 3 calls (each
    both launches) captured in a CUDA graph and replayed between events
    (or, where the capture is refused, 3 calls back to back between events,
    ``graph_note`` saying so); ``candidates_ms`` the candidate pass's, 3 in
    a graph; ``resolve_ms`` the resolve's, the median of 5 launches each
    between two events (it books into its input, so each follows a
    candidate pass); ``call_ms`` a wrapper call's (its class check reads
    the classes back); ``profiler_ms`` ``torch.profiler``'s reading of both
    kernels."""
    from platform_aware_scheduling_tpu_torch.models import fused
    from platform_aware_scheduling_tpu_torch.ops import cuda_fused

    score, eligible, capacity, req_class, fits0, gas, requests, _max_gpus = args
    p, n = score.shape
    _n, c, r = gas.used.shape
    t = fits0.shape[0]
    inputs = (score, eligible, capacity, req_class, fits0, *gas, *requests)
    bytes_needed = sum(x.numel() * x.element_size() for x in inputs) + 4 * p + 4 * n + 8 * n * c * r + t * n
    launches = cuda_fused.fused_schedule_cuda.LAUNCHES
    launch = lambda: cuda_fused.launch(*args)  # noqa: E731
    candidates = lambda: cuda_fused.launch_candidates(*args[:6])  # noqa: E731
    out = {"shape": [p, n, c, r, t], "bytes": bytes_needed, "bound_ms": bytes_needed / HBM_BYTES_PER_S * 1e3}
    try:
        out["graph_ms"] = graph_ms(torch, launch, 3, replays=3)
        out["candidates_ms"] = graph_ms(torch, candidates, 3, replays=3)
        out["graph_note"] = None
    except RuntimeError as exc:
        torch.cuda.synchronize()
        out["graph_ms"] = None
        out["candidates_ms"] = cuda_ms(torch, candidates, 3)
        out["graph_note"] = f"capture refused: {str(exc).splitlines()[0][:160]}"
    resolves = []
    for _ in range(6):  # the first is a warm-up
        staged = candidates()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cuda_fused.launch_resolve(*args, *staged)
        end.record()
        torch.cuda.synchronize()
        resolves.append(start.elapsed_time(end))
    out["resolve_ms"] = statistics.median(resolves[1:])
    out["events_ms"] = cuda_ms(torch, launch, 3)
    out["ms"] = out["graph_ms"] if out["graph_ms"] is not None else out["events_ms"]
    out["device_ms"] = out["ms"]
    out["profiler_ms"] = profiled_ms(torch, launch, ("candidates_kernel", "resolve_kernel"), 3)
    out["call_ms"] = cuda_ms(torch, lambda: cuda_fused.fused_schedule_cuda(*args), 3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fused.fused_scan_reference(*args)
    end.record()
    torch.cuda.synchronize()
    out["plain_ms"] = start.elapsed_time(end)
    cuda_fused.fused_schedule_cuda.LAUNCHES = launches  # the timing's launches are not the main path's
    return out


def fused_lines(f: dict, card: str) -> list:
    p, n, c, r, classes, containers, k = f["shape"]
    walls = [w * 1e3 for w in f["walls"]]
    lines = [
        f"fused world: BASELINE config #4, {n} nodes x {p} pods, {c} cards x {r} resources, {classes} classes of "
        f"{containers} containers (max_gpus {k}), seed 21; {f['cases']} edge cases and the main path exact against "
        f"the plain version on all five outputs; {FUSED_SOLVES} solves: fused_schedule launches {f['launches']}, "
        f"binpack launches {f['binpack_launches']}; {f['placed']} pods placed; solve wall p50 "
        f"{statistics.median(walls):.3f} ms; the plain solve {f['plain_solve_s']:.3f} s [{card}]",
        f"fused stages: list {f['list_size']}, revived list {f['revived_size']} a class; main path {f['rescans']} "
        f"rescans, {f['revivals']} revivals; edge cases {f['edge_rescans']} rescans, {f['edge_revivals']} revivals; "
        f"{'the kernel' if 'times' in f else 'the plain scan'} equal to the staged model, counts included (model "
        f"{f['model_s']:.3f} s on the CPU)",
    ]
    if "times" not in f:
        return lines
    t = f["times"]
    device = (f"{t['graph_ms']:.4f} ms (3 calls in a CUDA graph)" if t["graph_ms"] is not None
              else f"{t['events_ms']:.4f} ms (3 calls between events; {t['graph_note']})")
    return lines + [
        f"fused_schedule main path {p}x{n}: kernel device {device} (two launches: candidates "
        f"{t['candidates_ms']:.4f} ms, resolve {t['resolve_ms']:.4f} ms), events {t['events_ms']:.4f} ms, "
        f"torch.profiler {ms_or_not_measured(t['profiler_ms'])}, a wrapper call {t['call_ms']:.4f} ms; "
        f"{t['resolve_ms'] / p * 1e3:.3f} us a pod in the resolve; plain scan {t['plain_ms']:.3f} ms; bound "
        f"{t['bound_ms']:.4f} ms ({t['bytes']} bytes); library call: none, no single PyTorch call computes the "
        f"fused scan [{card}]",
    ]


def main() -> int:
    if not (ROOT / PACKAGE / "__init__.py").is_file():
        print(f"chip_smoke: {PACKAGE}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a GPU", file=sys.stderr)
        return 1

    card = card_line()
    print(card)

    from platform_aware_scheduling_tpu_torch.ops import _build, cuda_assign

    start = time.perf_counter()
    ptxas = start_ptxas_report("binpack")
    forecast_ptxas = start_ptxas_report("forecast")
    fused_ptxas = start_ptxas_report("fused_schedule")
    libs = _build.build()
    print(f"build: {', '.join(sorted(libs))} in {time.perf_counter() - start:.3f} s")
    from platform_aware_scheduling_tpu_torch import native

    start = time.perf_counter()
    check(
        native.get_wirec() is not None,
        "the wire extension _wirec_torch did not build or load (no C compiler, or PAS_TPU_NO_NATIVE=1)",
    )
    print(f"build: {native.so_path().name} (the verbs' wire extension, cc) in {time.perf_counter() - start:.3f} s")
    instances = binpack_ptxas_report(ptxas)
    forecast_resources = forecast_ptxas_report(forecast_ptxas)
    fused_resources = fused_ptxas_report(fused_ptxas)
    print(
        "fused scan kernels (-Xptxas -v): " + ", ".join(
            f"{name} {v['registers']} registers, {v['stack']} bytes of stack, {v['spills']} of spills"
            for name, v in sorted(fused_resources.items()))
    )
    print(
        f"forecast ring kernel (-Xptxas -v): {forecast_resources['registers']} registers, "
        f"{forecast_resources['stack']} bytes of stack, {forecast_resources['spills']} of spills"
    )
    print(
        "binpack instances (-Xptxas -v; G/cards a lane/resources in registers: registers, stack and spill "
        "bytes): " + ", ".join(f"{g}/{s}/{r}: {v['registers']}, {v['stack']}, {v['spills']}"
                               for (g, s, r), v in sorted(instances.items()))
    )

    limit = cuda_assign.max_nodes(torch.device("cuda"))
    cases = parity_cases(torch, np, limit, cuda_assign.list_size())
    max_err = run_parity(torch, cases)
    check_node_limit(torch, limit)
    gas_max_err = run_gas_parity(torch, gas_parity_cases(torch, np))
    check_card_limit(torch)
    forecast_max_err = run_forecast_parity(torch, np)

    kernel = cuda_assign.greedy_assign_cuda
    launches = []

    def count(event):
        if event == "reset":
            kernel.LAUNCHES = 0
        else:
            launches.append(kernel.LAUNCHES)

    main_path = run_main_path(torch, np, "cuda", on_replan=count)
    total = kernel.LAUNCHES
    check(
        launches == list(range(1, SYNC_PERIODS + 1)),
        f"greedy_assign launches after each replan: {launches}",
    )
    m_cap, n_cap = main_path["view_shape"]
    print(
        f"main path: {NUM_NODES} nodes x {NUM_METRICS} metrics x {NUM_PODS} pending pods "
        f"(mirror {m_cap}x{n_cap}), {main_path['full_nodes']} full and "
        f"{main_path['nearly_full_nodes']} nearly full nodes, {main_path['bound_pods']} bound pods; "
        f"set-up {main_path['setup_s']:.3f} s; planned per sync period {main_path['planned']}; "
        f"plans identical to the CPU planner; greedy_assign launches {total}"
    )
    main_inputs = main_path["kernel_inputs"]
    max_err = max(max_err, run_parity(torch, [("main-path inputs", *main_inputs)]))

    replan_ms = [w * 1e3 for w in main_path["replan_wall_s"]]
    print(
        f"replan wall p50 {statistics.median(replan_ms):.3f} ms over {SYNC_PERIODS} sync periods "
        f"(all: {', '.join(f'{t:.3f}' for t in replan_ms)}) [{card}]"
    )
    parts = replan_breakdown(torch, main_path["planner"])
    print(
        f"replan breakdown (medians, unchanged cluster): solve inputs {parts['inputs_ms']:.3f} ms, "
        f"solve {parts['solve_ms']:.3f} ms (score_and_filter device "
        f"{parts['score_and_filter_device_ms']:.3f} ms), readback {parts['readback_ms']:.3f} ms [{card}]"
    )

    verbs = run_verbs(torch, np, main_path, "cuda")
    print(verbs_line(verbs, card))
    print(verbs_wire_line(verbs, card))
    print(verbs_breakdown_line(verbs, card))
    print(verbs_tail_line(verbs, card))
    check_limits(verbs, replan_ms)
    print(
        f"limits met: native verb p99 <= {VERB_P99_LIMIT_MS} ms, warm passes <= {REFRESH_WARM_LIMIT_MS} ms "
        f"a refresh, replan p50 <= {REPLAN_P50_LIMIT_MS} ms"
    )

    service = run_service(torch, np, "cuda")
    for line in service_lines(service, card):
        print(line)
    check_service_limits(service)
    check(service["launches"] > 0, "service: the live planner never launched greedy_assign")
    print(f"limits met: every enforcement cycle <= {ENFORCE_CYCLE_LIMIT_S * 1e3:.0f} ms")
    for line in faults_lines(service, card):
        print(line)
    check_faults_limits(service)
    check(
        all(service["faults"]["launches_by_replica"].values()),
        "faults: a replica's live planner never launched greedy_assign",
    )
    print(
        f"limits met: faults verb p99 <= {VERB_P99_LIMIT_MS} ms, every cycle <= "
        f"{ENFORCE_CYCLE_LIMIT_S * 1e3:.0f} ms, failover <= {LEASE_DURATION_S + LEASE_RENEW_S + SERVICE_SYNC_PERIOD_S:.0f} s"
    )

    gas_out = run_gas(torch, np, "cuda")
    for line in gas_lines(gas_out, card):
        print(line)
    check_gas_limits(gas_out)
    gas_max_err = max(gas_max_err, gas_out["max_abs_err"])
    print(f"limits met: GAS Filter p99 <= {VERB_P99_LIMIT_MS} ms")

    forecast_out = run_forecast(torch, np, "cuda")
    for line in forecast_lines(forecast_out, card):
        print(line)
    check_forecast_limits(forecast_out)
    check(
        forecast_out["launches"] == forecast_out["fit_passes"] > 0,
        f"forecast: {forecast_out['launches']} kernel launches for {forecast_out['fit_passes']} fit passes",
    )
    check(forecast_out["plain_on_card"] == 0,
          f"forecast: the plain version ran {forecast_out['plain_on_card']} times on the card's path")
    forecast_max_err = max(forecast_max_err, forecast_out["max_abs_err"])
    print(
        f"limits met: forecast-ranked native Prioritize p99 <= {VERB_P99_LIMIT_MS} ms, Prioritize overlapping a "
        f"refit p99 <= {VERB_P99_LIMIT_MS} ms, full-ring refit p50 <= {FORECAST_REFIT_P50_LIMIT_MS:g} ms"
    )

    solvers = run_solvers(torch, np, "cuda", main_inputs=main_inputs)
    for line in solver_lines(solvers, card):
        print(line)
    sinkhorn_p50 = statistics.median(solvers["walls"]) * 1e3
    check(sinkhorn_p50 <= REPLAN_P50_LIMIT_MS, f"solvers: Sinkhorn replan wall p50 {sinkhorn_p50:.3f} ms is over its limit")
    print(f"limits met: Sinkhorn replan p50 <= {REPLAN_P50_LIMIT_MS} ms")

    fused_out = run_fused(torch, np)
    for line in fused_lines(fused_out, card):
        print(line)

    # the kernels' device times last, so the profiler and the graphs' pools
    # are not in the host-timed phases
    timed = {
        label: time_kernel(torch, *next(case[1:] for case in cases if case[0].startswith(label)))
        for label in ("slice shape", "ascending scores", "shared rows, capacity 1")
    }
    main_times = timed["main-path inputs"] = time_kernel(torch, *main_inputs, profiled=True)
    for label, t in timed.items():
        p, n = t["shape"]
        profiler = f", torch.profiler {ms_or_not_measured(t['profiler_ms'])}" if label == "main-path inputs" else ""
        print(
            f"greedy_assign {label} {p}x{n}: kernel device {t['device_ms']:.4f} ms (a wrapper call "
            f"{t['call_ms']:.4f} ms{profiler}; two launches: "
            f"candidates {t['candidates_ms']:.4f} ms, resolve {t['resolve_ms']:.4f} ms, "
            f"{t['rescans']} rescans), plain PyTorch "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms (dense "
            f"{t['dense_bound_ms']:.4f} ms); no single PyTorch call computes this function [{card}]"
        )

    gas_times = gas_out["times"]
    forecast_times = forecast_out["times"]
    fused_times = fused_out["times"]
    kernels = [
        {
            "name": "greedy_assign",
            "route": "cuda",
            "source": f"{PACKAGE}/csrc/greedy_assign.cu",
            "replaces": "platform_aware_scheduling_tpu/ops/pallas_assign.py:44",
            "launches": total,
            "max_abs_err": max_err,
            "ms": main_times["ms"],
            "device_ms": main_times["device_ms"],
            "call_ms": main_times["call_ms"],
            "profiler_ms": main_times["profiler_ms"],
            "plain_ms": main_times["plain_ms"],
            "bound_ms": main_times["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "parity": True,
            "shape": main_times["shape"],
            "candidates_ms": main_times["candidates_ms"],
            "resolve_ms": main_times["resolve_ms"],
            "rescans": main_times["rescans"],
            "verbs_launches": verbs["launches"],
            "service_launches": service["launches"],
            "faults_launches": service["faults"]["launches"],
            "sinkhorn_launches": sum(solvers["launches"]),
        },
        {
            "name": "binpack",
            "route": "cuda",
            "source": f"{PACKAGE}/csrc/binpack.cu",
            "replaces": "platform_aware_scheduling_tpu/ops/binpack.py:157",
            "launches": gas_out["launches"],
            "max_abs_err": gas_max_err,
            "ms": gas_times["ms"],
            "device_ms": gas_times["device_ms"],
            "floor_ms": gas_times["floor_ms"],
            "call_ms": gas_times["call_ms"],
            "profiler_ms": gas_times["profiler_ms"],
            "plain_ms": gas_times["plain_ms"],
            "bound_ms": gas_times["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "parity": True,
            "shape": gas_times["shape"],
            "fits_cache_misses": gas_out["misses"],
            "fits_cache_hits": gas_out["hits"],
        },
        {
            "name": "forecast",
            "route": "cuda",
            "source": f"{PACKAGE}/csrc/forecast.cu",
            "replaces": "platform_aware_scheduling_tpu/ops/forecast.py:65",
            "launches": forecast_out["launches"],
            "max_abs_err": forecast_max_err,
            "ms": forecast_times["ms"],
            "device_ms": forecast_times["device_ms"],
            "call_ms": forecast_times["call_ms"],
            "profiler_ms": forecast_times["profiler_ms"],
            "plain_ms": forecast_times["plain_ms"],
            "bound_ms": forecast_times["bound_ms"],
            "bound_by": forecast_times["bound_by"],
            "library_ms": None,
            "parity": True,
            "shape": forecast_times["shape"],
            "n_live": forecast_times["n_live"],
            "bytes": forecast_times["bytes"],
            "staging_bound_ms": forecast_times["staging_bound_ms"],
            "registers": forecast_resources["registers"],
            "fit_passes": forecast_out["fit_passes"],
            "refit_p50_ms": statistics.median(forecast_out["churn_refit_ms"][FORECAST_WINDOW - 1 :]),
        },
        {
            "name": "fused_schedule",
            "route": "cuda",
            "source": f"{PACKAGE}/csrc/fused_schedule.cu",
            "replaces": "platform_aware_scheduling_tpu/models/fused.py:171",
            "launches": fused_out["launches"],
            "max_abs_err": fused_out["max_abs_err"],
            "ms": fused_times["ms"],
            "device_ms": fused_times["device_ms"],
            "graph_ms": fused_times["graph_ms"],
            "events_ms": fused_times["events_ms"],
            "call_ms": fused_times["call_ms"],
            "profiler_ms": fused_times["profiler_ms"],
            "plain_ms": fused_times["plain_ms"],
            "bound_ms": fused_times["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "parity": True,
            "shape": fused_times["shape"],
            "bytes": fused_times["bytes"],
            "binpack_launches": fused_out["binpack_launches"],
            "parity_cases": fused_out["cases"],
            "candidates_ms": fused_times["candidates_ms"],
            "resolve_ms": fused_times["resolve_ms"],
            "rescans": fused_out["rescans"],
            "revivals": fused_out["revivals"],
            "edge_rescans": fused_out["edge_rescans"],
            "edge_revivals": fused_out["edge_revivals"],
            "list_size": fused_out["list_size"],
            "revived_size": fused_out["revived_size"],
            "registers": {name: v["registers"] for name, v in fused_resources.items()},
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
