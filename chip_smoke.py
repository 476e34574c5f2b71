#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``platform_aware_scheduling_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card (the greedy-assign
kernel also against the plain model of its two stages, rescan count
included), then drives the batch planner's main path at full size — 10,000
nodes, 8 metrics, 4 TAS policies, 1,000 pending pods — through 5 sync
periods, checking every plan against the same planner on the CPU and that
each replan launched the kernel once.  Prints the card, the timings (the
kernel's two stages and its rescans at the main path's inputs and three
others), a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result line, when there is no GPU, when the package is not beside this
script, or when any phase fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
SEED = 0


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


def run_main_path(torch, np, device: str, on_replan=None) -> dict:
    """Drive cache -> mirror -> planner at full size on ``device``, each
    plan checked against the same planner on the CPU."""
    from platform_aware_scheduling_tpu_torch.kube.objects import Node, Pod, object_key
    from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
    from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
    from platform_aware_scheduling_tpu_torch.tas.metrics import DummyMetricsClient, NodeMetric
    from platform_aware_scheduling_tpu_torch.tas.planner import BatchPlanner
    from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy
    from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity

    def rule(metricname, operator, target):
        return {"metricname": metricname, "operator": operator, "target": target}

    rng = np.random.default_rng(SEED)
    setup_start = time.perf_counter()
    cache = AutoUpdatingCache()
    mirrors = {name: TensorStateMirror(device=dev) for name, dev in (("dut", device), ("cpu", "cpu"))}
    for mirror in mirrors.values():
        mirror.attach(cache)
    planners = {
        name: BatchPlanner(cache, mirror, device=mirror.device) for name, mirror in mirrors.items()
    }
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
    metric_names = [f"metric{j}" for j in range(NUM_METRICS)]
    for metric in metric_names:
        cache.write_metric(metric)  # registration, as the policy controller does

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


def time_kernel(torch, score, eligible, capacity) -> dict:
    """Kernel, stage and plain-version times on one problem, the stage-2
    rescan count, and the least time the card could take: the bytes the
    function must move over the card's memory rate.  It must read the whole eligible mask, the score of every
    eligible lane, the capacity, and write the result and the capacity
    left; the dense figure counts every score as read."""
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
    return {
        "shape": [p, n],
        "ms": cuda_ms(torch, lambda: greedy_assign_cuda(score, eligible, capacity), 20),
        "candidates_ms": cuda_ms(torch, lambda: launch_candidates(score, eligible, capacity), 20),
        "resolve_ms": cuda_ms(
            torch, lambda: launch_resolve(score, eligible, capacity, lists, counts), 20
        ),
        "rescans": int(rescans.item()),
        "plain_ms": cuda_ms(torch, lambda: greedy_assign_reference(score, eligible, capacity), 3),
        "bound_ms": bytes_needed / HBM_BYTES_PER_S * 1e3,
        "dense_bound_ms": bytes_dense / HBM_BYTES_PER_S * 1e3,
    }


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
    libs = _build.build()
    print(f"build: {', '.join(sorted(libs))} in {time.perf_counter() - start:.3f} s")

    limit = cuda_assign.max_nodes(torch.device("cuda"))
    cases = parity_cases(torch, np, limit, cuda_assign.list_size())
    max_err = run_parity(torch, cases)
    check_node_limit(torch, limit)

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
    timed = {
        label: time_kernel(torch, *next(case[1:] for case in cases if case[0].startswith(label)))
        for label in ("slice shape", "ascending scores", "shared rows, capacity 1")
    }
    main_times = timed["main-path inputs"] = time_kernel(torch, *main_inputs)
    for label, t in timed.items():
        p, n = t["shape"]
        print(
            f"greedy_assign {label} {p}x{n}: kernel {t['ms']:.4f} ms (two launches: "
            f"candidates {t['candidates_ms']:.4f} ms, resolve {t['resolve_ms']:.4f} ms, "
            f"{t['rescans']} rescans), plain PyTorch "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms (dense "
            f"{t['dense_bound_ms']:.4f} ms); no single PyTorch call computes this function [{card}]"
        )

    kernels = [
        {
            "name": "greedy_assign",
            "route": "cuda",
            "source": f"{PACKAGE}/csrc/greedy_assign.cu",
            "replaces": "platform_aware_scheduling_tpu/ops/pallas_assign.py:44",
            "launches": total,
            "max_abs_err": max_err,
            "ms": main_times["ms"],
            "plain_ms": main_times["plain_ms"],
            "bound_ms": main_times["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "parity": True,
            "shape": main_times["shape"],
            "candidates_ms": main_times["candidates_ms"],
            "resolve_ms": main_times["resolve_ms"],
            "rescans": main_times["rescans"],
        }
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
