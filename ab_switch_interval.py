"""A shorter interpreter switch interval, A/B on the card.

This script runs the TAS service and faults phases of ``chip_smoke.py``
(``run_service``) in separate processes, half of them with CPython's
default 5 ms switch interval and half with a shorter one, set where the
serving posture is applied (``utils/gctuning.tune_for_serving``, once the
informers have listed).  It prints what the interval can move: the
degraded verbs' p99 (neutral Prioritize, fail-open Filter) and the worst
enforcement cycle of each branch (labels, suspended, follower).  A run
that fails a check of the smoke is reported with the check's message, not
retried.

    python3 ab_switch_interval.py [--runs 6] [--interval-ms 0.5]

It needs one CUDA card.  The sides alternate A B B A A B ... so that drift
of a shared host lands on both.  One line a run, then the card's line and
a JSON summary last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEFAULT_S = 0.005  # CPython's own switch interval


def child(interval_s: float) -> dict:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from platform_aware_scheduling_tpu_torch.utils import gctuning

    posture = gctuning.tune_for_serving

    def tune_for_serving() -> None:
        posture()
        sys.setswitchinterval(interval_s)

    gctuning.tune_for_serving = tune_for_serving  # run_service imports it at call time
    out = {"interval_ms": interval_s * 1e3}
    start = time.perf_counter()
    try:
        s = chip_smoke.run_service(torch, np, "cuda")
    except chip_smoke.SmokeError as exc:
        out["failed"] = str(exc)
        return out
    finally:
        out["seconds"] = time.perf_counter() - start
    ms = lambda c: (c["end"] - c["start"]) * 1e3  # noqa: E731
    worst = {}
    for phase, cycles in (("service", s["cycles"]), ("faults", s["faults"]["cycles"])):
        for c in cycles:
            key = f"{phase} {c['branch']}"
            worst[key] = max(worst.get(key, 0.0), ms(c))
    out["worst_cycle_ms"] = worst
    out["verb_p99_ms"] = {verb: t["p99_ms"] for verb, t in s["faults"]["verbs"].items()}
    try:
        chip_smoke.check_service_limits(s)
        chip_smoke.check_faults_limits(s)
    except chip_smoke.SmokeError as exc:
        out["failed"] = str(exc)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=6)
    parser.add_argument("--interval-ms", type=float, default=0.5, help="the shorter side's switch interval")
    parser.add_argument("--child", type=float, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child)))
        return 0

    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("ab_switch_interval: this needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from platform_aware_scheduling_tpu_torch.ops import _build

    card = chip_smoke.card_line()
    _build.build()
    sides = {"default": DEFAULT_S, "shorter": args.interval_ms / 1e3}
    order = [("default", "shorter", "shorter", "default")[i % 4] for i in range(args.runs)]
    runs = []
    for side in order:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", repr(sides[side])],
            cwd=ROOT,
            capture_output=True,
            text=True,
            timeout=900,
        )
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        run = {"side": side, **json.loads(lines[-1])}
        runs.append(run)
        print(json.dumps(run))
    summary = {}
    for side in sides:
        mine = [r for r in runs if r["side"] == side]
        done = [r for r in mine if "verb_p99_ms" in r]
        summary[side] = {
            "interval_ms": sides[side] * 1e3,
            "runs": len(mine),
            "failed": [r["failed"] for r in mine if "failed" in r],
            "verb_p99_ms": {
                verb: sorted(r["verb_p99_ms"][verb] for r in done) for verb in (done[0]["verb_p99_ms"] if done else ())
            },
            "worst_cycle_ms": {
                key: max(r["worst_cycle_ms"].get(key, 0.0) for r in done)
                for key in sorted({k for r in done for k in r["worst_cycle_ms"]})
            },
            "median_seconds": statistics.median(r["seconds"] for r in mine),
        }
    print(card)
    print(json.dumps({"ab_switch_interval": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
