"""GAS service main: flags, assembly, signal handling.

The port's copy of ``platform_aware_scheduling_tpu/cmd/gas.py``
(reference gpu-aware-scheduling/cmd/gas-scheduler-extender/main.go:11-35).
The reference's flag surface (``--kubeConfig --port --cert --key --cacert
--unsafe`` plus klog's ``--v``), the robustness flags without
``--degradedMode`` (GAS has no telemetry to degrade), and the decision-log
and event-journal flags, each with the JAX main's name, default and
meaning.  A usage mirror on the GPU sits behind the cache, so Filter's
bin-pack runs on the card.

    python -m platform_aware_scheduling_tpu_torch.cmd.gas --unsafe

The flags of the JAX main's other planes (profiler, async serving,
admission, SLO, control, flight recorder, solve observatory) are absent
until their planes are ported, so argparse refuses them.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import List, Optional

from platform_aware_scheduling_tpu_torch.cmd import common
from platform_aware_scheduling_tpu_torch.extender.server import Server
from platform_aware_scheduling_tpu_torch.gas.cache import Cache
from platform_aware_scheduling_tpu_torch.gas.scheduler import GASExtender
from platform_aware_scheduling_tpu_torch.kube.client import get_kube_client
from platform_aware_scheduling_tpu_torch.utils import klog
from platform_aware_scheduling_tpu_torch.utils.device import DeviceLike, resolve_device
from platform_aware_scheduling_tpu_torch.utils.gctuning import tune_for_serving


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gas-extender",
        description="GPU-aware scheduling extender (PyTorch, CUDA)",
    )
    default_kubeconfig = os.path.join(os.path.expanduser("~"), ".kube", "config")
    parser.add_argument("--kubeConfig", default=default_kubeconfig,
                        help="location of kubernetes config file")
    parser.add_argument("--port", default="9001",
                        help="port on which the scheduler extender will listen")
    parser.add_argument("--cert", default="/etc/kubernetes/pki/ca.crt",
                        help="cert file extender will use")
    parser.add_argument("--key", default="/etc/kubernetes/pki/ca.key",
                        help="key file extender will use")
    parser.add_argument("--cacert", default="/etc/kubernetes/pki/ca.crt",
                        help="ca file extender will use")
    parser.add_argument("--unsafe", action="store_true",
                        help="unsafe instances of extender will be served over http")
    parser.add_argument("--v", type=int, default=4, help="klog verbosity")
    common.add_robustness_flags(parser, degraded=False)
    common.add_forecast_flags(parser, forecast=False)
    common.add_decision_flags(parser)
    common.add_event_flags(parser)
    return parser


def assemble(kube_client, *, retry_policy=None, device: DeviceLike = None):
    """Wire the cache (its node and pod informers listed, its worker
    running) and the extender with its usage mirror on ``device``.
    Returns ``(cache, extender)``; ``cache.stop()`` ends every background
    thread."""
    cache = Cache(kube_client)
    try:
        extender = GASExtender(kube_client, cache=cache, retry_policy=retry_policy, device=device)
    except BaseException:
        cache.stop()
        raise
    return cache, extender


def build_server(extender) -> Server:
    """The threaded HTTP front-end over an extender, ``/metrics`` serving
    the extender's exposition."""
    return Server(extender, metrics_provider=extender.metrics_text)


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    # the device rule first: without a GPU the service does not start,
    # and it never carries on quietly on the CPU
    try:
        device = resolve_device(None)
    except RuntimeError as exc:
        print(f"gas-extender: {exc}", file=sys.stderr)
        return 1
    klog.set_verbosity(args.v)
    common.configure_decisions(args)
    common.configure_events(args)

    # the informers and the bind and annotate traffic go through the
    # fault-tolerant proxy (retry, backoff, circuit breaking)
    retry_policy, breakers = common.build_fault_tolerance(args)
    kube_client = common.wrap_kube_client(get_kube_client(args.kubeConfig), retry_policy, breakers)
    cache, extender = assemble(kube_client, retry_policy=retry_policy, device=device)
    # the informers' initial lists are in: freeze them out of collections
    tune_for_serving()
    server = build_server(extender)
    done = threading.Event()
    failed = []

    def serve():
        try:
            server.start_server(
                port=args.port,
                cert_file=args.cert,
                key_file=args.key,
                ca_file=args.cacert,
                unsafe=args.unsafe,
                block=True,
            )
        except Exception as exc:  # noqa: BLE001 — a dead server takes the process down
            klog.error("extender server failed: %s", exc)
            failed.append(exc)
            done.set()

    threading.Thread(target=serve, daemon=True).start()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    cache.stop()
    server.shutdown()
    klog.v(1).info_s("Exiting", component="extender")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
