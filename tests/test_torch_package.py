"""Package-level rules of the port: it imports neither JAX nor the JAX
package, its entry points refuse to run quietly on the CPU, and
``convert.py`` carries int64 across exactly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import platform_aware_scheduling_tpu_torch as port
from platform_aware_scheduling_tpu.ops import i64 as jax_i64
from platform_aware_scheduling_tpu_torch import convert
from platform_aware_scheduling_tpu_torch.models import batch_scheduler
from platform_aware_scheduling_tpu_torch.ops import i64
from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
from platform_aware_scheduling_tpu_torch.tas.planner import BatchPlanner

PORT_ROOT = Path(port.__file__).resolve().parent
REPO_ROOT = PORT_ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "platform_aware_scheduling_tpu")


def _port_modules():
    for path in sorted(PORT_ROOT.rglob("*.py")):
        rel = path.relative_to(REPO_ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_import_pulls_in_no_jax():
    """Import every module of the port in a fresh interpreter (this one
    already has JAX loaded by tests/conftest.py)."""
    modules = [name for _path, name in _port_modules()]
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(bad), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO_ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []", out.stdout


VERB_MODULES = [
    f"{PORT_ROOT.name}.{name}"
    for name in (
        "extender",
        "extender.server",
        "extender.types",
        "ops.scoring",
        "tas.fastpath",
        "tas.strategies.core",
        "tas.strategies.dontschedule",
        "tas.telemetryscheduler",
        "utils.decisions",
        "utils.events",
        "utils.health",
        "utils.trace",
        "utils.tracing",
    )
]


@pytest.mark.parametrize("module", VERB_MODULES)
def test_import_pin_covers_the_verb_modules(module):
    """The verbs' modules are among those the import pin above loads."""
    assert module in {name for _path, name in _port_modules()}


SERVICE_MODULES = [
    f"{PORT_ROOT.name}.{name}"
    for name in (
        "cmd",
        "cmd.common",
        "cmd.tas",
        "kube.client",
        "kube.informer",
        "kube.lease",
        "kube.retry",
        "tas.controller",
        "tas.degraded",
        "tas.strategies.deschedule",
        "tas.strategies.scheduleonmetric",
        "testing",
        "testing.builders",
        "testing.fake_kube",
        "testing.faults",
        "utils.duration",
        "utils.gctuning",
    )
]


@pytest.mark.parametrize("module", SERVICE_MODULES)
def test_import_pin_covers_the_service_modules(module):
    """The service main's modules are among those the import pin loads."""
    assert module in {name for _path, name in _port_modules()}


@pytest.mark.parametrize("package", ["cmd", "testing"])
def test_service_packages_pull_in_no_jax(package):
    """``cmd/`` and ``testing/`` alone, in a fresh interpreter: the smoke
    run imports them without the rest of the repo's tests."""
    modules = [m for m in SERVICE_MODULES if m.split(".")[1] == package]
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


FORECAST_MODULES = [
    f"{PORT_ROOT.name}.{name}" for name in ("forecast", "forecast.engine", "ops.forecast", "ops.cuda_forecast")
]


@pytest.mark.parametrize("module", FORECAST_MODULES)
def test_forecast_module_pulls_in_no_jax(module):
    """Each forecast-plane module alone, in a fresh interpreter: no JAX and
    nothing of the JAX package (the kernel's library is not built at
    import)."""
    assert module in {name for _path, name in _port_modules()}
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_native_loader_pulls_in_no_jax():
    """The wire extension's loader, built and loaded, in a fresh
    interpreter: it is the port's own copy, and brings in neither JAX nor
    the JAX package's ``native`` module."""
    code = (
        "import sys\n"
        "from platform_aware_scheduling_tpu_torch.native import get_wirec\n"
        "module = get_wirec()\n"
        "print(module is not None and module.__name__, "
        f"sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "PAS_TPU_NO_NATIVE")}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    loaded, forbidden = out.stdout.strip().split(" ", 1)
    assert forbidden == "[]", out.stdout
    assert loaded in ("_wirec_torch", "False")  # False only without a C compiler


def test_no_source_imports_the_jax_package():
    offenders = []
    for path, _name in _port_modules():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.name}:{node.lineno} {name}")
    assert offenders == []


def test_every_kernel_source_is_built():
    from platform_aware_scheduling_tpu_torch.ops import _build

    sources = sorted(p.stem for p in (PORT_ROOT / "csrc").glob("*.cu"))
    assert sources == sorted(_build.KERNELS)


class TestDeviceRule:
    @pytest.fixture(autouse=True)
    def _no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    @pytest.mark.parametrize(
        "entry",
        [
            lambda: TensorStateMirror(),
            lambda: batch_scheduler.example_inputs(),
            lambda: convert.pending_pods_from_numpy(
                np.zeros(1, np.int32), np.zeros(1, np.int32), np.ones((1, 2), bool)
            ),
            lambda: convert.cluster_state_from_numpy(
                *[np.zeros((1, 2), t) for t in (np.int32, np.uint32, bool)],
                *[np.zeros(8, t) for t in (np.int32, np.int32, np.int32, np.uint32, bool)],
                np.ones(2, np.int32),
            ),
            lambda: BatchPlanner(AutoUpdatingCache(), TensorStateMirror(device="cpu")),
            lambda: convert.history_tensor_from_numpy(np.zeros((1, 1, 2), np.int32), np.ones((1, 1, 2), bool)),
            lambda: convert.forecast_result_from_numpy(*[np.zeros((1, 1), np.int32)] * 6),
            lambda: convert.fused_requests_from_numpy(
                np.zeros((1, 1, 1), np.int32), np.zeros((1, 1, 1), np.uint32), np.ones((1, 1, 1), bool),
                np.ones((1, 1), np.int32), np.ones((1, 1), bool),
            ),
        ],
        ids=["mirror", "example_inputs", "pending_pods", "cluster_state", "planner", "history", "forecast_result",
             "fused_requests"],
    )
    def test_no_device_and_no_gpu_raises(self, entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()

    def test_explicit_cpu_runs(self):
        mirror = TensorStateMirror(device="cpu")
        planner = BatchPlanner(AutoUpdatingCache(), mirror, device="cpu")
        assert planner.device.type == mirror.device.type == "cpu"
        assert mirror.device_view().values.device.type == "cpu"

    def test_planner_refuses_other_device_than_mirror(self):
        with pytest.raises(ValueError, match="differs"):
            BatchPlanner(AutoUpdatingCache(), TensorStateMirror(device="cpu"), device="meta")

    def test_unported_solver_refused(self):
        with pytest.raises(ValueError, match="'auction' is not one of greedy, sinkhorn"):
            BatchPlanner(
                AutoUpdatingCache(), TensorStateMirror(device="cpu"), solver="auction", device="cpu"
            )


@pytest.mark.parametrize("seed", range(3))
def test_int64_split_round_trip(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate(
        [
            rng.integers(i64.INT64_MIN, i64.INT64_MAX, size=200, dtype=np.int64),
            np.array([i64.INT64_MIN, -(2**32), -(2**31), -1, 0, 2**31, 2**32 - 1, i64.INT64_MAX]),
        ]
    )
    hi, lo = i64.split_int64(values)
    want_hi, want_lo = jax_i64.split_int64_np(values)
    assert hi.dtype == np.int32 and lo.dtype == np.uint32
    np.testing.assert_array_equal(hi, want_hi)
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(i64.join_int64(hi, lo), values)
    state = convert.cluster_state_from_numpy(
        hi.reshape(8, -1),
        lo.reshape(8, -1),
        np.ones((8, values.size // 8), bool),
        np.zeros(8, np.int32),
        np.zeros(8, np.int32),
        hi[:8],
        lo[:8],
        np.ones(8, bool),
        np.ones(values.size // 8, np.int32),
        device="cpu",
    )
    np.testing.assert_array_equal(state.metric_values.numpy().ravel(), values)
    np.testing.assert_array_equal(state.dontschedule.target.numpy(), values[:8])


def test_fused_cuda_wrapper_refuses_cpu_tensors():
    """``ops/cuda_fused`` launches for CUDA tensors only: CPU tensors are
    refused before the builder is touched, never run on the plain scan."""
    from platform_aware_scheduling_tpu_torch.models.fused import FusedRequests
    from platform_aware_scheduling_tpu_torch.ops import cuda_fused
    from platform_aware_scheduling_tpu_torch.ops.binpack import BinpackNodeState

    n, c, r, t = 3, 2, 2, 2
    gas = BinpackNodeState(
        torch.zeros((n, c, r), dtype=torch.int64), torch.ones((n, r), dtype=torch.int64),
        torch.ones((n, r), dtype=torch.bool), torch.ones((n, c), dtype=torch.bool),
        torch.ones((n, c), dtype=torch.bool), torch.zeros((n, c), dtype=torch.int32),
    )
    requests = FusedRequests(
        torch.ones((t, 1, r), dtype=torch.int64), torch.ones((t, 1, r), dtype=torch.bool),
        torch.ones((t, 1), dtype=torch.int32), torch.ones((t, 1), dtype=torch.bool),
    )
    launches = cuda_fused.fused_schedule_cuda.LAUNCHES
    with pytest.raises(ValueError, match="not cuda"):
        cuda_fused.fused_schedule_cuda(
            torch.zeros((2, n), dtype=torch.int64), torch.ones((2, n), dtype=torch.bool),
            torch.ones(n, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
            torch.ones((t, n), dtype=torch.bool), gas, requests, 1,
        )
    assert cuda_fused.fused_schedule_cuda.LAUNCHES == launches
