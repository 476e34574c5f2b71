"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  The library lands in ``build/torch_kernels/`` at the root
of the checkout, named by a hash of the source and the flags, so a changed
source or flag set builds anew and an unchanged one is reused.

Nothing here runs at import: the CPU path never looks for ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)
KERNELS = ("greedy_assign", "binpack", "forecast", "fused_schedule")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build kernels")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source
    and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _nvcc_command(nvcc: str, name: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together; return name -> library path."""
    paths = {name: library_path(name) for name in names}
    missing = {name: path for name, path in paths.items() if not path.is_file()}
    if not missing:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name, path in missing.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            _nvcc_command(nvcc, name, tmp),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        running.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in running:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            _loaded[name] = lib
        return lib
