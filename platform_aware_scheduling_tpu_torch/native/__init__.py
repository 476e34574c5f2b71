"""The port's native wire extension, ``_wirec_torch``: built at first use.

``wirec.c`` beside this file is compiled by the host C compiler (``cc``,
or ``$CC``) against the running interpreter's headers into
``build/native/`` at the root of the checkout, the directory the CUDA
kernels' builds sit beside.  The artifact is named by the SHA-256 of the
source and the interpreter's ``SOABI``, so a changed source, or another
interpreter sharing the checkout, builds anew and never loads a foreign
binary.  Several processes may build at once (the test workers do): each
compiles to a tmp file of its own and ``os.replace`` installs it.

``get_wirec()`` returns the module, or None where no compiler exists or
the build fails (the compiler's stderr is printed).  The verbs then serve
every request on the exact Python path, byte for byte the same.  Two
environment variables, named as the JAX package names them:

  * ``PAS_TPU_NO_NATIVE=1`` forces the exact paths (``get_wirec()`` is
    None), for the test matrix and an operator's kill switch;
  * ``PAS_TPU_WIREC_SO=<path>`` loads exactly that artifact, bypassing the
    hash gate (an instrumented build, for example); a failure to load it
    raises instead of degrading.

Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path

MODULE = "_wirec_torch"
SOURCE = Path(__file__).resolve().parent / "wirec.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_loaded = False
_module = None


def so_path() -> Path:
    """Where ``wirec.c`` builds to: named by the source's SHA-256 and the
    interpreter's ABI."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    soabi = sysconfig.get_config_var("SOABI") or "unknown-abi"
    return BUILD_DIR / f"{MODULE}-{digest}-{soabi}.so"


def _build(path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    include = sysconfig.get_paths()["include"]
    cmd = [os.environ.get("CC", "cc"), "-O2", "-fPIC", "-shared", f"-I{include}", str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return False
    if proc.returncode != 0:
        print(f"{MODULE} build failed:\n{proc.stderr}", file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)
    _remove_stale(path)
    return True


def _remove_stale(keep: Path) -> None:
    """Drop artifacts of older sources and tmp files that crashed builds
    left (older than a build's timeout, so never a running build's)."""
    now = time.time()
    for entry in BUILD_DIR.glob(f"{MODULE}-*"):
        try:
            stale = entry.suffix == ".so" and entry != keep
            orphan = entry.suffix == ".tmp" and now - entry.stat().st_mtime > BUILD_TIMEOUT_S
            if stale or orphan:
                entry.unlink()
        except OSError:
            pass


def _load(path) -> object:
    spec = importlib.util.spec_from_file_location(MODULE, str(path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def get_wirec():
    """The ``_wirec_torch`` module, or None when it is switched off or
    cannot be built (see the module doc)."""
    global _loaded, _module
    if os.environ.get("PAS_TPU_NO_NATIVE") == "1":
        return None
    if _loaded:
        return _module
    with _lock:
        if _loaded:
            return _module
        override = os.environ.get("PAS_TPU_WIREC_SO")
        if override:
            module = _load(override)  # an explicit artifact must load or raise
        else:
            module = None
            try:
                path = so_path()
                if path.is_file() or _build(path):
                    module = _load(path)
            except (OSError, ImportError) as exc:
                print(f"{MODULE} unavailable: {exc}", file=sys.stderr)
        _module = module
        _loaded = True
        return _module
