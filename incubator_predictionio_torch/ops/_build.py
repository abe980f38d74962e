"""Build the CUDA sources under ``ops/csrc`` with ``nvcc`` and load them.

Each source becomes a shared library with a plain C interface, compiled for
``sm_90a`` at first use and loaded with ``ctypes``. Libraries are keyed by a
hash of the source and the flags, so an unchanged source is built once per
build directory. The build directory is ``PIO_TORCH_BUILD_DIR`` or
``build/torch_kernels`` at the root of the checkout (listed in
``.gitignore``). A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from ..common import envknobs

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: per library name: {"seconds": build seconds (0.0 when cached), "log": nvcc stderr}
build_info: dict[str, dict] = {}


def build_dir() -> Path:
    env = envknobs.env_str("PIO_TORCH_BUILD_DIR", "", lower=False)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def find_nvcc() -> str:
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` (as it is now) lives: keyed by
    a hash of the source and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        so = library_path(name)
        out_dir = so.parent
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = ""
        if not so.is_file():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                        f"{proc.stderr}")
                log = proc.stderr
                os.replace(tmp, so)  # atomic: concurrent builders agree
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log,
                            "path": str(so)}
        lib = ctypes.CDLL(str(so))
        _loaded[name] = lib
        return lib
