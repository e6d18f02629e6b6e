"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``build/repro_torch_kernels/<name>-<hash>.so`` at the root of the
checkout.  The hash covers the source, every header in ``csrc/`` and the
compiler flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing builds at import: the first launch on a CUDA tensor calls
:func:`load`, and :func:`build_all` compiles every source in parallel (one
``nvcc`` process each).  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "repro_torch_kernels"
SOURCES = ("tatp_matmul", "flash_attention", "flash_attention_bwd", "ssd",
           "ssd_bwd")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# compiler reports (register/shared-memory use from -Xptxas -v) by source
BUILD_LOG: dict[str, str] = {}
# the wall seconds each source's nvcc took (the builds run together)
BUILD_SECONDS: dict[str, float] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the CUDA
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on the PATH); the "
        "repro_torch kernels need the CUDA toolkit with sm_90a support"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path) -> tuple[subprocess.Popen, Path]:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp


def _finish(name: str, out: Path, proc, tmp: Path) -> None:
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source, all
    started together.  Returns the wall seconds the builds took."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(n, _lib_path(n)) for n in names]
    running = [
        (n, out, *_start(n, out)) for n, out in todo if not out.exists()
    ]
    errors = []

    def wait(n, out, proc, tmp):  # a thread each drains its compiler's pipe
        try:
            _finish(n, out, proc, tmp)
        except KernelBuildError as e:
            errors.append(str(e))
        BUILD_SECONDS[n] = time.perf_counter() - t0

    threads = [threading.Thread(target=wait, args=item) for item in running]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise KernelBuildError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        out = _lib_path(name)
        if not out.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(out))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
