"""Build and load the port's CUDA kernels.

Each ``ray_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into a shared
library with a plain C interface, which ``ctypes`` loads. The library goes
to ``ray_tpu_torch/_build/`` under a name keyed by a hash of its source,
every header in ``csrc/`` (``*.cuh``, which a source may include) and the
flags, so an edited source or header builds anew and an unchanged one is
built once. The libraries link nothing beyond the CUDA runtime: the TMA's
tensor-map encoder comes through the runtime's entry-point query.
Nothing here runs at import: the first launch builds, or a caller builds
every source at once, in parallel, with :func:`build_all`. Processes that
build at once (the runtime's workers, say) take turns on a lock file in
the build directory, so a library is compiled once and never read half
written.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch

from ray_tpu_torch._private.build_dir import exclusive_build_dir

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str] = ()) -> Dict[str, Path]:
    """Build the named sources (all of ``csrc/*.cu`` by default), one
    ``nvcc`` each, all started together. Returns name -> library path; the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``.log``. Raises if any build fails."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    if all(library_path(name).exists() for name in names):
        return {name: library_path(name) for name in names}
    with exclusive_build_dir(BUILD_DIR):
        return _build_locked(names)


def _build_locked(names: List[str]) -> Dict[str, Path]:
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed: List[str] = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            lib.rtt_error_string.argtypes = [ctypes.c_int]
            lib.rtt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


class Kernel:
    """One C entry point of a csrc library, with a count of its launches.

    Calling it launches the kernel on the current CUDA device and stream
    (the caller passes ``torch.cuda.current_stream().cuda_stream``) and
    raises if the launch was refused. ``launches`` grows by one for every
    launch and is touched nowhere else.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err:
            msg = load(self.source).rtt_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1


def stream_handle(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
