"""Build and load the CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, and loaded with
``ctypes``: no PyTorch headers are compiled, so a build takes seconds.
The libraries land in ``kernels/build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing is built at import time:
the first kernel launch builds every source at once, one ``nvcc`` each,
all started together. The build runs under an exclusive file lock in
``kernels/build/`` and checks its targets again once it holds it, so
processes that start together on a cold directory (the serving fleet's
workers) run ``nvcc`` once between them: the first builds, the others
wait and load its libraries, and ``builds`` counts only in the process
that built.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from chandy_lamport_tpu_torch.utils.filelock import locked

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
SOURCES = ("segment", "queue", "megatick")
# -split-compile=0: nvcc splits each module's optimisation over every
# core (megatick.cu's 24 instantiations build in ~26 s, not ~78)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-split-compile=0", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}
build_seconds = None   # wall time of the one build, once it has run
builds = 0             # nvcc runs made in this process (utils/guards)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cuda):
        return cuda
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
        "kernels of chandy_lamport_tpu_torch build on the machine that "
        "has the card")


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _build_all() -> None:
    """Compile every missing library in parallel, under the build
    directory's exclusive lock (module docstring); raise with nvcc's
    output if any compile fails."""
    global build_seconds, builds
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with locked(os.path.join(BUILD_DIR, "nvcc")):
        missing = [n for n in SOURCES if not os.path.exists(_target(n))]
        nvcc = _nvcc() if missing else None
        procs = []
        for name in missing:
            out = _target(name)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            builds += 1
        failures = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            else:
                os.replace(tmp, out)   # atomic: no reader sees half a file
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    build_seconds = time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all sources on
    first use."""
    with _lock:
        if name not in _libs:
            if not all(os.path.exists(_target(n)) for n in SOURCES):
                _build_all()
            for n in SOURCES:
                _libs[n] = ctypes.CDLL(_target(n))
        return _libs[name]


def check(code: int, kernel: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {code}")


def stream_ptr(tensor) -> int:
    """PyTorch's current CUDA stream on the tensor's device, as the raw
    ``cudaStream_t`` (the call PyTorch's own generated kernels launch
    with; ``torch.cuda.current_stream`` builds a Stream object each time,
    several microseconds of host time per launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(tensor.get_device())
