"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded
with ``ctypes``.  Nothing here includes PyTorch's headers, so a build
takes seconds instead of the minutes ``torch.utils.cpp_extension.load``
needs.  Libraries land in ``build/kernels/`` at the root of the checkout,
named by a digest of their source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source builds anew and an unchanged one is
loaded from disk.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:meth:`Kernel.launch` raises on anything but 0.  A launch also applies
the port's numerics policy (``core/dtype.ensure_policy``), so the library
calls around the kernels (cuDNN's conv backward, cuBLAS) run under it
whatever the entry point.  A refused launch (too
many threads, too much shared memory) never runs and a later
``torch.cuda.synchronize()`` would not report it."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from paddle_tpu_torch.core.dtype import ensure_policy

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler of the toolkit PyTorch finds (``$CUDA_HOME``,
    ``nvcc`` on PATH, or the default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the port's CUDA kernels are built at "
                           "first use")
    return str(nvcc)


def sources() -> list[str]:
    """Names of every kernel source in ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Built library of ``csrc/<name>.cu``, keyed by the source, every
    shared header (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together.  Returns
    {name: library path}; raises with the compiler's output on failure."""
    names = sources() if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])  # atomic: a reader sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def ptxas_report(names=None) -> str:
    """Compile the named sources (default: all) once more with ``-Xptxas
    -v`` into a scratch directory and return what ptxas says of each
    kernel: registers, spill stores and loads, shared memory.  The
    libraries in ``BUILD_DIR`` are neither read nor written."""
    import tempfile

    names = sources() if names is None else list(names)
    nvcc = nvcc_path()
    out = []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = [(n, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"{n}.so"), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for n in names]
        for n, proc in procs:
            log, _ = proc.communicate()
            out.append(f"== {n}.cu (exit {proc.returncode})\n{log}")
    return "\n".join(out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` goes up by one each time the kernel is launched and
    nowhere else, so a caller can show that a path went through it."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source, self.symbol, self.argtypes = source, symbol, argtypes
        self.launches = 0
        self._fn = None
        self._err = None

    def _resolve(self):
        lib = load(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        err = lib.kernel_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        self._err, self._fn = err, fn
        return fn

    def launch(self, *args) -> None:
        ensure_policy()
        code = (self._fn or self._resolve())(*args)
        if code != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {code} "
                               f"({self._err(code).decode()})")
        self.launches += 1

    def launch_on(self, index: int, *args) -> None:
        """Launch on card ``index``, the card the tensors lie on: that
        card's current stream is passed as the last argument, and the
        launch runs with that card current (a device guard only where
        another card is current, so one card pays nothing).  Every
        wrapper under ``ops/kernels/`` launches through here."""
        stream = torch._C._cuda_getCurrentRawStream(index)
        if torch._C._cuda_getDevice() == index:
            self.launch(*args, stream)
        else:
            with torch.cuda.device(index):
                self.launch(*args, stream)


if __name__ == "__main__":
    import sys

    # python -m paddle_tpu_torch.ops.kernels._build [source ...]: the
    # registers, spills and shared memory of every kernel of the sources
    print(ptxas_report(sys.argv[1:] or None))
