"""Build and load the port's hand-written CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded with
``ctypes``.  Libraries go to ``build/repro_torch/`` at the root of the
checkout, named by a hash of the source, the shared headers (``*.cuh``) and
the flags, so an edited kernel is rebuilt and an unchanged one is reused.  Nothing is built when the package
is imported: the first launch builds what it needs, and ``build_all()``
builds every kernel at once (one ``nvcc`` per source, all started together).

``-fmad=false`` keeps the compiler from contracting a multiply and an add
into one rounding: the kernels reproduce the JAX reference's float
operations one by one, and their results are held bitwise against it.  The
attention and SSD kernels, held to a tolerance, ask for their fused
multiply-adds explicitly (``fmaf``), which the flag leaves alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "MAX_SMEM_BYTES", "KernelError",
           "library", "build_all", "capturing", "check_launch", "check_ports",
           "check_tensor"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
#: build directory at the checkout root (``src/repro_torch`` -> ``.``)
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
SOURCES = ("xbar", "netsim", "islip", "parser", "quant_pack", "flash_attention",
           "ssd", "switch_loop", "ring_scan")
#: dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelError(RuntimeError):
    """A kernel failed to build or to launch: a fault of the machine or of
    the port, never of a request (the DSE service lets it through)."""


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                      "kernels are built on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # sources include them
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start one nvcc; returns (process, temporary output, final path, log)."""
    out = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, log


def _finish(name: str, proc, tmp: Path, out: Path, log: Path) -> None:
    text, _ = proc.communicate()
    log.write_text(text)
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{text[-4000:]}")
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or none


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, in parallel, and
    return the library paths.  Raises if any build fails."""
    started = {n: _start(n) for n in names if not _target(n).exists()}
    errors = []
    for n, job in started.items():
        try:
            _finish(n, *job)
        except KernelError as e:
            errors.append(str(e))
    if errors:
        raise KernelError("\n".join(errors))
    return {n: _target(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def check_launch(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (0 is success)."""
    if code != 0:
        raise KernelError(f"{what}: CUDA launch failed with error {code}")


def check_tensor(x: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``x`` has the device, dtype and shape a kernel takes and
    is contiguous (the kernels index raw pointers)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def capturing(x: torch.Tensor) -> bool:
    """Whether ``x`` is a CUDA tensor and the current stream is being
    captured into a CUDA graph, where a device-to-host copy is not allowed."""
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


def check_ports(src: torch.Tensor, dst: torch.Tensor, n_ports: int) -> None:
    """Raise unless every port id in ``src`` and ``dst`` lies in
    [0, n_ports).  The four extrema come back in one device-to-host copy,
    which a graph capture forbids: while capturing, the check is left to
    the uncaptured call that precedes a capture on the same inputs."""
    if capturing(src):
        return
    ext = torch.stack([*torch.aminmax(src), *torch.aminmax(dst)])
    lo_s, hi_s, lo_d, hi_d = ext.tolist()
    lo, hi = min(lo_s, lo_d), max(hi_s, hi_d)
    if lo < 0 or hi >= n_ports:
        raise ValueError(f"port ids must lie in [0, {n_ports}), got [{lo}, {hi}]")
