"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library, loaded with ``ctypes``; the headers beside the
sources (``*.cuh``) are shared between them.  Libraries land in
``build/torch_kernels/`` at the root of the checkout (``.gitignore`` lists
``build/``), keyed by a hash of the sources and flags, so the first CUDA use
in a fresh checkout builds them and later uses load them.  Nothing here runs
at import time: the CPU-only test machines import this module and never
build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "LIBRARIES", "build", "load", "find_nvcc", "bind",
           "check_operands", "launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

#: every library of ``csrc/``: the optimizer passes, the compressed-gossip
#: passes, the flash and paged-decode attention kernels, and the Mamba-2 SSD
#: scan
LIBRARIES = ("qg_update", "compress", "attention", "ssd_scan")

#: sm_90a keeps Hopper's wgmma/setmaxnreg available to later kernels;
#: -fmad=false keeps nvcc from contracting a*b + c into an FMA, so the
#: kernels round every step as the plain PyTorch versions do; -Xptxas -v
#: records registers and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of repro_torch are built "
        "on first use and need the CUDA toolkit; on a machine without it, "
        "run on the CPU with device='cpu'")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")) + sorted(CSRC.glob("*.h")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, float]:
    """Compile ``csrc/<name>.cu`` for each name not yet built, one ``nvcc``
    per source, all started together.  Returns ``{name: seconds}`` for the
    libraries compiled now (0.0 for those found built).  The compiler's
    output (ptxas register and spill counts) goes to ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    seconds = {}
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            seconds[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        log = open(lib.with_suffix(".log"), "w")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        pending[name] = (proc, lib, tmp, log, time.perf_counter())
    try:
        for name, (proc, lib, tmp, log, t0) in pending.items():
            rc = proc.wait()
            log.close()
            seconds[name] = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed ({rc}) building {name}: see "
                    f"{lib.with_suffix('.log')}\n"
                    + lib.with_suffix(".log").read_text()[-4000:])
            os.replace(tmp, lib)  # atomic: a concurrent builder sees all
    finally:
        for proc, _, _, log, _ in pending.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return seconds


def load(name: str) -> ctypes.CDLL:
    """A ``ctypes`` handle of ``csrc/<name>.cu``, building it first if this
    checkout has not built these sources yet (callers keep the handle)."""
    build(name)
    return ctypes.CDLL(str(_library_path(name)))


def bind(name: str, signatures: dict, error_fn: str) -> ctypes.CDLL:
    """:func:`load` ``name`` and type each C function of ``signatures``
    (``{fn: argtypes}``, all returning an int error code) and the library's
    ``error_fn(int) -> const char*``."""
    lib = load(name)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    getattr(lib, error_fn).argtypes = [ctypes.c_int]
    getattr(lib, error_fn).restype = ctypes.c_char_p
    return lib


def check_operands(kernel: str, streams: dict, scalars: dict | None = None,
                   *, scalar_len: int = 1) -> torch.device:
    """Raise unless every stream operand is a contiguous fp32 CUDA tensor of
    one length on one device, and every scalar operand one of
    ``scalar_len`` elements there too (an lr, or one value per row)."""
    scalars = scalars or {}
    first = next(iter(streams.values()))
    dev, n = first.device, first.numel()
    for arg, t in {**streams, **scalars}.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{kernel}: {arg} must be a CUDA tensor (CPU "
                             "tensors go through kernels.ops)")
        if t.device != dev:
            raise ValueError(f"{kernel}: {arg} is on {t.device}, not {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {arg} must be contiguous")
        want = scalar_len if arg in scalars else n
        if t.numel() != want:
            raise ValueError(f"{kernel}: {arg} has {t.numel()} elements, "
                             f"want {want}")
    return dev


def launch(lib: ctypes.CDLL, error_fn: str, counts: dict, kernel: str,
           fn: str, dev: torch.device, *args) -> None:
    """Call ``lib.fn(*args, stream)`` on ``dev``'s current stream, raise on
    a non-zero CUDA error code, and count one launch of ``kernel``."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed: "
                           f"{getattr(lib, error_fn)(rc).decode()} ({rc})")
    counts[kernel] += 1
