"""The port's one device probe and kernel build.

Counterpart of the reference's ``kernels/platform.py``.  There the
question is "pallas, interpret or xla?"; here it is simpler, because the
route follows the tensor: a CUDA tensor launches the hand-written kernel,
a CPU tensor takes the plain PyTorch version, and nothing else happens.
What this module owns:

  * :func:`resolve_device` — the entry points' device check: asking for
    ``cuda`` on a machine without one raises, as the reference raises for
    ``pallas`` off-TPU; ``cpu`` must be asked for explicitly.
  * :func:`library` — the CUDA kernels, compiled from ``csrc/*.cu`` with
    ``nvcc`` for ``sm_90a`` at first use into ``build/kernels/`` at the
    repository root, one shared library per source, loaded with ctypes.
    :func:`build` compiles every source at once, one ``nvcc`` each, all
    started together.  A library's file name carries a hash of its
    source and of the shared headers (``csrc/*.cuh``), so an edit to
    either is rebuilt.
  * ``LAUNCHES`` — one plain integer per kernel, raised by its wrapper
    each time it launches the kernel (and nowhere else).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("quant_block", "fused_dequant_reduce_quant", "dequant_matmul")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"quantize_blockwise": 0,
                            "dequantize_blockwise": 0,
                            "quantize_reordered": 0,
                            "dequant_reduce_quant": 0,
                            "dequant_reduce": 0,
                            "dequant_matmul": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for and
    absent (no silent CPU fallback: a CPU run is never a card number)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all in
    parallel.  Returns {name: compiler output} for the sources compiled
    (ptxas register and spill report included); raises on any failure."""
    todo = [n for n in names if not _lib_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first
    use), with ``signatures`` ({function: argtypes}, each returning a CUDA
    error code) declared.  Only a CUDA tensor's wrapper calls this."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            for fn, args in signatures.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error (a refused launch
    never runs, and no later synchronize would report it)."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels' vector loads
    need both); copies only when it is not."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
