"""Device resolution, and the build and launch of the package's CUDA kernels.

Kernels live in ``csrc/*.cu`` with a plain C interface. At first use each
source is compiled by ``nvcc`` for ``sm_90a`` into a shared library in
``_build/`` beside this package (git-ignored), named by a digest of the
source, the shared headers (``csrc/*.cuh``) and the flags so an edited
source rebuilds, and loaded with
``ctypes``. One ``nvcc`` process per source, all started together
(:func:`build_kernels`). Every C entry point returns
``cudaGetLastError()`` after its launch; :meth:`CudaKernel.launch` raises
if that is not 0, and counts the launch only when it succeeded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
#: ``-fno-gnu-unique``: a function-local static of a header's template
#: stays one per library (as GNU-unique symbols it would be one per
#: process, shared by every library built from the same header)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC,-fno-gnu-unique",
              "-lineinfo")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``cuda``. Never falls back to the CPU silently: with no CUDA device
    the caller must ask for ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return torch.device("cuda")


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def library_path(source: str) -> pathlib.Path:
    """The built library of ``source``, named by a digest of the source,
    every shared header (``csrc/*.cuh``) and the flags."""
    src = CSRC / source
    data = src.read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        data + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_kernels(sources: Optional[Iterable[str]] = None,
                  verbose: bool = False) -> Dict[str, pathlib.Path]:
    """Compile every listed ``csrc`` source (default: all ``*.cu``) that
    is not built yet, one ``nvcc`` per source, all in parallel. Returns
    ``{source: library path}``; raises with the compiler's output if any
    build fails. ``verbose`` adds ``-Xptxas -v`` and prints ptxas's
    register, shared-memory and spill report of each new build."""
    names = sorted(sources) if sources is not None else sorted(
        p.name for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    procs = []
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose
                                           else ()),
               "-o", tmp, str(CSRC / n)]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {n} failed ({proc.returncode}):\n{log}")
            os.unlink(tmp)
            continue
        if verbose and log:
            print(f"[nvcc {n}]\n{log}", flush=True)
        os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load_library(source: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = build_kernels([source])[source]
            lib = _LIBS[source] = ctypes.CDLL(str(path))
        return lib


class CudaKernel:
    """One hand-written kernel: its C entry point in ``csrc/<source>``,
    the TPU kernel it replaces, and the count of its launches."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load_library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"kernel {self.name} ({self.symbol}) failed to launch: "
                f"cudaError {err}")
        self.launches += 1


#: every kernel of the package, by name (filled as the ops modules load)
KERNELS: Dict[str, CudaKernel] = {}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


#: streaming multiprocessors of the H100, which the kernels' grids are
#: planned for
SMS = 132

#: split-K and split-KV counters by (device, stream), shared by every
#: kernel whose last block of a tile combines the splits: launches on one
#: stream run in order, so no two launches in flight share a counter
_COUNTERS: Dict[tuple, torch.Tensor] = {}


def split_counters(device, need: int) -> torch.Tensor:
    """At least ``need`` zeroed int32 counters of the current stream on
    ``device`` (zeroed once per device and stream; the kernels' last block
    of each tile resets its counter to 0)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < need:
        counters = _COUNTERS[key] = torch.zeros(
            max(need, 4096), dtype=torch.int32, device=device)
    return counters


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def aligned16(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` if its data starts on a 16-byte boundary (as every fresh
    allocation does), else a copy that does: the tensor-core kernels'
    bulk and tensor-map copies read whole 16-byte units, and a view at an
    odd offset must not send a call to another kernel."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


#: ctypes argument types, by role
P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

#: dtype codes the C entry points take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
