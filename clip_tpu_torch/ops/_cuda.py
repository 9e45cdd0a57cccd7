"""Build and bind the hand-written CUDA kernels of ``clip_tpu_torch/csrc``.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links the objects into a shared library
with a plain C interface (no PyTorch headers), which ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o <obj>/attention.o csrc/attention.cu      # one per source
    nvcc -shared -o _build/libclip_tpu_torch_kernels.so <obj>/*.o

The build runs at first use into ``clip_tpu_torch/_build/`` and again
whenever the sources' hash changes.  A failed build raises; nothing falls
back to the plain PyTorch versions.  Each C entry returns
``cudaGetLastError()`` after its launch, and :func:`check` raises on a
nonzero code.
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
from dataclasses import dataclass
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libclip_tpu_torch_kernels.so"
NVCC_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (pointers and the stream as void*)
_SIGNATURES = {
    "ctt_lnq": (_P, _P, _P, _P, _P, _I, _I, _F, _P),
    "ctt_requant": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "ctt_gemm_i8": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "ctt_gemm_i8_smem": (_I,),
    "ctt_gemm_gq": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ctt_gemm_gq_info": (_I, _I, _P),
    "ctt_attention": (_P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "ctt_attention_i8": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "ctt_qmatmul": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


@dataclass
class BuildInfo:
    seconds: float        # wall time of the nvcc calls; 0.0 when the library was reused
    ptxas: str            # -Xptxas -v register / spill summary
    nvcc_calls: int = 0   # one per source, side by side, and the link


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _ptxas_summary(stderr: str) -> str:
    keep = [ln.strip() for ln in stderr.splitlines()
            if "Compiling entry function" in ln or "Used " in ln or "spill" in ln
            or "wgmma" in ln]
    return "\n".join(keep)


def _run_all(cmds: list[list[str]], timeout: float) -> list[subprocess.CompletedProcess]:
    """Run the commands side by side; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    deadline = time.monotonic() + timeout
    done = []
    try:
        for cmd, p in zip(cmds, procs):
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on {cmd[-1]}:\n{err[-8000:]}")
            done.append(subprocess.CompletedProcess(cmd, p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


def build(force: bool = False) -> BuildInfo:
    """Compile the kernels if the library is missing or stale; return what
    the build did."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = _source_hash()
    if not force and lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return BuildInfo(0.0, "")
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC"]
    t0 = time.perf_counter()
    # objects and the library go to temporary names, and the library is
    # renamed into place, so that a concurrent process never loads a
    # half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [str(Path(objdir) / f"{src.stem}.o") for src in _sources()]
        compiled = _run_all([[nvcc, *flags, "-Xptxas", "-v", "-c", "-o", obj, str(src)]
                             for src, obj in zip(_sources(), objs)], NVCC_TIMEOUT_S)
        tmp = str(Path(objdir) / LIB_NAME)
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]], NVCC_TIMEOUT_S)
        os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return BuildInfo(time.perf_counter() - t0,
                     "\n".join(_ptxas_summary(r.stderr) for r in compiled), len(objs) + 1)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            cdll = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = cdll
        return _lib


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on the device of ``t``, as a handle."""
    if t.device.index is not None and t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device``: the kernels take nothing else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
