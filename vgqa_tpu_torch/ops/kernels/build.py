"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` (all started together), and the
objects link into one shared library with a plain C interface, loaded
through ``ctypes``. The build happens at first use, into
``csrc/build/`` (git-ignored), under a name keyed by the sources' hash, so
an edited source rebuilds and an unchanged one loads at once. Nothing here
runs at import time: the CPU tests import every module of the package on a
host without ``nvcc``. In a data-parallel group rank 0 builds while the
other ranks wait at a barrier, then every rank loads the library (a rank
that still finds no library, on a host that does not share rank 0's file
system, builds its own).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

from ...parallel.distributed import is_main_process, synchronize

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint

# argtypes of every C entry point in csrc/*.cu
_SIGNATURES = {
    "vgqa_window_attention_f32": [_P, _P, _P, _P, _I, _I, _I,
                                  _L, _L, _L, _L, _L, _L, _L, _L,
                                  _P, _P, _I, _P, _I, _F, _P],
    "vgqa_window_attention_sm90": [_P, _P, _P, _P, _I, _I, _I,
                                   _L, _L, _L, _L, _L, _L, _L, _L,
                                   _P, _I, _P, _L, _P, _I, _F, _P],
    "vgqa_ln_rows": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _F, _P],
    "vgqa_gemm_sm90": [_P, _L, _P, _P, _L, _P, _P, _L, _I, _I, _I, _I,
                       _P, _L, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P],
    "vgqa_gemm_sm90_tiles": [_P, _I],
    "vgqa_gemm_sm90_smem_bytes": [_I, _I, _I, _I, _I, _I],
    "vgqa_gemm_sm90_smem_max": [_I],
    "vgqa_flash_train_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _U, _I, _F,
                             _P],
    "vgqa_flash_train_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _F, _I, _F, _P],
    "vgqa_flash_mha": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
    "vgqa_flash_gqa_causal": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
    "vgqa_int4_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}
# the float32 forms take the arguments of their bf16 counterparts
_SIGNATURES.update({f32: _SIGNATURES[bf16] for f32, bf16 in (
    ("vgqa_ln_rows_f32", "vgqa_ln_rows"),
    ("vgqa_gemm_sm90_f32", "vgqa_gemm_sm90"),
    ("vgqa_flash_train_fwd_f32", "vgqa_flash_train_fwd"),
    ("vgqa_flash_train_bwd_f32", "vgqa_flash_train_bwd"))})

_lib: Optional[ctypes.CDLL] = None
build_log = {"seconds": 0.0, "ptxas": "", "path": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                           "or set CUDA_HOME")
    return path


def _arch_flag() -> str:
    import torch

    major, minor = torch.cuda.get_device_capability()
    # sm_90a: the Hopper target that also admits wgmma/setmaxnreg
    cc = f"{major}{minor}" + ("a" if (major, minor) == (9, 0) else "")
    return f"arch=compute_{cc},code=sm_{cc}"


def _compile(sources, arch: str, path: str) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    tmp = f"{path}.{os.getpid()}.tmp"
    flags = ["-gencode", arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        if src.endswith(".cu"):
            obj = f"{tmp}.{os.path.basename(src)}.o"
            jobs.append((obj, subprocess.Popen(
                [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {obj}:\n{err}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run([_nvcc(), *flags, "-shared", "-o", tmp,
                               *[obj for obj, _ in jobs]], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing
    build_log.update(seconds=time.perf_counter() - t0, ptxas="".join(logs))


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                     + glob.glob(os.path.join(_CSRC, "*.cuh")))
    arch = _arch_flag()
    h = hashlib.sha256(arch.encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libvgqa_kernels_{h.hexdigest()[:16]}.so")
    if is_main_process() and not os.path.exists(path):
        _compile(sources, arch, path)
    synchronize()
    if not os.path.exists(path):
        _compile(sources, arch, path)
    build_log["path"] = path
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor, or None (NULL) for a missing operand."""
    return None if t is None else t.data_ptr()
