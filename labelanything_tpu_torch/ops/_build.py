"""Build and load the package's CUDA kernels.

The sources under ``labelanything_tpu_torch/csrc/`` are compiled by ``nvcc``
for Hopper (``sm_90a``), one ``nvcc`` per source and all started together,
and linked into one shared library with a plain C interface,
``build/kernels/relpos_<hash>.so`` at the repository root, where ``<hash>``
covers the sources and the compiler flags. The library is built at first
use, loaded with ``ctypes`` and cached for the process. Nothing here runs
at import time.
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
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
SOURCES = ("relpos_global.cu", "relpos_window.cu", "relpos_global_bwd.cu",
           "relpos_window_bwd.cu", "relpos_packed.cu", "relpos_packed_sm90.cu",
           "relpos_packed_variants.cu", "fused_twoway.cu",
           "flash_attention.cu", "flash_wgmma.cu", "fused_window.cu",
           "relpos_global_int8.cu")
HEADERS = ("relpos_common.cuh", "relpos_mma.cuh", "relpos_bwd.cuh",
           "relpos_packed.cuh", "relpos_packed_sm90.cuh", "relpos_window.cuh",
           "sm90.cuh", "fused_twoway_fp32.cuh", "fused_twoway_tc.cuh")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when the library was
# already on disk) and the compiler's output (register / spill report)
build_seconds = 0.0
build_log = ""


def _cuda_home() -> Optional[str]:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            return os.environ[var]
    from torch.utils import cpp_extension

    return cpp_extension.CUDA_HOME


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = _cuda_home()
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc was not found (looked in $CUDA_HOME/bin and on PATH); the "
        "labelanything_tpu_torch CUDA kernels are compiled at first use and "
        "need the CUDA toolkit. CPU tensors use the plain PyTorch versions.")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    dims = [i, i, i, i, i, ctypes.c_float, i, p]  # b n heads kh kw scale bf16 stream
    for name in ("la_relpos_global", "la_relpos_window"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p] + dims            # qkv r out lse
        fn.restype = i
    for name in ("la_relpos_global_bwd", "la_relpos_window_bwd"):
        fn = getattr(lib, name)
        # qkv r out dout lse delta dqkv dr
        fn.argtypes = [p, p, p, p, p, p, p, p] + dims
        fn.restype = i
    # qkv r out; b n heads kh kw dh scale bf16 strides[9] stream
    packed = [p, p, p, i, i, i, i, i, i, ctypes.c_float, i,
              ctypes.POINTER(ctypes.c_longlong), p]
    for name in ("la_relpos_packed_global", "la_relpos_packed_global_wgmma",
                 "la_relpos_packed_window", "la_relpos_packed_onehot",
                 "la_relpos_packed_bf16exp"):
        fn = getattr(lib, name)
        fn.argtypes = packed
        fn.restype = i
    # keys queries key_pe params q_out k_out scratch; g s n d heads mlp depth
    # downsample bf16 stream
    lib.la_fused_twoway.argtypes = [p] * 7 + [i] * 9 + [p]
    lib.la_fused_twoway.restype = i
    # q k v out; batch heads nq nk dh scale bf16 strides[12] stream
    lib.la_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i,
                                       ctypes.c_float, i,
                                       ctypes.POINTER(ctypes.c_longlong), p]
    lib.la_flash_attention.restype = i
    # q k v out; batch heads nq nk dh scale strides[12] stream
    lib.la_flash_wgmma.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float,
                                   ctypes.POINTER(ctypes.c_longlong), p]
    lib.la_flash_wgmma.restype = i
    # x qkv r w_proj b_proj out; b hp wp heads dh ws qscale bf16
    # r_strides[3] stream
    lib.la_fused_window.argtypes = [p] * 6 + [i] * 6 + [
        ctypes.c_float, i, ctypes.POINTER(ctypes.c_longlong), p]
    lib.la_fused_window.restype = i
    # qkv r out; b n heads kh kw qscale bf16 stream
    lib.la_relpos_global_int8.argtypes = [p, p, p, i, i, i, i, i,
                                          ctypes.c_float, i, p]
    lib.la_relpos_global_int8.restype = i
    lib.la_error_string.argtypes = [i]
    lib.la_error_string.restype = ctypes.c_char_p
    return lib


def _run_all(commands) -> str:
    """Start every command at once, wait for all, return their output;
    raises if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(commands, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outputs)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"relpos_{_source_hash()}.so"
        if not target.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            objects = [tmp.with_suffix(f".{Path(s).stem}.o") for s in SOURCES]
            t0 = time.perf_counter()
            try:
                build_log = _run_all(
                    [[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o",
                      str(obj), str(CSRC_DIR / src)]
                     for src, obj in zip(SOURCES, objects)])
                build_log += _run_all(
                    [[nvcc, "-shared", "-o", str(tmp), *map(str, objects)]])
            finally:
                for obj in objects:
                    obj.unlink(missing_ok=True)
            build_seconds = time.perf_counter() - t0
            os.replace(tmp, target)
        _lib = _declare(ctypes.CDLL(str(target)))
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.la_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")
