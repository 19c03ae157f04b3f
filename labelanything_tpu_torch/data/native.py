"""The host library of the images path: ``csrc/jpeg_decode.c`` (JPEG
decoding, ``data/jpeg.py``), ``csrc/png_unfilter.c`` (PNG's row filters,
``data/png.py``) and ``csrc/resample.c`` (PIL's BILINEAR resample,
``data/transforms.py``), compiled at first use with the system C
compiler (``$CC``, else ``cc``) into one shared library,
``build/host/host_<hash>.so`` at the repository root (``<hash>`` covers
the sources and the flags), and loaded with ``ctypes``, which releases the
GIL for each call. When the library cannot be built or loaded, the call
raises: no caller falls back to the numpy twins quietly. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
SOURCES = ("jpeg_decode.c", "png_unfilter.c", "resample.c")
BUILD_DIR = _PKG_DIR.parent / "build" / "host"
CFLAGS = ("-O2", "-shared", "-fPIC", "-std=c99")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.la_jpeg_info.argtypes = [p, l, p, p, i]
    lib.la_jpeg_info.restype = i
    lib.la_jpeg_decode.argtypes = [p, l, p, l, p, i]
    lib.la_jpeg_decode.restype = i
    # in h w c out oh ow xmin xk xks ymin yk yks tmp
    lib.la_resample_u8.argtypes = [p, i, i, i, p, i, i, p, p, i, p, p, i, p]
    lib.la_resample_u8.restype = i
    lib.la_png_unfilter.argtypes = [p, i, i, i, p]   # raw h rowbytes bpp out
    lib.la_png_unfilter.restype = i
    return lib


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the host library; raises
    RuntimeError when the compiler or the load fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(CFLAGS).encode())
        for name in SOURCES:
            h.update(name.encode())
            h.update((CSRC_DIR / name).read_bytes())
        target = BUILD_DIR / f"host_{h.hexdigest()[:16]}.so"
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [os.environ.get("CC", "cc"), *CFLAGS, "-o", str(tmp),
                   *(str(CSRC_DIR / s) for s in SOURCES)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"the host library could not be built: "
                                   f"{' '.join(cmd)}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"the host library could not be built "
                    f"({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        try:
            _lib = _declare(ctypes.CDLL(str(target)))
        except OSError as e:
            raise RuntimeError(f"the host library {target} could not be "
                               f"loaded: {e}") from e
        return _lib
