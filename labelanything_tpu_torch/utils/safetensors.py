"""A reader and writer of the safetensors file format (the port's own; the
JAX package uses the ``safetensors`` package, ``preprocess.py:save_st``).

A file is an 8-byte little-endian header length, a JSON header, padded
with spaces to a multiple of 8 bytes, then the raw little-endian buffers.
The header maps each name to ``{"dtype", "shape", "data_offsets"}``
(offsets into the buffers), plus an optional ``"__metadata__"`` map of
strings. The writer lays the buffers out as the ``safetensors`` package
does (the wider dtypes first, then by name, the header written compact), so
a file it writes is byte for byte the package's. Dtypes: F32, F16, BF16,
I64, I32, U8 and BOOL.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

Array = Union[torch.Tensor, np.ndarray]

# the format's dtype names, in the order the format sorts them (ascending)
_TORCH = {"BOOL": torch.bool, "U8": torch.uint8, "F16": torch.float16,
          "BF16": torch.bfloat16, "I32": torch.int32, "F32": torch.float32,
          "I64": torch.int64}
_RANK = {name: i for i, name in enumerate(_TORCH)}
_NAMES = {dtype: name for name, dtype in _TORCH.items()}


def _as_tensor(value: Array) -> torch.Tensor:
    """A contiguous CPU tensor of ``value``: a strided view is copied into
    its logical order first, never written as its raw buffer (the
    ``save_st`` rule of the JAX package's ``preprocess.py``)."""
    if isinstance(value, np.ndarray):
        value = np.require(value, requirements="C")   # keeps 0-d arrays
        if value.dtype.byteorder == ">":
            value = value.astype(value.dtype.newbyteorder("<"))
        value = torch.from_numpy(value)
    return value.detach().cpu().contiguous()


def _buffer(t: torch.Tensor) -> bytes:
    if t.numel() == 0:
        return b""
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def save_file(tensors: Dict[str, Array], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (tensors or numpy arrays) to ``path``."""
    items = []
    for name, value in tensors.items():
        t = _as_tensor(value)
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} is not one of "
                            f"{sorted(_TORCH)}")
        items.append((name, _NAMES[t.dtype], t))
    items.sort(key=lambda item: (-_RANK[item[1]], item[0]))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset, buffers = 0, []
    for name, dtype, t in items:
        data = _buffer(t)
        header[name] = {"dtype": dtype, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
        buffers.append(data)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(text)))
        fh.write(text)
        for data in buffers:
            fh.write(data)


def read_header(path: str) -> Dict[str, Any]:
    """The JSON header of a file: entries by name, and ``__metadata__``."""
    with open(path, "rb") as fh:
        (length,) = struct.unpack("<Q", fh.read(8))
        return json.loads(fh.read(length))


def load_file(path: str, device: Union[str, torch.device] = "cpu"
              ) -> Dict[str, torch.Tensor]:
    """Every tensor of ``path``, in its dtype, on ``device`` (the CPU
    unless named)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    (length,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + length])
    body = memoryview(raw)[8 + length:]
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        if entry["dtype"] not in _TORCH:
            raise TypeError(f"{name}: dtype {entry['dtype']} is not one of "
                            f"{sorted(_TORCH)}")
        begin, end = entry["data_offsets"]
        dtype = _TORCH[entry["dtype"]]
        if end > begin:
            t = torch.frombuffer(bytearray(body[begin:end]),
                                 dtype=torch.uint8).view(dtype)
        else:
            t = torch.empty(0, dtype=dtype)
        if t.numel() != int(np.prod(entry["shape"], dtype=np.int64)):
            raise ValueError(f"{name}: {end - begin} bytes do not hold "
                             f"{entry['dtype']} {entry['shape']}")
        out[name] = t.reshape(entry["shape"]).to(device)
    return out
