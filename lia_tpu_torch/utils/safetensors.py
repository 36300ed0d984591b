"""A reader and writer of the safetensors format, with torch alone.

The format: an 8-byte little-endian header length n, n bytes of a JSON header
(padded with spaces), then the tensors' raw bytes. The header maps each name
to ``{"dtype", "shape", "data_offsets": [begin, end]}``, offsets into the byte
buffer after the header; an optional ``__metadata__`` entry maps strings to
strings. Hugging Face checkpoints and the JAX package's ``save_params`` write
this format; the port reads and writes it itself, so neither the
``safetensors`` package nor ``transformers`` is needed where the port runs.

- :func:`load_file` maps the file (``mmap``, copy-on-write) and builds each
  tensor over the mapping with ``torch.frombuffer``: nothing is read until a
  tensor's pages are touched, so a 14 GB shard never passes through Python
  bytes. The tensors lie on the CPU; the caller places them.
- :func:`save_file` writes tensors (any device) in order of decreasing element
  size, so every tensor's bytes start aligned to its element, as the
  ``safetensors`` package lays them out.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Optional, Tuple

import torch

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I8": torch.int8,
    "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}
NAMES = {dt: name for name, dt in DTYPES.items()}
METADATA = "__metadata__"


def read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """The header's tensor entries (``__metadata__`` left out) and the byte
    offset of the data buffer in the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop(METADATA, None)
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, as CPU tensors over a mapping of it (pages
    are read when touched; writing to a tensor changes neither the file nor
    the other tensors' bytes: the mapping is copy-on-write)."""
    header, base = read_header(path)
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else b""
    out = {}
    for name, e in header.items():
        if e["dtype"] not in DTYPES:
            raise TypeError(f"{path}: tensor {name!r} has dtype {e['dtype']}, which the port does not read")
        dt, shape = DTYPES[e["dtype"]], tuple(e["shape"])
        begin, end = e["data_offsets"]
        count = 1
        for d in shape:
            count *= d
        if end - begin != count * dt.itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} has {end - begin} bytes for shape {list(shape)} "
                             f"of {e['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dt)
        elif (base + begin) % dt.itemsize:  # a misaligned tensor (not one this module writes): copied
            out[name] = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=base + begin
                                         ).clone().view(dt).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dt, count=count, offset=base + begin).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` to ``path``: names in order of decreasing element
    size, then name; with ``metadata`` a ``__metadata__`` entry (strings)."""
    for name, t in tensors.items():
        if t.dtype not in NAMES:
            raise TypeError(f"tensor {name!r}: the format holds {sorted(NAMES.values(), key=str)}, not {t.dtype}")
    order = sorted(tensors, key=lambda k: (-tensors[k].dtype.itemsize, k))
    header: Dict[str, object] = {}
    if metadata:
        header[METADATA] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.dtype.itemsize
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data buffer starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                f.write(t.to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().data)
