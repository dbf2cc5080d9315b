"""Checkpoints in the JAX package's file format (port of
``repro/training/checkpoint.py``), byte for byte.

A file is one msgpack map ``{"step": int, "tree": {"a/b/c": {"dtype":
str, "shape": [int, ...], "data": bin}}}``: the keys in JAX's flatten
order (dict keys sorted; :func:`repro_torch.tree.leaves`), ``dtype`` the
numpy dtype string (``"<f4"``, ...) or ``"bfloat16"`` with the data as a
uint16 view.  So a JAX checkpoint restores into the port and a port
checkpoint into JAX.

The card machine has no ``msgpack``, so the port writes and reads the
format with a small codec of its own, for exactly the types this payload
uses (map, str, int, bin, array), each in msgpack's smallest encoding, as
``msgpack.packb(..., use_bin_type=True)`` chooses it.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, structure, unflatten

# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, lo in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                              (0xd2, ">i", -(1 << 31)),
                              (0xd3, ">q", -(1 << 63))):
            if n >= lo:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} does not fit a msgpack int")


def _pack_len(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The header of a str / bin / array / map of ``n`` items: the fix
    form below ``fix_max`` (``fix`` None: none), else the first of
    ``codes`` (code, format, bound) that holds ``n``."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack")


_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_BIN = ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32))
_ARRAY = ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))
_MAP = ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))


def _pack(obj, out: List) -> None:
    """Append ``obj``'s encoding to ``out`` as pieces (a large bin is
    appended as the buffer itself, not copied)."""
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"the checkpoint codec has no {type(obj).__name__}")
    if isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_pack_len(len(b), 0xa0, 32, _STR) + b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        out.append(_pack_len(n, None, 0, _BIN))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), 0x90, 16, _ARRAY))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_pack_len(len(obj), 0x80, 16, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"the checkpoint codec has no {type(obj).__name__}")


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self._map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.read() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return str(self.take(c & 0x1f), "utf-8")
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if c in ints:
            return self.unpack(ints[c])
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",
                0xd9: ">B", 0xda: ">H", 0xdb: ">I",
                0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}
        if c not in lens:
            raise ValueError(f"msgpack type 0x{c:02x} is not in the "
                             f"checkpoint format")
        n = self.unpack(lens[c])
        if c <= 0xc6:
            return self.take(n)                     # bin: a view, no copy
        if c <= 0xdb:
            return str(self.take(n), "utf-8")
        if c <= 0xdd:
            return [self.read() for _ in range(n)]
        return self._map(n)

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(buf) -> Any:
    """The object ``buf`` encodes; a bin comes back as a memoryview into
    ``buf``."""
    r = _Reader(buf)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         f"object")
    return obj


# ---------------------------------------------------------------------------
# arrays and trees
# ---------------------------------------------------------------------------

def _encode_array(t: torch.Tensor) -> Dict[str, Any]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return {"dtype": "bfloat16", "shape": list(t.shape),
                "data": t.view(torch.int16).numpy().tobytes()}
    a = t.numpy()
    return {"dtype": a.dtype.str, "shape": list(a.shape), "data": a.tobytes()}


def _decode_array(d, device) -> torch.Tensor:
    shape = [int(n) for n in d["shape"]]
    if d["dtype"] == "bfloat16":
        raw = np.frombuffer(d["data"], np.int16).reshape(shape)
        return torch.from_numpy(raw).view(torch.bfloat16).to(device)
    a = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(shape)
    return torch.from_numpy(a).to(device)


def _paths(tree, prefix: str = "") -> Iterator[str]:
    """Each leaf's "a/b/c" key, in :func:`leaves` order (a sequence's
    index for its position, as JAX's flatten-with-path names it)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _paths(x, f"{prefix}{i}/")
    else:
        yield prefix[:-1]


def _flatten(tree) -> Dict[str, torch.Tensor]:
    return dict(zip(_paths(tree), leaves(tree)))


def save(path: str, tree, step: int = 0) -> None:
    """Write ``tree`` (tensors on any device) and ``step`` to ``path``,
    through a temporary file renamed into place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"step": int(step),
               "tree": {k: _encode_array(v)
                        for k, v in _flatten(tree).items()}}
    out: List = []
    _pack(payload, out)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for piece in out:
            f.write(piece)
    os.replace(tmp, path)


def restore(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf with the checkpoint's dtype and shape, on the device of ``like``'s
    leaf.  Raises ``KeyError`` when the file lacks a key of ``like``."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    payload = unpackb(buf)
    flat = payload["tree"]
    keys = list(_paths(like))
    missing = [k for k in keys if k not in flat]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    restored = [_decode_array(flat[k], t.device)
                for k, t in zip(keys, leaves(like))]
    return unflatten(structure(like), restored), payload["step"]
