"""A small pure-Python msgpack codec for the JAX package's checkpoints.

Flax's ``msgpack_serialize`` writes nested maps whose array leaves are
msgpack ext type 1 holding a packed ``(shape, dtype_name, bytes)`` triple
(ext type 3 holds a numpy scalar the same way, type 2 a complex number);
arrays above 1 GiB are split into ``__msgpack_chunked_array__`` maps. The
machine with the card has neither flax nor, necessarily, ``msgpack``, so
this module handles the format itself. ``unpackb`` returns the same tree as
``flax.serialization.msgpack_restore``; ``packb`` writes the bytes of
``flax.serialization.msgpack_serialize`` for a tree of dicts and numpy
arrays below the chunking size.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes, raw: bool, ext_hook):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return self.ext_hook(code, bytes(self.take(n)))

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b >= 0xE0:
            return b - 0x100
        simple = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"), 0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"), 0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"), 0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"), 0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"), 0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4), 0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.string(self.unpack(">B")),
            0xDA: lambda: self.string(self.unpack(">H")),
            0xDB: lambda: self.string(self.unpack(">I")),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in simple:
            raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")
        return simple[b]()


def _decode(data: bytes, raw: bool = False, ext_hook=None):
    reader = _Reader(data, raw, ext_hook or (lambda code, payload: (code, payload)))
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _decode(payload, raw=True)
    if dtype_name == b"bfloat16":  # numpy has no bfloat16: widen to float32
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        real, imag = _decode(payload)
        return complex(real, imag)
    raise ValueError(f"msgpack: unknown ext type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """Decode a Flax ``msgpack_serialize`` blob into a tree of dicts,
    Python scalars and numpy arrays."""
    return _unchunk(_decode(data, ext_hook=_ext_hook))


def _pack_uint(n: int, fix_max: int, fix_base: int, codes) -> bytes:
    if n <= fix_max:
        return bytes([fix_base | n])
    for limit, code, fmt in codes:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                 (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if n < limit:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for limit, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                 (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
            if -n <= limit:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: integer {n} out of range")


def _pack_ext(code: int, payload: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fixed:
        head = bytes([fixed[n]])
    elif n < 1 << 8:
        head = bytes([0xC7]) + struct.pack(">B", n)
    elif n < 1 << 16:
        head = bytes([0xC8]) + struct.pack(">H", n)
    else:
        head = bytes([0xC9]) + struct.pack(">I", n)
    return head + struct.pack(">b", code) + payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    return _pack((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(value) -> bytes:
    if value is None:
        return b"\xc0"
    if isinstance(value, bool):
        return b"\xc3" if value else b"\xc2"
    if isinstance(value, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _ndarray_payload(value))
    if isinstance(value, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(value)))
    if isinstance(value, int):
        return _pack_int(value)
    if isinstance(value, float):
        return b"\xcb" + struct.pack(">d", value)
    if isinstance(value, str):
        data = value.encode("utf-8")
        return _pack_uint(len(data), 31, 0xA0, ((1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"),
                                                (1 << 32, 0xDB, ">I"))) + data
    if isinstance(value, bytes):
        return _pack_uint(len(value), -1, 0, ((1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"),
                                              (1 << 32, 0xC6, ">I"))) + value
    if isinstance(value, (list, tuple)):
        head = _pack_uint(len(value), 15, 0x90, ((1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I")))
        return head + b"".join(_pack(v) for v in value)
    if isinstance(value, dict):
        head = _pack_uint(len(value), 15, 0x80, ((1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I")))
        # keys sorted, as jax.tree_util orders a dict before Flax packs it
        return head + b"".join(_pack(k) + _pack(value[k]) for k in sorted(value))
    raise TypeError(f"msgpack: cannot pack {type(value).__name__}")


_MAX_CHUNK_SIZE = 2**30  # Flax chunks larger arrays; the port's trees stay below


def packb(tree) -> bytes:
    """Encode a tree of dicts and numpy arrays as Flax ``msgpack_serialize``
    does."""
    def check(node):
        if isinstance(node, dict):
            for v in node.values():
                check(v)
        elif isinstance(node, np.ndarray) and node.nbytes > _MAX_CHUNK_SIZE:
            raise ValueError("msgpack: arrays above 1 GiB need Flax's chunking")

    check(tree)
    return _pack(tree)
