"""The native weight format: flax's msgpack, written and read without
``msgpack`` or ``flax``.  The port's model files need torch and NumPy
alone (``tests/test_torch_imports.py`` holds the package to that), so this
module carries the small part of msgpack that the format uses.

Counterpart of ``flax.serialization.to_bytes`` / ``msgpack_restore`` as the
JAX package's ``TextDetector.save_variables`` / ``from_native`` use them
(``to_bytes(jax.device_get(variables))``).  That file is plain msgpack with
one extension type:

* maps with ``str`` keys in sorted order (``jax.device_get``'s tree map
  sorts dict keys);
* each array is ``ExtType(1, packb((shape, dtype.name, arr.tobytes("C")),
  use_bin_type=True))`` (a NumPy scalar is type 3, read here only);
* arrays over ``MAX_CHUNK_SIZE`` bytes are split into chunks.

Every item is written in the smallest encoding msgpack-python picks for it,
so the bytes equal flax's.  The reader takes exactly what the writer can
write (and type 3): maps, ``str`` keys, ``bin``, arrays, positive integers
and ext types 1 and 3.  Anything else, chunked leaves, object dtypes and
``bfloat16`` raise a ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Mapping

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED_KEY = "__msgpack_chunked_array__"

# (limit, header byte, struct format of the length) for each sized family
_STR = ((0x100, 0xD9, ">B"), (0x10000, 0xDA, ">H"), (0x100000000, 0xDB, ">I"))
_BIN = ((0x100, 0xC4, ">B"), (0x10000, 0xC5, ">H"), (0x100000000, 0xC6, ">I"))
_ARRAY = ((0x10000, 0xDC, ">H"), (0x100000000, 0xDD, ">I"))
_MAP = ((0x10000, 0xDE, ">H"), (0x100000000, 0xDF, ">I"))
_UINT = ((0x100, 0xCC, ">B"), (0x10000, 0xCD, ">H"), (0x100000000, 0xCE, ">I"), (1 << 64, 0xCF, ">Q"))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0x100, 0xC7, ">B"), (0x10000, 0xC8, ">H"), (0x100000000, 0xC9, ">I"))


def _sized(out: List[bytes], n: int, families, what: str) -> None:
    for limit, head, fmt in families:
        if n < limit:
            out.append(bytes([head]) + struct.pack(fmt, n))
            return
    raise ValueError(f"{what} of {n} is too long for msgpack")


def _pack_uint(out: List[bytes], v: int) -> None:
    if v < 0:
        raise ValueError(f"negative integer {v}: the native format holds none")
    if v < 0x80:
        out.append(bytes([v]))
    else:
        _sized(out, v, _UINT, "integer")


def _pack_str(out: List[bytes], s: str) -> None:
    b = s.encode("utf-8")
    if len(b) < 32:
        out.append(bytes([0xA0 | len(b)]))
    else:
        _sized(out, len(b), _STR, "str")
    out.append(b)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """``packb((shape, dtype.name, bytes), use_bin_type=True)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.names is not None:
        raise ValueError(f"dtype {arr.dtype} cannot be written to the native format")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {arr.nbytes} bytes would be chunked; chunked leaves are not supported")
    out: List[bytes] = [b"\x93"]  # fixarray of 3
    if len(arr.shape) < 16:
        out.append(bytes([0x90 | len(arr.shape)]))
    else:
        _sized(out, len(arr.shape), _ARRAY, "shape")
    for d in arr.shape:
        _pack_uint(out, int(d))
    _pack_str(out, arr.dtype.name)
    data = arr.tobytes("C")
    _sized(out, len(data), _BIN, "bin")
    out.append(data)
    return b"".join(out)


def _pack_ext(out: List[bytes], code: int, payload: bytes) -> None:
    n = len(payload)
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n]]))
    else:
        _sized(out, n, _EXT, "ext payload")
    out.append(bytes([code]))
    out.append(payload)


def _pack(out: List[bytes], node: Any) -> None:
    if isinstance(node, Mapping):
        n = len(node)
        if n < 16:
            out.append(bytes([0x80 | n]))
        else:
            _sized(out, n, _MAP, "map")
        for key in sorted(node):
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a str")
            _pack_str(out, key)
            _pack(out, node[key])
    elif isinstance(node, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(node))
    else:
        raise ValueError(f"leaf of type {type(node).__name__}: the native format holds dicts of numpy arrays")


def to_bytes(tree: Mapping[str, Any]) -> bytes:
    """A nested dict of NumPy arrays -> the bytes of
    ``flax.serialization.to_bytes(jax.device_get(tree))``."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


_SIZED = {  # header byte -> (struct format of the length or value, kind)
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"), 0xDE: (">H", "map"), 0xDF: (">I", "map"),
    0xCC: (">B", "uint"), 0xCD: (">H", "uint"), 0xCE: (">I", "uint"), 0xCF: (">Q", "uint"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
}
_FIXEXT_LEN = {head: n for n, head in _FIXEXT.items()}


class _Reader:
    """One msgpack object from ``buf``; ``raw`` keeps str values as bytes
    (``unpackb(..., raw=True)``, as flax reads an array's payload)."""

    def __init__(self, buf, raw: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def item(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.item() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _FIXEXT_LEN:
            return self.ext(_FIXEXT_LEN[b])
        if b not in _SIZED:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not part of the native format")
        fmt, kind = _SIZED[b]
        n = struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if kind == "uint":
            return n
        if kind == "str":
            return self.str(n)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.item() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n)

    def str(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def map(self, n: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for _ in range(n):
            key = self.item()
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a str")
            if key == _CHUNKED_KEY:
                raise ValueError("chunked array leaves are not supported")
            out[key] = self.item()
        return out

    def ext(self, n: int):
        code = self.take(1)[0]
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not part of the native format")
        arr = _ndarray_from_payload(self.take(n))
        return arr if code == _EXT_NDARRAY else arr[()]


def _ndarray_from_payload(payload) -> np.ndarray:
    inner = _Reader(payload, raw=True)
    fields = inner.item()
    if inner.pos != len(payload) or not isinstance(fields, list) or len(fields) != 3:
        raise ValueError("malformed ndarray payload")
    shape, name, data = fields
    name = name.decode("ascii")
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported by the port's native reader")
    dtype = np.dtype(name)
    if dtype.hasobject:
        raise ValueError(f"dtype {name} cannot be read from the native format")
    return np.frombuffer(data, dtype=dtype).reshape(tuple(shape)).copy()


def msgpack_restore(buf: bytes) -> Dict[str, Any]:
    """Bytes of the native format -> nested dicts of (writable) NumPy arrays,
    as ``flax.serialization.msgpack_restore`` reads them."""
    reader = _Reader(buf)
    tree = reader.item()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes after the msgpack object")
    return tree
