"""The flax msgpack format of a parameter tree, in pure Python.

Counterpart of the part of ``flax.serialization`` that the JAX package
uses (``msgpack_serialize`` and ``msgpack_restore``, through
``FedModel.save_pretrained`` and ``gpt2_train``'s reload), so that a
run directory written by either package reads in the other. The port
needs neither flax nor the ``msgpack`` package: this module writes and
reads the subset of MessagePack such a tree uses.

The format, as flax writes it (``msgpack.packb(tree,
strict_types=True)`` after its own preprocessing):

- nested dicts with ``str`` keys, sorted;
- numpy arrays as ext type 1, whose payload is the msgpack array
  ``(shape, dtype name, C-order bytes)`` packed with
  ``use_bin_type=True``; numpy scalars as ext type 3, the same payload
  of the 0-d array;
- Python ``None``, ``bool``, ``int``, ``float`` (float 64), ``str``,
  ``bytes`` and lists as MessagePack's own types, each in its
  shortest form (msgpack-python's choice of encoding);
- an array of more than ``MAX_CHUNK_SIZE`` bytes as the chunked dict
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": flat chunk, ...}}`` (msgpack caps an object at 2^31 - 1 bytes).

For the same tree the bytes equal flax's, and flax's bytes read back
leaf for leaf. A bfloat16 leaf has no numpy dtype here and raises.
"""

from __future__ import annotations

import struct

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are chunked
MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# --- encoding -------------------------------------------------------------

def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit in 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= low:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit in 64 bits")


def _pack_len(n: int, fix_code, fix_max, codes, out: list) -> None:
    """A length header: the fix form (``fix_code | n``) up to
    ``fix_max``, else the first of ``codes`` ((code, fmt, limit)) that
    holds n."""
    if fix_code is not None and n <= fix_max:
        out.append(bytes([fix_code | n]))
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} too large for msgpack")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not "
                         "serializable")
    out: list = []
    _pack((tuple(int(s) for s in arr.shape), arr.dtype.name,
           arr.tobytes("C")), out)
    return b"".join(out)


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n]]))
    else:
        _pack_len(n, None, 0, _EXT, out)
    out.append(struct.pack("b", code))
    out.append(data)


def _pack(x, out: list) -> None:
    # exact types, as msgpack's strict_types: a subclass (np.float64 is
    # one of float) takes the numpy branch
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(x, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        raw = x.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, _STR, out)
        out.append(raw)
    elif t is bytes or t is bytearray or t is memoryview:
        raw = bytes(x)
        _pack_len(len(raw), None, 0, _BIN, out)
        out.append(raw)
    elif t is list or t is tuple:
        _pack_len(len(x), 0x90, 15, _ARRAY, out)
        for item in x:
            _pack(item, out)
    elif t is dict:
        _pack_len(len(x), 0x80, 15, _MAP, out)
        for key, val in x.items():
            _pack(key, out)
            _pack(val, out)
    elif isinstance(x, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)), out)
    else:
        raise TypeError(f"cannot serialize {t.__name__}")


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: the canonical dict of flat chunks."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): s for i, s in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _prepare(tree):
    """A copy of the dict structure with its keys sorted (flax copies
    the tree with ``jax.tree_util.tree_map``, which sorts them) and
    oversized array leaves in flax's chunked form."""
    if isinstance(tree, dict):
        return {k: _prepare(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) \
            and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree) -> bytes:
    """A tree of dicts with numpy leaves -> flax's msgpack bytes
    (``flax.serialization.msgpack_serialize``)."""
    out: list = []
    _pack(_prepare(tree), out)
    return b"".join(out)


# --- decoding -------------------------------------------------------------

# the decoder's tables: code -> value; code -> struct format of a
# number; code -> (struct format of a length, kind)
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {code: (fmt, kind)
          for kind, table in (("str", _STR), ("bin", _BIN),
                              ("array", _ARRAY), ("map", _MAP),
                              ("ext", _EXT))
          for code, fmt, _ in table}
_FIXEXT_SIZE = {code: n for n, code in _FIXEXT.items()}


class _Reader:
    """A MessagePack decoder over one buffer. ``raw``: str types come
    back as bytes (the ndarray payload's dtype name, as flax reads
    it)."""

    def __init__(self, data, raw: bool):
        self.view = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise ValueError("truncated msgpack data")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self._read_kind("map", b & 0x0F)
        if b <= 0x9F:
            return self._read_kind("array", b & 0x0F)
        if b <= 0xBF:
            return self._read_kind("str", b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            return self._read_kind(kind, self.unpack(fmt))
        if b in _FIXEXT_SIZE:
            return self._read_kind("ext", _FIXEXT_SIZE[b])
        raise ValueError(f"msgpack code {b:#x} is not supported")

    def _read_kind(self, kind: str, n: int):
        if kind == "map":
            out = {}
            for _ in range(n):
                key = self.read()
                out[key] = self.read()
            return out
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            raw = bytes(self.take(n))
            return raw if self.raw else raw.decode("utf-8")
        code = self.unpack("b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        raise ValueError(f"msgpack ext type {code} is not supported")


def _ndarray_from(data) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: a read-only view of the buffer."""
    shape, name, buf = _Reader(data, raw=True).read()
    name = name.decode("ascii") if isinstance(name, bytes) else name
    if name == "bfloat16":
        raise ValueError("a bfloat16 leaf has no numpy dtype here")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape,
                                                            order="C")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data) -> dict:
    """flax's msgpack bytes -> the tree (``flax.serialization.
    msgpack_restore``), chunked arrays joined."""
    reader = _Reader(data, raw=False)
    tree = reader.read()
    if reader.pos != len(reader.view):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)
