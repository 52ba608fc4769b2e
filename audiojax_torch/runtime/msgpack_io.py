"""A decoder for the ``params.msgpack`` files that the JAX package writes.

``audiojax.runtime.checkpoint.save_artifact`` writes its parameter tree with
``flax.serialization.to_bytes``: a msgpack map whose leaves are msgpack
extension values.  This module reads exactly that format, with nothing but
the standard library, numpy and torch (the card's machine has neither
``msgpack`` nor ``flax``):

* every msgpack type, in every width the format defines: nil, bool, the
  positive and negative fixints, uint/int 8–64, float 32/64, str, bin, array
  and map (fix, 16 and 32);
* ext code 1, an ndarray: a nested msgpack array ``(shape, dtype name,
  C-order bytes)``, little-endian as flax writes it on x86 and ARM;
* ext code 2, a complex: a nested array ``(real, imag)``;
* ext code 3, a numpy scalar: an ndarray of shape ``()``, returned as a
  scalar (a 0-d tensor for bfloat16);
* flax's chunked arrays, which it writes for leaves above
  ``MAX_CHUNK_SIZE`` bytes: a map ``{"__msgpack_chunked_array__": True,
  "shape": {"0": …}, "chunks": {"0": flat piece, …}}``, joined back here.

The dtypes are those a served tree holds: float32 and int8 come out as numpy
arrays, bfloat16 as CPU ``torch.bfloat16`` tensors made from the raw bytes
(numpy has no bfloat16 without ``ml_dtypes``).  Anything else is refused
with ``ValueError`` naming the byte offset: an unknown type byte or ext
code, a truncated input, bytes after the top-level value, another dtype
name, an array whose bytes do not fill its shape.  The decoder only reads
bytes; it runs no code and builds no object but dicts, lists, scalars,
arrays and tensors.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = ["unpackb", "restore", "CHUNKED"]

CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# dtype names of a served tree → numpy dtypes (bfloat16 is read through torch)
_NUMPY = {"float32": np.dtype("<f4"), "int8": np.dtype("i1")}
_MAX_DEPTH = 512

_FIXED = {  # type byte → (struct format, byte count) of the scalar types
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
# type byte → (kind, width of its length field)
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4), 0xDE: ("map", 2), 0xDF: ("map", 4),
          0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4)}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data, where: str):
        self.buf = memoryview(bytes(data))
        self.pos = 0
        self.where = where

    def fail(self, msg: str, at: int | None = None):
        raise ValueError(f"{self.where}: {msg} at byte offset "
                         f"{self.pos if at is None else at}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            self.fail(f"truncated input: {n} bytes needed, {len(self.buf) - self.pos} left")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self, depth: int = 0):
        if depth > _MAX_DEPTH:
            self.fail(f"nesting deeper than {_MAX_DEPTH}")
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, depth, at)
        if 0x90 <= b <= 0x9F:
            return [self.value(depth + 1) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F, at)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], at)
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.unpack(_LEN[width], width)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.text(n, at)
            if kind == "array":
                return [self.value(depth + 1) for _ in range(n)]
            if kind == "map":
                return self.map(n, depth, at)
            return self.ext(n, at)
        self.fail(f"unknown msgpack type byte 0x{b:02x}", at)

    def text(self, n: int, at: int) -> str:
        try:
            return bytes(self.take(n)).decode("utf-8")
        except UnicodeDecodeError:
            self.fail("a str that is not UTF-8", at)

    def map(self, n: int, depth: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value(depth + 1)
            if not isinstance(key, str):
                self.fail(f"a map key of type {type(key).__name__} (flax writes str keys)",
                          key_at)
            out[key] = self.value(depth + 1)
        return out

    def ext(self, n: int, at: int):
        code = struct.unpack(">b", self.take(1))[0]
        body = self.take(n)
        inner = _Reader(body, f"{self.where} (ext {code} at byte offset {at})")
        if code == EXT_NDARRAY:
            return inner.ndarray()
        if code == EXT_NPSCALAR:
            arr = inner.ndarray()
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            pair = inner.whole()
            if (not isinstance(pair, list) or len(pair) != 2
                    or not all(isinstance(v, (int, float)) for v in pair)):
                self.fail("a complex ext that is not (real, imag)", at)
            return complex(pair[0], pair[1])
        self.fail(f"unknown ext code {code}", at)

    def whole(self):
        out = self.value()
        if self.pos != len(self.buf):
            self.fail(f"{len(self.buf) - self.pos} trailing bytes after the value")
        return out

    def ndarray(self):
        tpl = self.whole()
        if not (isinstance(tpl, list) and len(tpl) == 3 and isinstance(tpl[0], list)
                and all(isinstance(d, int) and d >= 0 for d in tpl[0])
                and isinstance(tpl[1], (str, bytes)) and isinstance(tpl[2], bytes)):
            self.fail("an ndarray ext that is not (shape, dtype name, bytes)", 0)
        shape, name, raw = tpl
        name = name.decode() if isinstance(name, bytes) else name
        count = int(np.prod(shape, dtype=np.int64))
        if name == "bfloat16":
            size = 2
        elif name in _NUMPY:
            size = _NUMPY[name].itemsize
        else:
            self.fail(f"dtype {name!r}: the port reads float32, int8 and bfloat16", 0)
        if len(raw) != count * size:
            self.fail(f"{len(raw)} bytes for a {name} array of shape {tuple(shape)}", 0)
        if name == "bfloat16":
            return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(shape) \
                if count else torch.empty(shape, dtype=torch.bfloat16)
        return np.frombuffer(raw, dtype=_NUMPY[name]).reshape(shape).astype(name)


def _unchunk(tree):
    """flax's chunked arrays joined back, anywhere in the tree."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if all(isinstance(c, torch.Tensor) for c in chunks):
                return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
            return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def unpackb(data, where: str = "msgpack") -> object:
    """Decode one msgpack value that fills ``data`` exactly (flax's ext types
    decoded, chunked arrays left as flax wrote them)."""
    return _Reader(data, where).whole()


def restore(data, where: str = "params.msgpack") -> object:
    """``flax.serialization.msgpack_restore``'s counterpart: the decoded tree
    with flax's chunked arrays joined back."""
    return _unchunk(unpackb(data, where))
