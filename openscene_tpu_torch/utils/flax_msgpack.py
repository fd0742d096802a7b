"""Decoder of the msgpack that ``flax.serialization.msgpack_serialize`` writes.

The JAX package saves its checkpoints as flax state dicts serialized to
msgpack (``openscene_tpu/utils/train_utils.py:save_checkpoint``).  The port
reads them without flax and without the ``msgpack`` package, through this
decoder of the subset flax writes:

* maps (str keys), arrays, str, bin, int, float, bool and nil;
* ExtType 1, an ndarray: a nested msgpack ``[shape, dtype name, buffer]``
  of the C-order bytes (``bfloat16`` leaves come back as float32, exactly);
* ExtType 3, a NumPy scalar, encoded as a 0-d ndarray;
* flax's chunked-array maps (``__msgpack_chunked_array__``), which it
  writes for leaves over ``flax.serialization.MAX_CHUNK_SIZE`` bytes,
  joined back into one array.

Lists and tuples arrive as flax's ``{"0": ..., "1": ...}`` maps;
:func:`rebuild_lists` turns them back into lists.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data, raw_str: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str  # str as bytes (flax's nested ndarray header)

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wants {n} of {len(self.buf) - self.pos})")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}   # bin
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}   # str
        if b in sized:
            return self.str(self.unpack(sized[b]))
        sized = {0xDC: ">H", 0xDD: ">I"}               # array
        if b in sized:
            return [self.obj() for _ in range(self.unpack(sized[b]))]
        sized = {0xDE: ">H", 0xDF: ">I"}               # map
        if b in sized:
            return self.map(self.unpack(sized[b]))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, self.take(fixext[b]))
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}   # ext
        if b in sized:
            n = self.unpack(sized[b])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x} at byte "
                         f"{self.pos - 1}")

    def str(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw_str else raw.decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def _ndarray(data) -> np.ndarray:
    r = _Reader(data, raw_str=True)
    shape, dtype, buf = r.obj()
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    shape = tuple(int(s) for s in shape)
    if dtype == "bfloat16":  # bf16 is the high half of an fp32
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    try:
        dt = np.dtype(dtype)
    except TypeError as e:
        raise ValueError(f"msgpack: ndarray of dtype {dtype!r}") from e
    return np.frombuffer(buf, dtype=dt).reshape(shape).copy()


def _ext(code: int, data) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack: ExtType {code} is not written by flax's "
                     "checkpoints")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = tuple(int(tree["shape"][str(i)])
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def loads(data: bytes) -> Any:
    """The tree of one msgpack object that spans all of ``data``, with
    ndarray leaves and chunked arrays joined.  Raises ValueError on
    anything else."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return _unchunk(tree)


def looks_like_msgpack_map(head: bytes) -> bool:
    """Whether a file starting with ``head`` may hold a msgpack map of one
    to 15 entries or a map16/map32, as a flax checkpoint does (a torch file
    starts with a zip header or a pickle's 0x80 protocol byte)."""
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE,
                                                                  0xDF))


def rebuild_lists(tree: Any) -> Any:
    """Maps whose keys are exactly ``"0" .. "n-1"`` (flax's lists and
    tuples) become lists, recursively."""
    if isinstance(tree, dict):
        out = {k: rebuild_lists(v) for k, v in tree.items()}
        if out and set(out) == {str(i) for i in range(len(out))}:
            return [out[str(i)] for i in range(len(out))]
        return out
    return tree

