"""A decoder for the msgpack that flax.serialization writes, in pure Python
and numpy, so the port reads phiseg_tpu's checkpoints on a machine without
the msgpack package, flax or jax.

phiseg_tpu saves a TrainState with `flax.serialization.to_bytes`
(phiseg_tpu/engine/checkpoint.py:252-267): a msgpack map of nested maps whose
leaves are arrays in msgpack's extension types. `msgpack_restore` returns
what `flax.serialization.msgpack_restore` returns for such bytes:

  nil, bool, every int width, float32/64, str, bin, array (a list) and map
                 (a dict) of the msgpack spec;
  ext 1          an ndarray: its payload is msgpack [shape, dtype name, the
                 C-order bytes]; bfloat16, which numpy lacks, widens to
                 float32 exactly;
  ext 2          a Python complex from the payload [real, imag];
  ext 3          a numpy scalar, an ext 1 payload of shape ();
  flax's chunked arrays, {"__msgpack_chunked_array__": True, "shape",
                 "chunks"} (flax splits a leaf over MAX_CHUNK_SIZE = 2**30
                 bytes so), joined back into one array.

Anything else (another ext type, the reserved byte 0xc1, a truncated or
over-long buffer) raises ValueError. `unpackb` is the plain decoder, with
the extension types left to its `ext_hook`.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Optional, Tuple

import numpy as np

ExtHook = Callable[[int, bytes], Any]

_FIXED = {  # type byte -> (struct format, width)
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
# type byte -> width of its length field, for bin, str, ext, array and map
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}


class _Reader:
    def __init__(self, data: bytes, ext_hook: Optional[ExtHook]):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack data ends at byte {len(self.buf)}, inside an object "
                             f"that needs {end}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, width: int) -> int:
        return self.unpack(_LEN[width], width)

    def ext(self, code: int, payload: bytes):
        if self.ext_hook is None:
            raise ValueError(f"msgpack ext type {code} with no ext_hook")
        return self.ext_hook(code, payload)

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _BIN:
            return bytes(self.take(self.length(_BIN[b])))
        if b in _STR:
            return self.str(self.length(_STR[b]))
        if b in _ARRAY:
            return self.array(self.length(_ARRAY[b]))
        if b in _MAP:
            return self.map(self.length(_MAP[b]))
        if b in _FIXEXT:
            code = self.unpack(">b", 1)
            return self.ext(code, bytes(self.take(_FIXEXT[b])))
        if b in _EXT:
            n = self.length(_EXT[b])
            code = self.unpack(">b", 1)
            return self.ext(code, bytes(self.take(n)))
        raise ValueError(f"msgpack type byte 0x{b:02x} at offset {self.pos - 1} is not valid")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            try:
                out[k] = self.obj()
            except TypeError as e:  # an unhashable key
                raise ValueError(f"msgpack map key {k!r} is not hashable") from e
        return out


def unpackb(data: bytes, ext_hook: Optional[ExtHook] = None) -> Any:
    """Decode one msgpack object that fills `data`; ext types go to
    `ext_hook(code, payload)` (without one they raise)."""
    r = _Reader(data, ext_hook)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, raw = unpackb(payload)
    if name == "bfloat16":  # the high half of an f32: widen exactly
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _flax_ext(code: int, payload: bytes):
    if code == 1:
        return _ndarray(payload)
    if code == 2:
        re_, im = unpackb(payload)
        return complex(re_, im)
    if code == 3:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack ext type {code} is not one that flax writes")


def _shape(d: dict) -> Tuple[int, ...]:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        chunks = tree["chunks"]
        flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
        return flat.reshape(_shape(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """flax.serialization.msgpack_restore without msgpack: the tree of
    dicts, lists, Python scalars and numpy arrays that `data` encodes."""
    return _unchunk(unpackb(data, ext_hook=_flax_ext))
