"""Minimal pure-Python MATLAB 5 (``.mat``) reader and writer (a copy of
``protoclip_tpu/io/mat.py``; the port keeps its own so that it imports
nothing of the JAX package).

Covers exactly what the benchmark datasets ship: numeric matrices, char
arrays, cell arrays and struct arrays, with zlib-compressed elements —
enough for Oxford-Flowers ``imagelabels.mat``/``setid.mat`` (ref
``datasets/oxford_flowers.py:14-74``), Stanford-Cars
``cars_*_annos*.mat``/``cars_meta.mat`` (ref ``datasets/stanford_cars.py:8-50``)
and the ImageNet devkit ``meta.mat`` (ref ``datasets/imagenet.py:216-236``
via torchvision).  No scipy dependency; values come back in a canonical
Python form:

- numeric array  -> ``np.ndarray`` (as stored, column-major reshaped)
- char array     -> ``str`` for a single row; ``list[str]`` (one
  right-trimmed string per row) for an (R>1, C) char matrix — MATLAB's
  padded string-array form, matching scipy's row-wise reading
- cell array     -> ``list`` (flattened in column-major order)
- struct array   -> ``list[dict]`` (one dict per element)
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, Tuple

import numpy as np

# mi data type code -> numpy dtype
_MI_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 9: np.float64,
    12: np.int64, 13: np.uint64,
}
_MI_UTF8, _MI_UTF16 = 16, 17
_MI_COMPRESSED, _MI_MATRIX = 15, 14

# mxCLASS codes
_MX_CELL, _MX_STRUCT, _MX_OBJECT, _MX_CHAR, _MX_SPARSE = 1, 2, 3, 4, 5
_MX_NUMERIC = {6, 7, 8, 9, 10, 11, 12, 13, 14, 15}
_MX_DTYPES = {
    6: np.float64, 7: np.float32, 8: np.int8, 9: np.uint8,
    10: np.int16, 11: np.uint16, 12: np.int32, 13: np.uint32,
    14: np.int64, 15: np.uint64,
}


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def read_element(self) -> Tuple[int, bytes]:
        """One data element: (mi type, raw bytes); handles the small-element
        format and 8-byte padding."""
        mdtype, nbytes = struct.unpack_from("<II", self.buf, self.pos)
        if mdtype >> 16:  # small element: type/len packed in first word
            nbytes = mdtype >> 16
            mdtype &= 0xFFFF
            data = self.buf[self.pos + 4 : self.pos + 4 + nbytes]
            self.pos += 8
            return mdtype, data
        data = self.buf[self.pos + 8 : self.pos + 8 + nbytes]
        self.pos += 8 + nbytes
        self.pos += (-self.pos) % 8  # pad to 8-byte boundary
        return mdtype, data


def _decode_chars(mdtype: int, data: bytes) -> str:
    if mdtype == _MI_UTF8:
        return data.decode("utf-8")
    if mdtype in (4, _MI_UTF16):  # miUINT16 / miUTF16
        return data.decode("utf-16-le")
    if mdtype in (1, 2):  # some writers store char as int8/uint8
        return data.decode("latin-1")
    raise ValueError(f"unsupported char storage type {mdtype}")


def _parse_matrix(mdtype: int, data: bytes) -> Tuple[str, Any]:
    if mdtype == _MI_COMPRESSED:
        inner = _Reader(zlib.decompress(data))
        return _parse_matrix(*inner.read_element())
    if mdtype != _MI_MATRIX:
        raise ValueError(f"expected miMATRIX, got type {mdtype}")
    if len(data) == 0:
        # MATLAB encodes an empty array ([]) as a zero-byte miMATRIX
        # element (scipy special-cases this identically); the ImageNet
        # devkit meta.mat uses it for leaf synsets' empty children lists
        return "", np.empty((0, 0), np.float64)
    r = _Reader(data)

    flags_type, flags_raw = r.read_element()
    if flags_type != 6:  # not assert: must survive python -O
        raise ValueError(f"bad array-flags element type {flags_type}")
    flags = struct.unpack_from("<II", flags_raw, 0)[0]
    mxclass = flags & 0xFF
    if flags & 0x0800:  # mxCOMPLEX: a second (imaginary) data element follows
        raise ValueError(
            "complex matrices are not supported (none of the benchmark "
            "datasets ship them); refusing to silently drop the imaginary part"
        )

    _, dims_raw = r.read_element()
    dims = np.frombuffer(dims_raw, np.int32).tolist()

    _, name_raw = r.read_element()
    name = name_raw.rstrip(b"\x00").decode("latin-1")

    if mxclass in _MX_NUMERIC:
        dt, raw = r.read_element()
        arr = np.frombuffer(raw, _MI_DTYPES[dt]).astype(_MX_DTYPES[mxclass], copy=False)
        value: Any = arr.reshape(dims, order="F")
    elif mxclass == _MX_CHAR:
        dt, raw = r.read_element()
        s = _decode_chars(dt, raw)
        if len(dims) == 2 and dims[0] > 1:
            # column-major char matrix: reassemble rows
            grid = np.array(list(s)).reshape(dims, order="F")
            value = ["".join(row).rstrip() for row in grid]
        else:
            value = s
    elif mxclass == _MX_CELL:
        n = int(np.prod(dims)) if dims else 0
        value = [_parse_matrix(*r.read_element())[1] for _ in range(n)]
    elif mxclass in (_MX_STRUCT, _MX_OBJECT):
        if mxclass == _MX_OBJECT:
            r.read_element()  # class name — not needed
        _, flen_raw = r.read_element()
        field_len = int(np.frombuffer(flen_raw, np.int32)[0])
        _, fnames_raw = r.read_element()
        n_fields = len(fnames_raw) // field_len
        fields = [
            fnames_raw[i * field_len : (i + 1) * field_len].rstrip(b"\x00").decode("latin-1")
            for i in range(n_fields)
        ]
        n = int(np.prod(dims)) if dims else 0
        value = [
            {f: _parse_matrix(*r.read_element())[1] for f in fields} for _ in range(n)
        ]
    else:
        raise ValueError(f"unsupported MATLAB array class {mxclass}")
    return name, value


def load_mat(path: str) -> Dict[str, Any]:
    """Load a MAT5 file into ``{variable_name: canonical value}``."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if len(buf) < 128 or buf[124:128][2:4] not in (b"IM", b"MI"):
        raise ValueError(f"{path} is not a MATLAB 5 file")
    if buf[126:128] == b"MI":
        raise ValueError("big-endian MAT files are not supported")
    pos = 128
    out: Dict[str, Any] = {}
    while len(buf) - pos >= 8:
        mdtype, nbytes = struct.unpack_from("<II", buf, pos)
        data = buf[pos + 8 : pos + 8 + nbytes]
        pos += 8 + nbytes
        if mdtype != _MI_COMPRESSED:
            # compressed elements are written unpadded (scipy convention);
            # everything else aligns to 8 bytes
            pos += (-pos) % 8
        name, value = _parse_matrix(mdtype, data)
        out[name] = value
    return out


def mat_1d(value: Any) -> np.ndarray:
    """Flatten a (1, N)/(N, 1) numeric matrix to 1-D."""
    return np.asarray(value).reshape(-1)


def mat_scalar(value: Any):
    """Extract the scalar from a (1, 1) numeric matrix."""
    return np.asarray(value).reshape(-1)[0]


# -- minimal MAT5 writer ------------------------------------------------------

_NP_TO_MX = {
    np.dtype(np.float64): (6, 9), np.dtype(np.float32): (7, 7),
    np.dtype(np.int8): (8, 1), np.dtype(np.uint8): (9, 2),
    np.dtype(np.int16): (10, 3), np.dtype(np.uint16): (11, 4),
    np.dtype(np.int32): (12, 5), np.dtype(np.uint32): (13, 6),
    np.dtype(np.int64): (14, 12), np.dtype(np.uint64): (15, 13),
}


def _element(mdtype: int, data: bytes) -> bytes:
    pad = (-len(data)) % 8
    return struct.pack("<II", mdtype, len(data)) + data + b"\x00" * pad


def _matrix_bytes(name: str, arr: np.ndarray) -> bytes:
    arr = np.atleast_2d(np.asarray(arr))
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in _NP_TO_MX:
        arr = arr.astype(np.float64)
    mxclass, mi = _NP_TO_MX[arr.dtype]
    body = (
        _element(6, struct.pack("<II", mxclass, 0))  # array flags
        + _element(5, np.asarray(arr.shape, np.int32).tobytes())  # dims
        + _element(1, name.encode("latin-1"))  # name
        + _element(mi, arr.flatten(order="F").tobytes())  # data
    )
    return _element(_MI_MATRIX, body)


def save_mat(path: str, variables: Dict[str, Any], compress: bool = True) -> None:
    """Write numeric arrays/scalars as a MATLAB 5 file (the subset the
    reference's data dumper emits via ``scipy.io.savemat``,
    ref ``seg_image_listener.py:299-305``)."""
    header = b"MATLAB 5.0 MAT-file, written by protoclip_tpu_torch.io.mat"
    header = header + b" " * (116 - len(header))
    header += b"\x00" * 8 + struct.pack("<H", 0x0100) + b"IM"
    out = [header]
    for name, value in variables.items():
        blob = _matrix_bytes(name, value)
        if compress:
            comp = zlib.compress(blob)
            out.append(struct.pack("<II", _MI_COMPRESSED, len(comp)) + comp)
        else:
            out.append(blob)
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
