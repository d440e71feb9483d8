"""Codec for ``.fatcube`` FFAT acoustic-transfer map files.

The port's own copy of openpbso_tpu/io/fatcube.py (numpy only), so that
the port imports nothing of the JAX package; it writes and reads the same
bytes (tests/test_torch_io.py).

The on-disk format is the proto3 schema of the reference
(ffat_map.proto:12-51) serialized with standard protobuf wire encoding.
Only the fields required by the runtime lookup are persisted (reference
ffat_map_serialize.h:55-78): the outermost shell's cubemap geometry, the
wavenumber ``k``, the map center, the mode id, and the (optionally
compressed) real amplitude matrix ``Psi``.

This module implements the proto3 *wire format* directly (varints +
length-delimited submessages + packed repeated scalars), so there is no
dependency on a protobuf runtime, and decoding lands directly in dense numpy
arrays ready for device upload.

Decoded representation: :class:`FatcubeMap` keeps the reference's ragged
per-face layout (faces may have different Nu x Nv); ``ops.ffat`` packs a
batch of maps into padded device tensors.
"""
from __future__ import annotations

import dataclasses
import os
import struct
from typing import Iterator

import numpy as np

# ---------------------------------------------------------------------------
# proto3 wire-format primitives
# ---------------------------------------------------------------------------

_WT_VARINT = 0
_WT_64BIT = 1
_WT_LEN = 2
_WT_32BIT = 5


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, proto int32 style
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, payload) triples from a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            val, pos = _read_varint(buf, pos)
            yield field, wt, val
        elif wt == _WT_64BIT:
            if n - pos < 8:
                raise ValueError("truncated 64-bit field")
            yield field, wt, buf[pos:pos + 8]
            pos += 8
        elif wt == _WT_32BIT:
            if n - pos < 4:
                raise ValueError("truncated 32-bit field")
            yield field, wt, buf[pos:pos + 4]
            pos += 4
        elif wt == _WT_LEN:
            ln, pos = _read_varint(buf, pos)
            if ln > n - pos:
                raise ValueError("truncated length-delimited field")
            yield field, wt, buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _decode_packed_doubles(payload: bytes | int, wt: int, acc: list) -> None:
    if wt == _WT_LEN:
        acc.append(np.frombuffer(payload, dtype="<f8"))
    elif wt == _WT_64BIT:
        acc.append(np.frombuffer(payload, dtype="<f8"))
    else:
        raise ValueError("bad wire type for double field")


def _decode_vec(buf: bytes) -> np.ndarray:
    """message vec { repeated double item = 1; } (packed or not)."""
    parts: list[np.ndarray] = []
    for field, wt, payload in _iter_fields(buf):
        if field == 1:
            _decode_packed_doubles(payload, wt, parts)
    if not parts:
        return np.zeros((0,), dtype=np.float64)
    return np.concatenate(parts)


def _decode_vec_i(buf: bytes) -> np.ndarray:
    """message vec_i { repeated int32 item = 1; } (packed or not)."""
    vals: list[int] = []
    for field, wt, payload in _iter_fields(buf):
        if field != 1:
            continue
        if wt == _WT_VARINT:
            vals.append(payload)
        elif wt == _WT_LEN:
            pos = 0
            while pos < len(payload):
                v, pos = _read_varint(payload, pos)
                vals.append(v)
        else:
            raise ValueError("bad wire type for int32 field")
    # interpret as signed 32-bit (varints store int32 sign-extended to 64)
    arr = np.asarray([v & 0xFFFFFFFFFFFFFFFF for v in vals], dtype=np.uint64)
    return arr.astype(np.int64).astype(np.int32)


def _decode_mat(buf: bytes) -> list[np.ndarray]:
    """message mat { repeated vec item = 1; } -> list of columns."""
    cols = []
    for field, wt, payload in _iter_fields(buf):
        if field == 1 and wt == _WT_LEN:
            cols.append(_decode_vec(payload))
    return cols


def _decode_mat_i(buf: bytes) -> list[np.ndarray]:
    cols = []
    for field, wt, payload in _iter_fields(buf):
        if field == 1 and wt == _WT_LEN:
            cols.append(_decode_vec_i(payload))
    return cols


def _encode_key(out: bytearray, field: int, wt: int) -> None:
    _write_varint(out, (field << 3) | wt)


def _encode_len_field(out: bytearray, field: int, payload: bytes) -> None:
    _encode_key(out, field, _WT_LEN)
    _write_varint(out, len(payload))
    out.extend(payload)


def _encode_vec(values: np.ndarray) -> bytes:
    out = bytearray()
    data = np.asarray(values, dtype="<f8").tobytes()
    _encode_len_field(out, 1, data)  # packed doubles
    return bytes(out)


def _encode_vec_i(values: np.ndarray) -> bytes:
    out = bytearray()
    packed = bytearray()
    for v in np.asarray(values).ravel():
        _write_varint(packed, int(v))
    _encode_len_field(out, 1, bytes(packed))
    return bytes(out)


def _encode_mat(columns: list[np.ndarray]) -> bytes:
    out = bytearray()
    for col in columns:
        _encode_len_field(out, 1, _encode_vec(col))
    return bytes(out)


def _encode_mat_i(columns: list[np.ndarray]) -> bytes:
    out = bytearray()
    for col in columns:
        _encode_len_field(out, 1, _encode_vec_i(col))
    return bytes(out)


# ---------------------------------------------------------------------------
# FFAT map data model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CubemapShell:
    """Geometry of one cubemap shell (reference FFAT_Map<T,1> fields).

    Face order is +x,-x,+y,-y,+z,-z (reference ffat_solver.h:84-102): face
    ``2*axis`` lies on ``bbox_top[axis]``, face ``2*axis+1`` on
    ``bbox_low[axis]``. In-face axes for face f with normal axis k=f//2 are
    di=(k+1)%3 (u, Nu cells) and dj=(k+2)%3 (v, Nv cells).
    """
    cell_size: float
    low_corners: np.ndarray   # [6, 3] float64
    n_elements: np.ndarray    # [6, 2] int32 (Nu, Nv per face)
    strides: np.ndarray       # [6] int32 flat quad offsets
    center: np.ndarray        # [3]
    bbox_low: np.ndarray      # [3]
    bbox_top: np.ndarray      # [3]

    @property
    def total_quads(self) -> int:
        return int(np.sum(self.n_elements[:, 0] * self.n_elements[:, 1]))


@dataclasses.dataclass
class FatcubeMap:
    """One mode's acoustic-transfer map (reference FFAT_Map<T,3> subset)."""
    mode_id: int
    k: float                  # wavenumber omega/c
    center: np.ndarray        # [3]
    shell: CubemapShell       # outermost shell (index 2 in the reference)
    psi: np.ndarray           # [N_directions] float64 amplitudes
    is_compressed: bool = False


# ---------------------------------------------------------------------------
# load / save
# ---------------------------------------------------------------------------

def _decode_shell(buf: bytes) -> CubemapShell:
    cell_size = 0.0
    low_corners: list[np.ndarray] = []
    n_elements: list[np.ndarray] = []
    strides = np.zeros((6,), np.int32)
    center = np.zeros((3,))
    bbox_low = np.zeros((3,))
    bbox_top = np.zeros((3,))
    for field, wt, payload in _iter_fields(buf):
        if field == 1 and wt == _WT_64BIT:
            cell_size = struct.unpack("<d", payload)[0]
        elif field == 2 and wt == _WT_LEN:
            low_corners = _decode_mat(payload)
        elif field == 3 and wt == _WT_LEN:
            n_elements = _decode_mat_i(payload)
        elif field == 4 and wt == _WT_LEN:
            strides = _decode_vec_i(payload)
        elif field == 5 and wt == _WT_LEN:
            center = _decode_vec(payload)
        elif field == 6 and wt == _WT_LEN:
            bbox_low = _decode_vec(payload)
        elif field == 7 and wt == _WT_LEN:
            bbox_top = _decode_vec(payload)
    return CubemapShell(
        cell_size=cell_size,
        low_corners=np.stack(low_corners) if low_corners else np.zeros((6, 3)),
        n_elements=(np.stack(n_elements).astype(np.int32)
                    if n_elements else np.zeros((6, 2), np.int32)),
        strides=np.asarray(strides, np.int32),
        center=np.asarray(center, np.float64),
        bbox_low=np.asarray(bbox_low, np.float64),
        bbox_top=np.asarray(bbox_top, np.float64),
    )


def decode_fatcube(data: bytes) -> FatcubeMap:
    """Decode a serialized ``ffat_map_double`` message."""
    map3_buf = b""
    for field, wt, payload in _iter_fields(data):
        if field == 1 and wt == _WT_LEN:
            map3_buf = payload
    k = 0.0
    center = np.zeros((3,))
    shell = None
    is_compressed = False
    psi_cols: list[np.ndarray] = []
    mode_id = 0  # proto3 default when the field is omitted (mode 0 maps)
    for field, wt, payload in _iter_fields(map3_buf):
        if field == 1 and wt == _WT_64BIT:
            k = struct.unpack("<d", payload)[0]
        elif field == 2 and wt == _WT_LEN:
            center = _decode_vec(payload)
        elif field == 3 and wt == _WT_LEN:
            shell = _decode_shell(payload)
        elif field == 4 and wt == _WT_VARINT:
            is_compressed = bool(payload)
        elif field == 5 and wt == _WT_LEN:
            psi_cols = _decode_mat(payload)
        elif field == 6 and wt == _WT_VARINT:
            mode_id = int(np.int32(np.uint32(payload & 0xFFFFFFFF)))
    if shell is None:
        raise ValueError("fatcube file missing shell geometry")
    # Psi is serialized column-major with a single column ([N_directions, 1],
    # reference ffat_map_serialize.h:149-159).
    psi = psi_cols[0] if psi_cols else np.zeros((0,))
    return FatcubeMap(
        mode_id=mode_id,
        k=k,
        center=np.asarray(center, np.float64),
        shell=shell,
        psi=np.asarray(psi, np.float64),
        is_compressed=is_compressed,
    )


def encode_fatcube(m: FatcubeMap) -> bytes:
    """Encode to the reference-compatible ``ffat_map_double`` wire format."""
    shell = bytearray()
    _encode_key(shell, 1, _WT_64BIT)
    shell.extend(struct.pack("<d", m.shell.cell_size))
    _encode_len_field(shell, 2, _encode_mat(list(m.shell.low_corners)))
    _encode_len_field(shell, 3, _encode_mat_i(list(m.shell.n_elements)))
    _encode_len_field(shell, 4, _encode_vec_i(m.shell.strides))
    _encode_len_field(shell, 5, _encode_vec(m.shell.center))
    _encode_len_field(shell, 6, _encode_vec(m.shell.bbox_low))
    _encode_len_field(shell, 7, _encode_vec(m.shell.bbox_top))

    map3 = bytearray()
    _encode_key(map3, 1, _WT_64BIT)
    map3.extend(struct.pack("<d", m.k))
    _encode_len_field(map3, 2, _encode_vec(m.center))
    _encode_len_field(map3, 3, bytes(shell))
    if m.is_compressed:
        _encode_key(map3, 4, _WT_VARINT)
        _write_varint(map3, 1)
    _encode_len_field(map3, 5, _encode_mat([np.asarray(m.psi, np.float64)]))
    if m.mode_id != 0:  # proto3 omits default-valued scalar fields
        _encode_key(map3, 6, _WT_VARINT)
        _write_varint(map3, int(m.mode_id))

    out = bytearray()
    _encode_len_field(out, 1, bytes(map3))
    return bytes(out)


def load_fatcube(path: str) -> FatcubeMap:
    with open(path, "rb") as f:
        return decode_fatcube(f.read())


def save_fatcube(path: str, m: FatcubeMap) -> None:
    with open(path, "wb") as f:
        f.write(encode_fatcube(m))


def load_all_fatcubes(dirname: str) -> dict[int, FatcubeMap]:
    """Load every ``*.fatcube`` in a directory keyed by mode id.

    Mirrors reference FFAT_Map_Serialize::LoadAll (ffat_map_serialize.h:267-279).
    """
    out: dict[int, FatcubeMap] = {}
    if not os.path.isdir(dirname):
        return out
    for name in sorted(os.listdir(dirname)):
        if name.endswith(".fatcube"):
            m = load_fatcube(os.path.join(dirname, name))
            out[m.mode_id] = m
    return out
