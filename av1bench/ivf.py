"""IVF reading and writing, and what the benchmark needs to know of a
temporal unit's OBUs, without the program under test."""

from __future__ import annotations

import struct

# OBU types (AV1 spec 5.3.1)
OBU_SEQUENCE_HEADER = 1
OBU_FRAME_HEADER = 3
OBU_FRAME = 6


def read(data: bytes) -> list:
    """The temporal units of an IVF file, as bytes."""
    if data[:4] != b"DKIF":
        raise ValueError("not an IVF file")
    (hdr,) = struct.unpack_from("<H", data, 6)
    pos, units = hdr, []
    while pos + 12 <= len(data):
        (size,) = struct.unpack_from("<I", data, pos)
        units.append(data[pos + 12:pos + 12 + size])
        pos += 12 + size
    return units


def write(path, units, width, height, fps_num, fps_den) -> None:
    """An IVF file of ``units`` with pts 0, 1, ... (timebase fps_den /
    fps_num)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<4sHH4sHHIII", b"DKIF", 0, 32, b"AV01", width,
                            height, fps_num, fps_den, len(units)))
        f.write(b"\0\0\0\0")
        for pts, data in enumerate(units):
            f.write(struct.pack("<IQ", len(data), pts))
            f.write(data)


def _leb128(data: bytes, pos: int):
    v = 0
    for i in range(8):
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            break
    return v, pos


def obus(tu: bytes):
    """(type, payload) of each OBU of a temporal unit (every OBU carries
    its size field, as libaom writes them)."""
    pos = 0
    while pos < len(tu):
        head = tu[pos]
        kind, ext, has_size = (head >> 3) & 15, (head >> 2) & 1, (head >> 1) & 1
        pos += 1 + ext
        if not has_size:
            raise ValueError("OBU without a size field")
        size, pos = _leb128(tu, pos)
        yield kind, tu[pos:pos + size]
        pos += size


def frames_decoded(tu: bytes) -> int:
    """Frames a decoder reconstructs for the unit: each frame OBU, and
    each frame header OBU that is not ``show_existing_frame`` (its first
    bit, in a stream without ``reduced_still_picture_header``)."""
    n = 0
    for kind, payload in obus(tu):
        if kind == OBU_FRAME or (kind == OBU_FRAME_HEADER
                                 and not payload[0] >> 7):
            n += 1
    return n


def shows_existing(tu: bytes) -> bool:
    """Whether the unit shows a frame decoded earlier
    (``show_existing_frame``)."""
    return any(kind == OBU_FRAME_HEADER and payload[0] >> 7
               for kind, payload in obus(tu))
