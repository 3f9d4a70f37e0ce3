"""Container demuxing: IVF, length-delimited annexb, and low-overhead
raw OBU streams (section 5).

Capability parity with reference tools/input/ (ivf.c, annexb.c,
section5.c), incl. the same probe logic."""

from __future__ import annotations

import struct


def probe_ivf(data: bytes) -> bool:
    return data[:4] == b"DKIF" and data[8:12] == b"AV01"


def read_ivf(data: bytes):
    """Yields (frame_bytes, pts) per temporal unit."""
    if not probe_ivf(data):
        raise ValueError("not an AV01 IVF file")
    (hdr_sz,) = struct.unpack_from("<H", data, 6)
    pos = hdr_sz
    while pos + 12 <= len(data):
        sz, pts = struct.unpack_from("<IQ", data, pos)
        pos += 12
        yield data[pos : pos + sz], pts
        pos += sz


def ivf_meta(data: bytes):
    w, h = struct.unpack_from("<HH", data, 12)
    num, den = struct.unpack_from("<II", data, 16)
    return w, h, num, den


def _leb128(data: bytes, pos: int):
    v = 0
    for i in range(8):
        if pos >= len(data):
            raise ValueError("leb128 overrun")
        byte = data[pos]
        pos += 1
        v |= (byte & 0x7F) << (i * 7)
        if not (byte & 0x80):
            break
    return v, pos


def _write_leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _resize_obu(data: bytes) -> bytes:
    """Rewrite one size-less OBU with obu_has_size_field set (the decoder
    core consumes length-field OBUs, like dav1d's annexb demuxer +
    dav1d_parse_obus pairing)."""
    hdr_len = 2 if data[0] & 0x04 else 1  # extension flag
    hdr = bytearray(data[:hdr_len])
    hdr[0] |= 0x02  # obu_has_size_field
    payload = data[hdr_len:]
    return bytes(hdr) + _write_leb128(len(payload)) + payload


def probe_annexb(data: bytes) -> bool:
    """reference tools/input/annexb.c:probe: walk the length hierarchy and
    require a first OBU of type TD then SEQ_HDR without size fields."""
    try:
        tu_sz, pos = _leb128(data, 0)
        fu_sz, pos = _leb128(data, pos)
        obu_sz, pos = _leb128(data, pos)
        hdr = data[pos]
        if hdr & 0x80 or (hdr & 0x02):
            return False
        return ((hdr >> 3) & 0xF) == 2  # OBU_TD first
    except (ValueError, IndexError):
        return False


def read_annexb(data: bytes):
    """Yields (temporal_unit_bytes, index) with OBUs rewritten to the
    length-field format."""
    pos = 0
    idx = 0
    while pos < len(data):
        tu_sz, pos = _leb128(data, pos)
        tu_end = pos + tu_sz
        out = bytearray()
        while pos < tu_end:
            fu_sz, pos = _leb128(data, pos)
            fu_end = pos + fu_sz
            while pos < fu_end:
                obu_sz, pos = _leb128(data, pos)
                out += _resize_obu(data[pos : pos + obu_sz])
                pos += obu_sz
        yield bytes(out), idx
        idx += 1


def probe_section5(data: bytes) -> bool:
    """reference tools/input/section5.c:probe: first OBU must be a TD with
    a size field of 0, followed by a sequence header."""
    if len(data) < 4:
        return False
    if data[0] & 0x80 or not (data[0] & 0x02):
        return False
    if ((data[0] >> 3) & 0xF) != 2 or data[1] != 0:
        return False
    return ((data[2] >> 3) & 0xF) == 1  # SEQ_HDR next


def read_section5(data: bytes):
    """Yields (temporal_unit_bytes, index): OBUs in length-field format,
    temporal units delimited by TD OBUs."""
    from .getbits import GetBits
    pos = 0
    start = 0
    idx = 0
    n = len(data)
    while pos < n:
        hdr = data[pos]
        ty = (hdr >> 3) & 0xF
        has_ext = bool(hdr & 0x04)
        p = pos + 1 + has_ext
        sz, p = _leb128(data, p)
        obu_end = p + sz
        if ty == 2 and pos != start:  # TD: previous TU complete
            yield data[start:pos], idx
            idx += 1
            start = pos
        pos = obu_end
    if pos > start:
        yield data[start:pos], idx


def open_stream(data: bytes):
    """Probe-based demuxer selection (reference tools/input/input.c)."""
    if probe_ivf(data):
        return read_ivf(data)
    if probe_annexb(data):
        return read_annexb(data)
    if probe_section5(data):
        return read_section5(data)
    raise ValueError("unknown container format")
