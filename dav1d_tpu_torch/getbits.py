"""MSB-first bitstream reader for OBU/header parsing.

Semantics match the AV1 spec descriptors (f(n), su(n), uvlc, leb128, ns(n),
subexp) and the reference reader's error model: reads past the end set a
sticky ``error`` flag and return 0-bits rather than raising, so header
parsing can fail gracefully (reference: src/getbits.c:36-170).
"""

from __future__ import annotations


class GetBits:
    __slots__ = ("data", "pos", "nbits", "error")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.nbits = len(data) * 8
        self.error = 0

    def get_bit(self) -> int:
        if self.pos >= self.nbits:
            self.error = 1
            return 0
        p = self.pos
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def get_bits(self, n: int) -> int:
        """f(n): read n bits MSB-first as an unsigned integer."""
        if n == 0:
            return 0
        p = self.pos
        if p + n > self.nbits:
            self.error = 1
            # Mimic the reference: consume what exists, missing bits are 0.
            avail = max(0, self.nbits - p)
            v = self._peek(p, avail) << (n - avail) if avail else 0
            self.pos = self.nbits
            return v
        self.pos = p + n
        return self._peek(p, n)

    def _peek(self, p: int, n: int) -> int:
        end = p + n
        first = p >> 3
        last = (end + 7) >> 3
        chunk = int.from_bytes(self.data[first:last], "big")
        return (chunk >> ((last << 3) - end)) & ((1 << n) - 1)

    def get_sbits(self, n: int) -> int:
        """su(n): n-bit two's-complement signed value."""
        v = self.get_bits(n)
        sign = 1 << (n - 1)
        return v - (sign << 1) if v & sign else v

    def get_uleb128(self) -> int:
        """leb128(): up to 8 bytes, value must fit in 32 bits."""
        val = 0
        for i in range(8):
            b = self.get_bits(8)
            val |= (b & 0x7F) << (7 * i)
            if not (b & 0x80):
                break
        else:
            self.error = 1
            return 0
        if val > 0xFFFFFFFF:
            self.error = 1
            return 0
        return val

    def get_uniform(self, max_: int) -> int:
        """ns(n) non-symmetric value in [0, max_-1]; max_ > 1."""
        l = max_.bit_length()  # ulog2(max)+1
        m = (1 << l) - max_
        v = self.get_bits(l - 1)
        return v if v < m else (v << 1) - m + self.get_bit()

    def get_vlc(self) -> int:
        """uvlc(): exp-golomb style."""
        if self.get_bit():
            return 0
        n_bits = 1
        while not self.get_bit():
            n_bits += 1
            if n_bits == 32:
                return 0xFFFFFFFF
        return ((1 << n_bits) - 1) + self.get_bits(n_bits)

    def _subexp_u(self, ref: int, n: int) -> int:
        v = 0
        i = 0
        while True:
            b = 3 + i - 1 if i else 3
            if n < v + 3 * (1 << b):
                v += self.get_uniform(n - v + 1)
                break
            if not self.get_bit():
                v += self.get_bits(b)
                break
            v += 1 << b
            i += 1
        if ref * 2 <= n:
            return _inv_recenter(ref, v)
        return n - _inv_recenter(n - ref, v)

    def get_bits_subexp(self, ref: int, n: int) -> int:
        return self._subexp_u(ref + (1 << n), 2 << n) - (1 << n)

    def bytealign(self) -> None:
        self.pos = (self.pos + 7) & ~7

    @property
    def bit_pos(self) -> int:
        return self.pos

    def byte_pos(self) -> int:
        return (self.pos + 7) >> 3


def _inv_recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return (v >> 1) + r
