"""MSAC — the AV1 non-adaptive-binary/multi-symbol range decoder.

Bit-exact reimplementation of the AV1 spec's symbol decoder (spec 8.2) with
the reference's windowed formulation (reference src/msac.c:36-220): 64-bit
complemented window `dif`, 16-bit range `rng`, Q15 inverse CDFs with a
trailing adaptation counter, EC_PROB_SHIFT=6 / EC_MIN_PROB=4, and the
per-call CDF update rule rate = 4 + (count>>4) + (n_symbols>2).

This Python implementation is the reference/fallback; a C++ fast path with
identical semantics backs the production entropy-decode loop (see
dav1d_tpu/native/).
"""

from __future__ import annotations

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
EC_WIN_SIZE = 64
_MASK64 = (1 << 64) - 1


class Msac:
    __slots__ = ("data", "pos", "end", "dif", "rng", "cnt", "allow_update_cdf")

    def __init__(self, data, start: int = 0, end: int | None = None,
                 disable_cdf_update: bool = False):
        self.data = data
        self.pos = start
        self.end = len(data) if end is None else end
        self.dif = 0
        self.rng = 0x8000
        self.cnt = -15
        self.allow_update_cdf = not disable_cdf_update
        self._refill()

    # -- window management -------------------------------------------------

    def _refill(self) -> None:
        c = EC_WIN_SIZE - self.cnt - 24
        dif = self.dif
        pos, end, data = self.pos, self.end, self.data
        while True:
            if pos >= end:
                dif |= (~(~0xFF << c)) & _MASK64  # remaining bits read as 1
                break
            dif |= (data[pos] ^ 0xFF) << c
            pos += 1
            c -= 8
            if c < 0:
                break
        self.dif = dif & _MASK64
        self.cnt = EC_WIN_SIZE - c - 24
        self.pos = pos

    def _norm(self, dif: int, rng: int) -> None:
        d = 16 - rng.bit_length()
        cnt = self.cnt
        self.dif = (dif << d) & _MASK64
        self.rng = rng << d
        self.cnt = cnt - d
        # unsigned compare in the reference: negative cnt (past eob) never
        # triggers another refill
        if 0 <= cnt < d:
            self._refill()

    # -- primitives ---------------------------------------------------------

    def decode_bool_equi(self) -> int:
        r = self.rng
        dif = self.dif
        v = ((r >> 8) << 7) + EC_MIN_PROB
        vw = v << (EC_WIN_SIZE - 16)
        if dif >= vw:
            dif -= vw
            v = r - v
            ret = 0
        else:
            ret = 1
        self._norm(dif, v)
        return ret

    def decode_bool(self, f: int) -> int:
        r = self.rng
        dif = self.dif
        v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        vw = v << (EC_WIN_SIZE - 16)
        if dif >= vw:
            dif -= vw
            v = r - v
            ret = 0
        else:
            ret = 1
        self._norm(dif, v)
        return ret

    def decode_symbol_adapt(self, cdf, n_symbols: int) -> int:
        """cdf: mutable uint16 sequence (numpy view); count at cdf[n_symbols]."""
        c = self.dif >> (EC_WIN_SIZE - 16)
        r = self.rng >> 8
        val = -1
        v = self.rng
        while True:
            val += 1
            u = v
            v = (r * (int(cdf[val]) >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)
            v += EC_MIN_PROB * (n_symbols - val)
            if c >= v:
                break
        self._norm(self.dif - (v << (EC_WIN_SIZE - 16)), u - v)

        if self.allow_update_cdf:
            count = int(cdf[n_symbols])
            rate = 4 + (count >> 4) + (1 if n_symbols > 2 else 0)
            for i in range(val):
                cdf[i] = int(cdf[i]) + ((32768 - int(cdf[i])) >> rate)
            for i in range(val, n_symbols):
                cdf[i] = int(cdf[i]) - (int(cdf[i]) >> rate)
            cdf[n_symbols] = count + (1 if count < 32 else 0)
        return val

    def decode_bool_adapt(self, cdf) -> int:
        bit = self.decode_bool(int(cdf[0]))
        if self.allow_update_cdf:
            count = int(cdf[1])
            rate = 4 + (count >> 4)
            if bit:
                cdf[0] = int(cdf[0]) + ((32768 - int(cdf[0])) >> rate)
            else:
                cdf[0] = int(cdf[0]) - (int(cdf[0]) >> rate)
            cdf[1] = count + (1 if count < 32 else 0)
        return bit

    def decode_hi_tok(self, cdf) -> int:
        """Coefficient hi-token: up to 4 chained 4-symbol reads
        (reference src/msac.c:188-204)."""
        tok_br = self.decode_symbol_adapt(cdf, 3)
        tok = 3 + tok_br
        if tok_br == 3:
            tok_br = self.decode_symbol_adapt(cdf, 3)
            tok = 6 + tok_br
            if tok_br == 3:
                tok_br = self.decode_symbol_adapt(cdf, 3)
                tok = 9 + tok_br
                if tok_br == 3:
                    tok = 12 + self.decode_symbol_adapt(cdf, 3)
        return tok

    # -- composites ----------------------------------------------------------

    def decode_bools(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bool_equi()
        return v

    def decode_uniform(self, n: int) -> int:
        """ns(n) via equiprobable bools."""
        l = n.bit_length()  # ulog2(n) + 1
        m = (1 << l) - n
        v = self.decode_bools(l - 1)
        return v if v < m else (v << 1) - m + self.decode_bool_equi()

    def decode_subexp(self, ref: int, n: int, k: int) -> int:
        a = 0
        if self.decode_bool_equi():
            if self.decode_bool_equi():
                k += self.decode_bool_equi() + 1
            a = 1 << k
        v = self.decode_bools(k) + a
        if ref * 2 <= n:
            return _inv_recenter(ref, v)
        return n - 1 - _inv_recenter(n - 1 - ref, v)


def _inv_recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return (v >> 1) + r


# --- native fast path --------------------------------------------------------

from .native import CMsac, lib as _native  # noqa: E402

if _native is not None:
    import ctypes

    class MsacNative:
        """ctypes front-end to the C MSAC core (bit-identical to Msac)."""

        __slots__ = ("s", "_data")

        def __init__(self, data, start: int = 0, end: int | None = None,
                     disable_cdf_update: bool = False):
            self._data = data  # keep the buffer alive
            self.s = CMsac()
            buf = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p)
            _native.dtpu_msac_init(
                ctypes.byref(self.s), buf, start,
                len(data) if end is None else end,
                int(disable_cdf_update))

        @property
        def rng(self):
            return self.s.rng

        @property
        def cnt(self):
            return self.s.cnt

        @property
        def dif(self):
            return self.s.dif

        @property
        def allow_update_cdf(self):
            return bool(self.s.allow_update_cdf)

        def decode_bool_equi(self):
            return _native.dtpu_decode_bool_equi(ctypes.byref(self.s))

        def decode_bool(self, f):
            return _native.dtpu_decode_bool(ctypes.byref(self.s), f)

        def decode_bool_adapt(self, cdf):
            return _native.dtpu_decode_bool_adapt(
                ctypes.byref(self.s), cdf.ctypes.data)

        def decode_symbol_adapt(self, cdf, n_symbols):
            return _native.dtpu_decode_symbol_adapt(
                ctypes.byref(self.s), cdf.ctypes.data, n_symbols)

        def decode_hi_tok(self, cdf):
            return _native.dtpu_decode_hi_tok(
                ctypes.byref(self.s), cdf.ctypes.data)

        def decode_bools(self, n):
            return _native.dtpu_decode_bools(ctypes.byref(self.s), n)

        def decode_uniform(self, n):
            return _native.dtpu_decode_uniform(ctypes.byref(self.s), n)

        def decode_subexp(self, ref, n, k):
            return _native.dtpu_decode_subexp(ctypes.byref(self.s), ref,
                                              n, k)

    def make_msac(data, start=0, end=None, disable_cdf_update=False):
        return MsacNative(data, start, end, disable_cdf_update)
else:
    MsacNative = None

    def make_msac(data, start=0, end=None, disable_cdf_update=False):
        return Msac(data, start, end, disable_cdf_update)
