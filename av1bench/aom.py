"""ctypes bindings to the system libaom: its AV1 encoder, which makes the
benchmark's clips, and its AV1 decoder, the independent decoder whose
output the committed reference digests record.

Used by ``make_streams.py`` and the CPU tests only: the machine that runs
the benchmark has no libaom, and nothing that ``run.py`` runs imports this
module.

No libaom headers are needed.  ``aom_codec_enc_cfg_t`` is located by
fingerprinting its documented defaults (320x240, timebase 1/30,
kf_max_dist 9999, rc buffer 6000/4000/5000) after
``aom_codec_enc_config_default`` fills a generously sized buffer; every
located field is checked against a second known default.  The encoder
and decoder ABI versions are found by probing ``aom_codec_*_init_ver``
until it stops returning ``AOM_CODEC_ABI_MISMATCH``.  AV1 knobs go
through the string-based ``aom_codec_set_option``.  ``aom_image_t`` is
declared only up to the fields read here.
"""

from __future__ import annotations

import ctypes

import numpy as np

AOM_CODEC_OK = 0
AOM_CODEC_ABI_MISMATCH = 3
AOM_CODEC_CX_FRAME_PKT = 0
AOM_CODEC_USE_HIGHBITDEPTH = 0x40000
AOM_IMG_FMT_PLANAR = 0x100
AOM_IMG_FMT_HIGHBITDEPTH = 0x800
IMG_FMT_420 = AOM_IMG_FMT_PLANAR | 2
USAGE = {"good": 0, "realtime": 1, "allintra": 2}
LIB = "libaom.so.3"

_lib = None


class AomImage(ctypes.Structure):
    """Prefix of ``aom_image_t`` (libaom's public ABI), up to ``stride``."""
    _fields_ = [
        ("fmt", ctypes.c_uint), ("cp", ctypes.c_uint), ("tc", ctypes.c_uint),
        ("mc", ctypes.c_uint), ("monochrome", ctypes.c_int),
        ("csp", ctypes.c_uint), ("range", ctypes.c_uint),
        ("w", ctypes.c_uint), ("h", ctypes.c_uint),
        ("bit_depth", ctypes.c_uint),
        ("d_w", ctypes.c_uint), ("d_h", ctypes.c_uint),
        ("r_w", ctypes.c_uint), ("r_h", ctypes.c_uint),
        ("x_chroma_shift", ctypes.c_uint), ("y_chroma_shift", ctypes.c_uint),
        ("planes", ctypes.c_void_p * 3), ("stride", ctypes.c_int * 3),
        ("_tail", ctypes.c_byte * 256),
    ]


class CxPkt(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("_pad", ctypes.c_int),
                ("buf", ctypes.c_void_p), ("sz", ctypes.c_size_t),
                ("pts", ctypes.c_longlong), ("duration", ctypes.c_ulong),
                ("flags", ctypes.c_uint), ("partition_id", ctypes.c_int)]


class DecCfg(ctypes.Structure):
    """``aom_codec_dec_cfg_t``."""
    _fields_ = [("threads", ctypes.c_uint), ("w", ctypes.c_uint),
                ("h", ctypes.c_uint), ("allow_lowbitdepth", ctypes.c_uint)]


def load():
    """The libaom library with the prototypes used here declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(LIB)
    vp, u, c = ctypes.c_void_p, ctypes.c_uint, ctypes.c_char_p
    lib.aom_codec_av1_cx.restype = vp
    lib.aom_codec_av1_dx.restype = vp
    lib.aom_codec_enc_config_default.argtypes = [vp, vp, u]
    lib.aom_codec_enc_init_ver.argtypes = [vp, vp, vp, ctypes.c_long,
                                           ctypes.c_int]
    lib.aom_codec_dec_init_ver.argtypes = [vp, vp, ctypes.POINTER(DecCfg),
                                           ctypes.c_long, ctypes.c_int]
    lib.aom_codec_set_option.argtypes = [vp, c, c]
    lib.aom_codec_encode.argtypes = [vp, vp, ctypes.c_longlong,
                                     ctypes.c_ulong, ctypes.c_long]
    lib.aom_codec_get_cx_data.restype = ctypes.POINTER(CxPkt)
    lib.aom_codec_get_cx_data.argtypes = [vp, ctypes.POINTER(vp)]
    lib.aom_codec_decode.argtypes = [vp, c, ctypes.c_size_t, vp]
    lib.aom_codec_get_frame.restype = ctypes.POINTER(AomImage)
    lib.aom_codec_get_frame.argtypes = [vp, ctypes.POINTER(vp)]
    lib.aom_codec_destroy.argtypes = [vp]
    lib.aom_codec_error_detail.restype = c
    lib.aom_codec_error_detail.argtypes = [vp]
    lib.aom_img_alloc.restype = ctypes.POINTER(AomImage)
    lib.aom_img_alloc.argtypes = [vp, u, u, u, u]
    lib.aom_img_free.argtypes = [ctypes.POINTER(AomImage)]
    _lib = lib
    return lib


_CFG_BYTES = 1 << 14


class _CfgMap:
    """Field offsets (in 32-bit words) of ``aom_codec_enc_cfg_t``, found by
    fingerprint."""

    def __init__(self, buf: bytes):
        w = np.frombuffer(buf, np.uint32)

        def find(pred, what):
            hits = [i for i in range(len(w) - 24) if pred(i)]
            if len(hits) != 1:
                raise RuntimeError(f"cfg fingerprint {what!r}: {hits}")
            return hits[0]

        gw = find(lambda i: (w[i] == 320 and w[i + 1] == 240
                             and w[i + 5] == 8 and w[i + 6] == 8
                             and w[i + 7] == 1 and w[i + 8] == 30), "g_w")
        self.g_threads, self.g_profile = gw - 2, gw - 1
        self.g_w, self.g_h = gw, gw + 1
        self.g_bit_depth, self.g_input_bit_depth = gw + 5, gw + 6
        self.g_timebase_num, self.g_timebase_den = gw + 7, gw + 8
        self.g_lag_in_frames = gw + 11
        self.rc_end_usage = gw + 21
        if w[gw + 14] != 8 or w[gw + 17] != 8 or w[gw + 19] != 63:
            raise RuntimeError("cfg rc_resize / superres fingerprint mismatch")
        rt = find(lambda i: (i > gw + 21 and w[i] == 256 and w[i + 1] == 0
                             and w[i + 2] == 63 and w[i + 5] == 6000
                             and w[i + 6] == 4000 and w[i + 7] == 5000),
                  "rc_target_bitrate")
        self.rc_target_bitrate = rt
        kf = find(lambda i: (i > rt and w[i] == 9999 and w[i - 1] <= 12
                             and w[i - 2] <= 1), "kf_max_dist")
        self.kf_mode, self.kf_min_dist, self.kf_max_dist = kf - 2, kf - 1, kf
        if w[kf + 3] != 0 or w[kf + 4] != 0 or w[kf + 6] != 0:
            raise RuntimeError("cfg kf / monochrome fingerprint mismatch")


def _abi_version(init, *args) -> int:
    for ver in range(64):
        ctx = ctypes.create_string_buffer(512)
        rc = init(ctx, *args, ver)
        if rc == AOM_CODEC_OK:
            load().aom_codec_destroy(ctx)
            return ver
        if rc != AOM_CODEC_ABI_MISMATCH:
            raise RuntimeError(f"codec init probe failed: {rc}")
    raise RuntimeError("no compatible libaom ABI version")


class Encoder:
    """libaom AV1 encoder of 4:2:0 frames ``[y, u, v]`` (numpy, values in
    ``[0, 2**bitdepth)``), one pass, VBR at ``kbps``."""

    def __init__(self, width, height, *, bitdepth, fps_num, fps_den, kbps,
                 kf_max_dist, lag, cpu_used, usage="good", threads=8,
                 options=None):
        lib = load()
        self.lib, self.width, self.height = lib, width, height
        self.bitdepth = bitdepth
        iface = lib.aom_codec_av1_cx()
        probe = ctypes.create_string_buffer(_CFG_BYTES)
        if lib.aom_codec_enc_config_default(iface, probe, USAGE["good"]):
            raise RuntimeError("aom_codec_enc_config_default failed")
        m = _CfgMap(bytes(probe.raw))
        cfg = ctypes.create_string_buffer(_CFG_BYTES)
        if lib.aom_codec_enc_config_default(iface, cfg, USAGE[usage]):
            raise RuntimeError("aom_codec_enc_config_default failed")
        w = (ctypes.c_uint * (_CFG_BYTES // 4)).from_buffer(cfg)
        w[m.g_profile] = 0
        w[m.g_w], w[m.g_h] = width, height
        w[m.g_bit_depth] = w[m.g_input_bit_depth] = bitdepth
        w[m.g_timebase_num], w[m.g_timebase_den] = fps_den, fps_num
        w[m.g_threads] = threads
        w[m.g_lag_in_frames] = lag
        w[m.kf_mode], w[m.kf_min_dist], w[m.kf_max_dist] = 1, 0, kf_max_dist
        w[m.rc_end_usage] = 0  # AOM_VBR
        w[m.rc_target_bitrate] = kbps
        flags = AOM_CODEC_USE_HIGHBITDEPTH if bitdepth > 8 else 0
        ver = _abi_version(lib.aom_codec_enc_init_ver, iface, cfg, flags)
        self.ctx = ctypes.create_string_buffer(512)
        if lib.aom_codec_enc_init_ver(self.ctx, iface, cfg, flags, ver):
            raise RuntimeError("aom_codec_enc_init_ver failed")
        for k, v in {"cpu-used": cpu_used, **(options or {})}.items():
            if lib.aom_codec_set_option(self.ctx, str(k).encode(),
                                        str(v).encode()):
                detail = lib.aom_codec_error_detail(self.ctx) or b""
                raise RuntimeError(f"set_option {k}={v}: {detail.decode()}")
        fmt = IMG_FMT_420 | (AOM_IMG_FMT_HIGHBITDEPTH if bitdepth > 8 else 0)
        self.img = lib.aom_img_alloc(None, fmt, width, height, 32)
        im = self.img.contents
        if (im.w < width or im.h < height or im.x_chroma_shift != 1
                or im.y_chroma_shift != 1):
            raise RuntimeError("aom_image_t ABI check failed")
        self.pts = 0
        self.out = []

    def _fill(self, planes) -> None:
        im = self.img.contents
        dt = np.uint8 if self.bitdepth == 8 else np.uint16
        for pl, arr in enumerate(planes):
            arr = np.asarray(arr).astype(dt)
            h, wd = arr.shape
            stride = im.stride[pl]
            dst = (ctypes.c_char * (stride * h)).from_address(im.planes[pl])
            np.frombuffer(dst, dt).reshape(h, stride // arr.itemsize)[
                :, :wd] = arr

    def _drain(self) -> None:
        it = ctypes.c_void_p(None)
        while pkt := self.lib.aom_codec_get_cx_data(self.ctx,
                                                    ctypes.byref(it)):
            p = pkt.contents
            if p.kind == AOM_CODEC_CX_FRAME_PKT:
                self.out.append((p.pts, ctypes.string_at(p.buf, p.sz)))

    def encode(self, planes) -> None:
        self._fill(planes)
        if self.lib.aom_codec_encode(self.ctx, self.img, self.pts, 1, 0):
            detail = self.lib.aom_codec_error_detail(self.ctx) or b""
            raise RuntimeError(f"encode failed: {detail.decode()}")
        self.pts += 1
        self._drain()

    def finish(self) -> list:
        """Flush the encoder; the temporal units as (pts, bytes)."""
        while True:
            n = len(self.out)
            if self.lib.aom_codec_encode(self.ctx, None, self.pts, 1, 0):
                raise RuntimeError("encoder flush failed")
            self._drain()
            if len(self.out) == n:
                break
        self.lib.aom_img_free(self.img)
        self.lib.aom_codec_destroy(self.ctx)
        return sorted(self.out, key=lambda t: t[0])


def decode(units):
    """libaom's decode of ``units`` (temporal-unit bytes): for each unit
    the list of pictures it output, each a list of numpy planes (uint8 at
    8-bit, uint16 above) at the display size, with film grain applied as
    libaom's decoder applies it by default."""
    lib = load()
    iface = lib.aom_codec_av1_dx()
    cfg = DecCfg(threads=1, w=0, h=0, allow_lowbitdepth=1)
    ver = _abi_version(lib.aom_codec_dec_init_ver, iface,
                       ctypes.byref(cfg), 0)
    ctx = ctypes.create_string_buffer(512)
    if lib.aom_codec_dec_init_ver(ctx, iface, ctypes.byref(cfg), 0, ver):
        raise RuntimeError("aom_codec_dec_init_ver failed")
    out = []
    try:
        for tu in units:
            if lib.aom_codec_decode(ctx, tu, len(tu), None):
                detail = lib.aom_codec_error_detail(ctx) or b""
                raise RuntimeError(f"libaom decode failed: {detail.decode()}")
            it = ctypes.c_void_p(None)
            pics = []
            while img := lib.aom_codec_get_frame(ctx, ctypes.byref(it)):
                pics.append(_planes(img.contents))
            out.append(pics)
    finally:
        lib.aom_codec_destroy(ctx)
    return out


def _planes(im: AomImage) -> list:
    wide = bool(im.fmt & AOM_IMG_FMT_HIGHBITDEPTH)
    src_dt = np.uint16 if wide else np.uint8
    out_dt = np.uint8 if im.bit_depth == 8 else np.uint16
    planes = []
    for pl in range(1 if im.monochrome else 3):
        ss_x = im.x_chroma_shift if pl else 0
        ss_y = im.y_chroma_shift if pl else 0
        w = (im.d_w + ss_x) >> ss_x
        h = (im.d_h + ss_y) >> ss_y
        stride = im.stride[pl]
        buf = (ctypes.c_char * (stride * h)).from_address(im.planes[pl])
        arr = np.frombuffer(buf, src_dt).reshape(h, stride // src_dt(0).itemsize)
        planes.append(arr[:, :w].astype(out_dt))
    return planes
