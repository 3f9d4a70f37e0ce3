"""Native (C) entropy-decode core: build-on-import + ctypes bindings.

The host side of the decoder is Amdahl-bound by the serial MSAC symbol
loop (SURVEY.md §7 design stance); this module provides the C fast path
with bit-identical semantics to dav1d_tpu.msac / recon.coef. Set
DAV1D_TPU_NO_NATIVE=1 to force the pure-Python reference path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

_HERE = Path(__file__).parent
_SRCS = [_HERE / "msac_coef.c", _HERE / "filters.c", _HERE / "lf.c",
         _HERE / "refmvs.c", _HERE / "decode.c",
         _HERE / "replay.c", _HERE / "replay_inter.c", _HERE / "fg.c"]
_HDRS = [_HERE / "dtpu.h", _HERE / "lf_core.h"]
# the package's build directory (listed in .gitignore), beside the CUDA
# kernels' library (kernels/build.py)
_BUILD_DIR = _HERE.parent / "_build"


def _build() -> Path | None:
    src = b"".join(p.read_bytes() for p in _SRCS + _HDRS)
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _BUILD_DIR / f"dav1d_tpu_torch_native_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one build per tag at a time (the test workers import the package
    # together); the first process to hold the lock builds, the others
    # find its library
    with open(_BUILD_DIR / f"native_{tag}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        return _compile(out)


def _compile(out: Path) -> Path | None:
    # -march=native: the .so is built on import per host (hash-tagged),
    # so host-specific codegen is always safe; retried without in case
    # the local cc doesn't support it.  Built under a temporary name and
    # renamed, so no process loads a partial file.
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    for extra in (["-march=native"], []):
        try:
            subprocess.run(
                ["cc", "-O3", *extra, "-shared", "-fPIC", "-std=c11",
                 *map(str, _SRCS), "-o", str(tmp)],
                check=True, capture_output=True)
            os.replace(tmp, out)
            return out
        except subprocess.CalledProcessError as e:
            if extra:
                continue
            import sys  # loud: a silent fallback masks a 4x perf loss
            print("dav1d_tpu: native build FAILED, using Python fallback:\n"
                  + e.stderr.decode(errors="replace")[:2000],
                  file=sys.stderr)
            return None
        except Exception:
            return None
    return None


class DtpuCoefCtx(ctypes.Structure):
    """Mirror of native/msac_coef.c DtpuCoefCtx (per-tile pointer set for
    the one-call coefficient decode)."""
    _fields_ = [
        ("skip", ctypes.c_void_p),
        ("txtp_intra1", ctypes.c_void_p),
        ("txtp_intra2", ctypes.c_void_p),
        ("txtp_inter1", ctypes.c_void_p),
        ("txtp_inter2", ctypes.c_void_p),
        ("txtp_inter3", ctypes.c_void_p),
        ("eob_bin", ctypes.c_void_p * 7),
        ("eob_hi_bit", ctypes.c_void_p),
        ("eob_base_tok", ctypes.c_void_p),
        ("base_tok", ctypes.c_void_p),
        ("br_tok", ctypes.c_void_p),
        ("dc_sign", ctypes.c_void_p),
        ("txfm_info", ctypes.c_void_p),
        ("block_dim", ctypes.c_void_p),
        ("skip_ctx_tbl", ctypes.c_void_p),
        ("txtp_from_uvmode", ctypes.c_void_p),
        ("tx_types_per_set", ctypes.c_void_p),
        ("tx_type_class", ctypes.c_void_p),
        ("lo_ctx_offsets", ctypes.c_void_p),
        ("scans", ctypes.c_void_p * 19),
        ("layout", ctypes.c_int32),
        ("cf_max", ctypes.c_uint32),
    ]


class CMsac(ctypes.Structure):
    _fields_ = [
        ("buf", ctypes.c_void_p),
        ("pos", ctypes.c_uint64),
        ("end", ctypes.c_uint64),
        ("dif", ctypes.c_uint64),
        ("rng", ctypes.c_uint32),
        ("cnt", ctypes.c_int32),
        ("allow_update_cdf", ctypes.c_int32),
    ]


class CGmv(ctypes.Structure):
    """Mirror of native/dtpu.h DtpuGmv."""
    _fields_ = [("type", ctypes.c_int32), ("matrix", ctypes.c_int32 * 6)]


class CFgData(ctypes.Structure):
    """Mirror of native/dtpu.h DtpuFgData (headers.py FilmGrainData)."""
    _fields_ = [
        ("seed", ctypes.c_int32),
        ("num_y_points", ctypes.c_int32),
        ("chroma_scaling_from_luma", ctypes.c_int32),
        ("num_uv_points", ctypes.c_int32 * 2),
        ("scaling_shift", ctypes.c_int32),
        ("ar_coeff_lag", ctypes.c_int32),
        ("ar_coeff_shift", ctypes.c_int32),
        ("grain_scale_shift", ctypes.c_int32),
        ("uv_mult", ctypes.c_int32 * 2),
        ("uv_luma_mult", ctypes.c_int32 * 2),
        ("uv_offset", ctypes.c_int32 * 2),
        ("overlap_flag", ctypes.c_int32),
        ("clip_to_restricted_range", ctypes.c_int32),
        ("y_points", (ctypes.c_uint8 * 2) * 14),
        ("uv_points", ((ctypes.c_uint8 * 2) * 10) * 2),
        ("ar_coeffs_y", ctypes.c_int32 * 24),
        ("ar_coeffs_uv", (ctypes.c_int32 * 28) * 2),
    ]


class CRefMvsFrame(ctypes.Structure):
    """Mirror of native/dtpu.h DtpuRefMvsFrame."""
    _fields_ = [
        ("r", ctypes.c_void_p),
        ("rp", ctypes.c_void_p),
        ("rp_ref", ctypes.c_void_p * 7),
        ("rp_proj", ctypes.c_void_p),
        ("r_stride", ctypes.c_int32), ("rp_stride", ctypes.c_int32),
        ("iw4", ctypes.c_int32), ("ih4", ctypes.c_int32),
        ("iw8", ctypes.c_int32), ("ih8", ctypes.c_int32),
        ("sign_bias", ctypes.c_int32 * 7),
        ("mfmv_sign", ctypes.c_int32 * 7),
        ("pocdiff", ctypes.c_int32 * 7),
        ("n_mfmvs", ctypes.c_int32),
        ("mfmv_ref", ctypes.c_int32 * 3),
        ("mfmv_ref2cur", ctypes.c_int32 * 3),
        ("mfmv_ref2ref", (ctypes.c_int32 * 7) * 3),
        ("use_ref_frame_mvs", ctypes.c_int32),
        ("force_integer_mv", ctypes.c_int32),
        ("hp", ctypes.c_int32),
        ("use_frame_ref_mvs_hdr", ctypes.c_int32),
        ("gmv", CGmv * 7),
    ]


def _load():
    if os.environ.get("DAV1D_TPU_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    P = ctypes.POINTER
    u16p = ctypes.c_void_p  # numpy .ctypes.data
    lib.dtpu_msac_init.argtypes = [P(CMsac), ctypes.c_void_p,
                                   ctypes.c_uint64, ctypes.c_uint64,
                                   ctypes.c_int]
    for name in ("dtpu_decode_bool_equi",):
        getattr(lib, name).argtypes = [P(CMsac)]
        getattr(lib, name).restype = ctypes.c_int
    lib.dtpu_decode_bool.argtypes = [P(CMsac), ctypes.c_uint]
    lib.dtpu_decode_bool.restype = ctypes.c_int
    lib.dtpu_decode_bool_adapt.argtypes = [P(CMsac), u16p]
    lib.dtpu_decode_bool_adapt.restype = ctypes.c_int
    lib.dtpu_decode_symbol_adapt.argtypes = [P(CMsac), u16p,
                                             ctypes.c_size_t]
    lib.dtpu_decode_symbol_adapt.restype = ctypes.c_int
    lib.dtpu_decode_hi_tok.argtypes = [P(CMsac), u16p]
    lib.dtpu_decode_hi_tok.restype = ctypes.c_int
    lib.dtpu_decode_bools.argtypes = [P(CMsac), ctypes.c_uint]
    lib.dtpu_decode_bools.restype = ctypes.c_uint
    lib.dtpu_decode_uniform.argtypes = [P(CMsac), ctypes.c_uint]
    lib.dtpu_decode_uniform.restype = ctypes.c_int
    lib.dtpu_decode_subexp.argtypes = [P(CMsac), ctypes.c_int, ctypes.c_int,
                                       ctypes.c_uint]
    lib.dtpu_decode_subexp.restype = ctypes.c_int
    lib.dtpu_decode_coefs_tail.argtypes = [
        P(CMsac),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u16p, ctypes.c_int,      # eob_bin cdf, nsym
        u16p, u16p, u16p, u16p, u16p,  # eob_hi, eob_base, base, br, dc_sign
        ctypes.c_void_p, ctypes.c_void_p,  # scan, lo_ctx_offsets
        ctypes.c_int,            # dc_sign_ctx
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_uint32,         # dq0, dq1, qm, dq_shift, cf_max
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.dtpu_decode_coefs_tail.restype = ctypes.c_int
    lib.dtpu_decode_coefs.argtypes = [
        ctypes.POINTER(DtpuCoefCtx), P(CMsac),
        ctypes.c_void_p, ctypes.c_int,        # a, a_off
        ctypes.c_void_p, ctypes.c_int,        # l, l_off
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ymode, uvmode, ytxtp
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # lossless, qidx, reduced
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # dq0, dq1, qm
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]  # cf, eob_out
    lib.dtpu_decode_coefs.restype = ctypes.c_int
    lib.dtpu_cdef_filter_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,              # canvas, stride
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # ys, xs, n
        ctypes.c_int, ctypes.c_int,                   # w, h
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pri, sec, dirs
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # damping, bd, out
    lib.dtpu_cdef_filter_batch.restype = None
    lib.dtpu_cdef_find_dir_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.dtpu_cdef_find_dir_batch.restype = None
    lib.dtpu_cdef_find_dir_pos.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,              # plane, stride
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # ys, xs, n
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]  # bd, dirs, vars
    lib.dtpu_cdef_find_dir_pos.restype = None
    lib.dtpu_cdef_filter_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,              # plane, stride
        ctypes.c_int, ctypes.c_int,                   # pw, ph
        ctypes.c_void_p,                              # canvas scratch
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # ys, xs, n
        ctypes.c_int, ctypes.c_int,                   # w, h
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pri, sec, dirs
        ctypes.c_int, ctypes.c_int]                   # damping, bd
    lib.dtpu_cdef_filter_plane.restype = None
    ci = ctypes.c_int
    lib.dtpu_put_8tap.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ci, ci, ci, ci, ci, ci,
        ctypes.c_void_p, ctypes.c_void_p,  # fh, fv (int64[8] or NULL)
        ci, ci, ci, ci, ctypes.c_void_p]   # ib, maxp, prep, bias, out
    lib.dtpu_put_8tap.restype = None
    lib.dtpu_put_8tap_into.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ci, ci, ci, ci, ci, ci,
        ctypes.c_void_p, ctypes.c_void_p,  # fh, fv (int64[8] or NULL)
        ci, ci, ctypes.c_void_p, ctypes.c_int64]  # ib, maxp, dst, stride
    lib.dtpu_put_8tap_into.restype = None
    lib.dtpu_warp8x8.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ci, ci, ci, ci,
        ctypes.c_void_p, ci, ci,           # abcd (int32[4]), mx, my
        ci, ci, ci, ci,                    # ib, maxp, prep, bias
        ctypes.c_void_p, ctypes.c_void_p]  # warp filter table, out
    lib.dtpu_warp8x8.restype = None
    lib.dtpu_ipred.argtypes = [
        ci, ctypes.c_void_p, ci, ci, ci, ci, ci, ci, ci,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # sm, dr, taps
        ctypes.c_void_p, ctypes.c_int64]                    # out, ostride
    lib.dtpu_ipred.restype = None
    lib.dtpu_lf_filter_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,             # plane, stride
        ctypes.c_void_p, ctypes.c_int64,             # wd plane, stride
        ctypes.c_void_p, ctypes.c_int64,             # level, row stride
        ci, ci, ci,                                  # pd_idx, rows, cols
        ctypes.c_void_p, ctypes.c_void_p,            # e_lut, i_lut
        ci, ci, ci]                                  # dir, is_uv, bitdepth
    lib.dtpu_lf_filter_plane.restype = None
    lib.dtpu_cdef_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # p0, p1, p2
        ctypes.c_int64, ctypes.c_int64,              # stride0, stride12
        ci, ci, ci, ci, ci,                          # bw, bh, ssh, ssv, chroma
        ctypes.c_void_p, ctypes.c_void_p,            # canvas0, canvas1
        ctypes.c_void_p, ctypes.c_int64,             # cdef_idx, stride
        ctypes.c_void_p, ctypes.c_int64,             # noskip, stride
        ctypes.c_void_p, ctypes.c_void_p,            # y_str, uv_str
        ctypes.c_void_p,                             # uv_dir_map
        ci, ci]                                      # damping, bitdepth
    lib.dtpu_cdef_frame.restype = ci
    lib.dtpu_fg_gen_y.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ci, ctypes.c_void_p]
    lib.dtpu_fg_gen_y.restype = None
    lib.dtpu_fg_gen_uv.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ci, ci, ci, ci, ctypes.c_void_p]
    lib.dtpu_fg_gen_uv.restype = None
    lib.dtpu_fg_scaling.argtypes = [
        ci, ctypes.c_void_p, ci, ctypes.c_void_p]
    lib.dtpu_fg_scaling.restype = None
    lib.dtpu_fg_apply_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,             # plane, stride
        ctypes.c_void_p, ctypes.c_int64, ci,         # luma, lstride, lw
        ci, ci, ci, ci, ci,                          # pl, w, h, subx, suby
        ctypes.c_void_p, ctypes.c_void_p,            # lut, sc
        ctypes.c_void_p, ci, ci]                     # data, bitdepth, is_id
    lib.dtpu_fg_apply_plane.restype = ci
    lib.dtpu_mask_edges_intra.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # wd_v/h, stride
        ci, ci, ci, ci, ci, ci, ci, ci,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.dtpu_mask_edges_intra.restype = None
    lib.dtpu_mask_edges_chroma.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ci, ci, ci, ci, ci, ci, ci, ci, ci,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.dtpu_mask_edges_chroma.restype = None
    lib.dtpu_mask_edges_inter.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ci, ci, ci, ci, ci, ci,
        ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.dtpu_mask_edges_inter.restype = None
    lib.dtpu_add_residual.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ci, ci,
        ctypes.c_void_p, ci, ci, ci]
    lib.dtpu_add_residual.restype = None
    lib.dtpu_add_residual16.argtypes = lib.dtpu_add_residual.argtypes
    lib.dtpu_add_residual16.restype = None
    lib.dtpu_intra_coefs_pass1.argtypes = [
        ctypes.POINTER(DtpuCoefCtx), P(CMsac),
        ci, ci, ci, ci, ci, ci,          # bx, by, w4, h4, bx4, by4
        ci, ci, ci, ci, ci,              # fbw, fbh, ss_hor/ver, has_chroma
        ci, ci, ci, ci,                  # tx, uvtx, bs, skip
        ci, ci, ci, ci, ci,              # ymode, uvmode, lossless, qidx, red
        ci, ci, ci, ci, ci, ci,          # dq y/u/v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qm y/u/v
        ctypes.c_void_p, ctypes.c_void_p,  # a/l lcoef
        ctypes.c_void_p, ctypes.c_void_p,  # a/l ccoef0
        ctypes.c_void_p, ctypes.c_void_p,  # a/l ccoef1
        ctypes.c_void_p, ci, ctypes.c_void_p]  # arena, stride, meta
    lib.dtpu_intra_coefs_pass1.restype = ctypes.c_int

    lib.dtpu_refmvs_find.argtypes = [
        ctypes.POINTER(CRefMvsFrame), ci, ci, ci, ci,  # rf, tile col/row
        ci, ci, ci, ci, ci, ci,          # ref0/1, bs, edge_flags, by4, bx4
        ctypes.c_void_p,                 # block_dim
        ctypes.c_void_p, ctypes.c_void_p]  # mvstack, out_ctx
    lib.dtpu_refmvs_find.restype = ctypes.c_int
    lib.dtpu_splat_mv.argtypes = [
        ctypes.POINTER(CRefMvsFrame), ci, ci, ci, ci,
        ci, ci, ci, ci, ci, ci, ci, ci]
    lib.dtpu_splat_mv.restype = None
    lib.dtpu_load_tmvs.argtypes = [
        ctypes.POINTER(CRefMvsFrame), ci, ci, ci, ci]
    lib.dtpu_load_tmvs.restype = None
    lib.dtpu_save_tmvs.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ci, ci, ci, ci]
    lib.dtpu_save_tmvs.restype = None

    # block-decode layer (decode.c); struct types live in decode_glue
    lib.dtpu_decode_tile_sbrow.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.dtpu_decode_tile_sbrow.restype = ctypes.c_int
    lib.dtpu_abi_sizes.argtypes = [ctypes.c_void_p]
    lib.dtpu_abi_sizes.restype = None

    # pass-2 intra replay (replay.c); ctx struct lives in decode_glue
    lib.dtpu_intra_replay.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.dtpu_intra_replay.restype = ctypes.c_int64
    # pass-2 inter replay (replay_inter.c)
    lib.dtpu_inter_replay.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,             # rc, ic
        ctypes.c_int64, ctypes.c_int64,               # start, end
        ctypes.c_int, ctypes.c_void_p,                # add_resid, skipped
        ctypes.c_void_p]                              # handled mask
    lib.dtpu_inter_replay.restype = ctypes.c_int64
    lib.dtpu_add_inter_residuals.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.dtpu_add_inter_residuals.restype = None
    lib.dtpu_add_block_residuals.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.dtpu_add_block_residuals.restype = None
    return lib


lib = _load()
