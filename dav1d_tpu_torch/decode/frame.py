"""Frame decode of the port (counterpart of dav1d_tpu/decode/frame.py
decode_frame_pass1 / decode_frame_finish).

Pass 1 is the reference's symbol decode (native C when available); its
two-pass tail runs the port's host-tier residual launch
(pipeline._launch_residuals_native).  The finish runs the port's pass 2
(pipeline.run_pass2, the host C replay) and then the in-loop filter
chain through recon/device_chain.py: deblock and CDEF on the frame's
device (``f.device``), super-res and loop restoration on the host.
"""

from __future__ import annotations

from dav1d_tpu import debug
from dav1d_tpu.decode.frame import _tile_pool, decode_tile_sbrow, split_tiles
from dav1d_tpu.decode.tile import TaskContext
from dav1d_tpu.msac import MsacNative
from dav1d_tpu.native import decode_glue
from dav1d_tpu.refmvs import load_tmvs, save_tmvs

from .. import devrt
from ..pipeline import _launch_residuals_native, run_pass2
from ..recon.device_chain import filter_chain_device


def decode_frame_pass1(f, tile_groups, two_pass: bool = False) -> None:
    """Everything whose outputs the NEXT frame's pass 1 needs: the symbol
    decode (capture in two-pass mode, fused pixels otherwise), the CDF
    refresh, segmap/refmvs state — plus the residual stage, which the
    port runs on the host C tier.

    Two-pass mode needs the native pass-1 decoder (dav1d_tpu.native):
    its capture arenas feed the port's residual launch and the native
    replay."""
    split_tiles(f, tile_groups)
    hdr = f.frame_hdr
    t = TaskContext(f)
    if two_pass:
        f.tasks = []
        t.pass_ = 1

    for a in f.a:
        a.reset(f.frame_is_intra)

    nat = None
    par_cols = 0
    if two_pass:
        if not (decode_glue.available() and not debug.TRACE
                and isinstance(f.ts[0].msac, MsacNative)):
            raise RuntimeError("two-pass decode needs the native pass-1 "
                               "decoder (dav1d_tpu.native)")
        par = (getattr(f, "n_threads", 0) >= 2
               and hdr.tiling.cols * hdr.tiling.rows > 1)
        nat = decode_glue.NativeFrameDecode(
            f, parallel_tiles=f.ts if par else None)
        if par:
            par_cols = hdr.tiling.cols

    def _sbrows():
        for tile_row in range(hdr.tiling.rows):
            sbh_end = min(hdr.tiling.row_start_sb[tile_row + 1], f.sbh)
            for sby in range(hdr.tiling.row_start_sb[tile_row], sbh_end):
                by = sby << (4 + f.seq_hdr.sb128)
                yield by, (by + f.sb_step) >> 1

    if par_cols:
        # tile-grid parallel pass 1 (dav1d_tpu/decode/frame.py: serial
        # temporal-MV prologue and epilogue around independent tiles)
        if hdr.use_ref_frame_mvs and f.rf is not None:
            for by, by_end in _sbrows():
                load_tmvs(f.rf, 0, f.bw >> 1, by >> 1, by_end)
        tasks = []
        for tile_row in range(hdr.tiling.rows):
            sbh_end = min(hdr.tiling.row_start_sb[tile_row + 1], f.sbh)
            rows = range(hdr.tiling.row_start_sb[tile_row], sbh_end)
            for c in range(hdr.tiling.cols):
                tasks.append((f.ts[tile_row * hdr.tiling.cols + c], rows))
        pool = _tile_pool(min(f.n_threads, len(tasks)))

        def _tile_task(ts, rows):
            tc = TaskContext(f)
            tc.pass_ = t.pass_
            for sby in rows:
                tc.by = sby << (4 + f.seq_hdr.sb128)
                tc.ts = ts
                nat.decode_tile_sbrow(tc)

        futs = [pool.submit(_tile_task, ts, rows) for ts, rows in tasks]
        for fu in futs:
            fu.result()
        if hdr.frame_type.is_inter_or_switch and f.rf is not None:
            for by, by_end in _sbrows():
                save_tmvs(f.rf, 0, f.bw >> 1, by >> 1, by_end)
        nat.finish_parallel()
    else:
        for tile_row in range(hdr.tiling.rows):
            sbh_end = min(hdr.tiling.row_start_sb[tile_row + 1], f.sbh)
            for sby in range(hdr.tiling.row_start_sb[tile_row], sbh_end):
                t.by = sby << (4 + f.seq_hdr.sb128)
                by_end = (t.by + f.sb_step) >> 1
                if hdr.use_ref_frame_mvs and f.rf is not None:
                    load_tmvs(f.rf, 0, f.bw >> 1, t.by >> 1, by_end)
                for tile_col in range(hdr.tiling.cols):
                    t.ts = f.ts[tile_row * hdr.tiling.cols + tile_col]
                    if nat is not None:
                        nat.decode_tile_sbrow(t)
                    else:
                        decode_tile_sbrow(t)
                if hdr.frame_type.is_inter_or_switch and f.rf is not None:
                    save_tmvs(f.rf, 0, f.bw >> 1, t.by >> 1, by_end)

    f._two_pass = two_pass
    f._launched = None
    f._nat = nat  # capture arenas stay live for the native pass-2 replay
    if two_pass:
        nat.finish_lr_units()
        f._launched = _launch_residuals_native(f)

    # CDF refresh is a pass-1 product (the next frame's in_cdf)
    if hdr.refresh_context:
        f.out_cdf.update(f.ts[hdr.tiling.update].cdf,
                         frame_is_intra=f.frame_is_intra)


def decode_frame_finish(f) -> None:
    """Pass 2 (the host replay) and the in-loop filter chain: deblock ->
    CDEF on ``f.device``, then super-res and loop restoration on the
    host (recon/device_chain.py)."""
    if f._two_pass:
        with devrt.span("pass2"):
            run_pass2(f, f._launched)
        f._launched = None

    with devrt.span("chain"):
        filter_chain_device(f, f.device)

    nat = getattr(f, "_nat", None)
    if nat is not None:
        nat.release()
        f._nat = None

    # per-frame filter state is dead once the chain ran
    f.lf_level = f.lf_wd_y = f.lf_wd_uv = None
    f.noskip = f.cdef_idx = None
    f.ipred_edge = None
    f.tx_lpf_right_edge = None
    f.tasks = []
