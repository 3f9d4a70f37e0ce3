"""Two-pass reconstruction pipeline (pass 2), counterpart of
dav1d_tpu/pipeline.py.

Pass 1 (decode.frame with two_pass=True) runs the serial entropy decode
and captures per-block mode info and dequantized coefficients in the
native arenas; at its end every captured inverse transform of the frame
goes to the frame's device (``f.device``) in one kernel launch
(:func:`_launch_residuals_native`, ops/itx.py, csrc/itx.cu; with a mesh,
one launch a share of the arena, :func:`itx_shares`), and the
residuals start coming down.  Pass 2 (:func:`run_pass2`) collects them
and executes the pixel work:

  1. batched translational MC on the frame's device (``f.device``): every
     plain single-reference inter block is predicted from the reference
     planes that stay resident there (``_RefSlot.dev_planes``), one
     kernel launch per frame (ops/mc.py, csrc/mc.cu) writing into a copy
     of the frame's layout, which comes down once and is copied into the
     planes whole; the blocks get their residuals;
  2. the native phase-A replay predicts the other inter blocks on the
     host and adds their residuals;
  3. intra/intrabc/interintra blocks replay in decode order (their
     prediction reads reconstructed neighbours): on the host (the native
     walk), or, with ``f.device_intra`` (``Decoder(device_intra=True)``),
     level by level on ``f.device`` (recon/device_intra.py), except on
     the frames that schedule does not cover.
"""

from __future__ import annotations

import ctypes

import numpy as np

import torch

from . import devrt, state
from .decode.tile import TaskContext
from .ops import itx as ditx
from .ops import mc as dmc


def _replay_one(t, rec) -> None:
    from .recon.intra import recon_b_intra
    from .recon.inter import recon_b_inter
    t.bx = rec["bx"]
    t.by = rec["by"]
    t.ts = rec["ts"]
    t.cur_rec = rec
    t.rec_coef_pos = 0
    b = rec["b"]
    if rec["kind"] == "intra":
        if rec["pal"] is not None:
            t.scratch_pal[:] = rec["pal"][0]
            t.pal_idx_y = rec["pal"][1]
            t.pal_idx_uv = rec["pal"][2]
        recon_b_intra(t, rec["bs"], rec["edge_flags"], b)
    else:
        t.warpmv = rec.get("warpmv")
        recon_b_inter(t, rec["bs"], b)


class _NativeResiduals:
    """The frame's residuals for the arena-driven (record-free) pass 2:
    one flat buffer holding every transform block's h x w residuals
    (ops/itx.itx_frame, computed on ``f.device``; ``dev`` keeps the device
    copy, which the device intra stage scatters into its residual
    canvases), its pending download, and the per-meta-row pointers into
    it that the native replay reads (0 for rows without residuals)."""

    __slots__ = ("ptrs", "elsz", "pos", "jobs", "host", "event", "flat",
                 "dev")

    def __init__(self, n_meta, elsz):
        self.ptrs = np.zeros(n_meta, dtype=np.uint64)
        self.elsz = elsz
        self.pos = self.jobs = self.host = self.event = self.flat = None
        self.dev = None

    def collect(self):
        """Wait for the download and point every block's meta row at its
        residuals."""
        if self.host is None:
            return
        devrt.wait(self.event)
        self.flat = self.host.numpy()
        m = np.flatnonzero(self.pos >= 0)
        off = self.jobs[self.pos[m], ditx.J_OUT].astype(np.uint64)
        self.ptrs[m] = np.uint64(self.flat.ctypes.data) + \
            off * np.uint64(self.elsz)

    def resid_of_meta(self, m):
        """The (h, w) residual block of meta row ``m`` (after
        :meth:`collect`), for the blocks pass 2 replays in Python."""
        if self.flat is None or self.pos[m] < 0:
            return None
        _, tx, _, off = self.jobs[self.pos[m]]
        w, h = ditx._txinfo(int(tx))[:2]
        return self.flat[off:off + h * w].reshape(h, w)


def _launch_residuals_native(f):
    """The tail of pass 1: every captured inverse transform of the frame,
    of every plane, in ONE launch on ``f.device``.  The coefficient arena
    goes up once (its used prefix, int32: the arena returns to the pool
    at frame finish, and a copy from pageable memory has read it when
    ``upload`` returns), the job table (one row per meta row with
    eob >= 0, sorted as the reference groups them) goes up, the itx
    kernel runs, and the residuals start coming down; pass 2 collects
    them.  Returns the frame's :class:`_NativeResiduals`."""
    glue = f._nat
    meta = glue.meta_rows()
    # residuals: int16 at bd <= 10, int32 at 12-bit (12-bit IDTX exceeds
    # int16; dav1d_tpu/ops/itx.py:270-275)
    st = _NativeResiduals(meta.shape[0], 2 if f.bitdepth <= 10 else 4)
    valid = np.flatnonzero(meta[:, 0] >= 0)
    if valid.size == 0:
        return st
    n_cf = int(glue.c.cf_used)
    blocks = (meta[valid, 5], meta[valid, 2] >> 8, meta[valid, 1],
              meta[valid, 0], n_cf)
    mesh = getattr(f, "mesh", None)
    if mesh is not None:
        order, jobs, out = _residuals_mesh(f, mesh, glue.cf_arena,
                                           itx_shares(*blocks, mesh.n))
    else:
        order, jobs, groups, n_out = ditx.job_table(*blocks)
        # jobs and groups go up in one copy
        both = devrt.upload(np.concatenate([jobs.ravel(), groups.ravel()]),
                            f.device)
        out = devrt.call("itx", ditx.itx_frame,
                         devrt.upload(glue.cf_arena[:n_cf], f.device),
                         both[:jobs.size].view(jobs.shape),
                         both[jobs.size:].view(groups.shape), n_out,
                         f.bitdepth)
    st.host, st.event = devrt.fetch_async(out)
    st.dev = out
    st.jobs = jobs
    st.pos = np.full(meta.shape[0], -1, dtype=np.int64)
    st.pos[valid[order]] = np.arange(len(order))
    devrt.COUNTS["itx_blocks"] += len(order)
    return st


def itx_shares(cf_off, tx, txtp, eob, n_cf: int, n: int) -> list:
    """The frame's transform blocks (as ops/itx.job_table takes them) cut
    into ``n`` shares of contiguous arena ranges, balanced by coefficient
    words and cut between blocks: per share (lo, hi, rows, (order, jobs,
    groups, n_out)), the share's arena slice [lo, hi), its blocks'
    indices ``rows`` into the inputs, and the job table of those blocks
    over the slice (a share may hold none)."""
    cf_off = np.asarray(cf_off, np.int64)
    tx = np.asarray(tx, np.int64)
    by = np.argsort(cf_off, kind="stable")
    cum = np.cumsum(ditx._luts()[2][np.clip(tx[by], 0, ditx.N_TX - 1)])
    cuts = np.searchsorted(cum, cum[-1] * np.arange(1, n) / n, "right") \
        if len(by) else np.zeros(n - 1, np.int64)
    bounds = np.concatenate([[0], cuts, [len(by)]])
    los = [0] + [int(cf_off[by[k]]) if k < len(by) else n_cf
                 for k in bounds[1:-1]] + [n_cf]
    shares = []
    for k in range(n):
        rows = by[bounds[k]:bounds[k + 1]]
        lo, hi = los[k], los[k + 1]
        shares.append((lo, hi, rows, ditx.job_table(
            cf_off[rows] - lo, tx[rows], np.asarray(txtp)[rows],
            np.asarray(eob)[rows], hi - lo)))
    return shares


def _residuals_mesh(f, mesh, arena, shares):
    """The frame's residuals with a mesh: one K4 launch a share of the
    blocks (:func:`itx_shares`), each on its band's device from one
    upload of its job rows, group rows and arena slice, the shares'
    residuals concatenated in share order on the mesh's first device
    (Mesh.fetch; all-gathered across ranks in the process-group form).
    Returns (order, jobs, residuals): the frame's job table in that
    order, its rows' offsets into the concatenation."""
    parts = []
    for b in mesh.local:
        lo, hi, _, (_, jobs, groups, n_out) = shares[b]
        dev = mesh.device_of(b)
        if not len(groups):
            parts.append(torch.zeros(0, dtype=ditx.out_dtype(f.bitdepth),
                                     device=dev))
            continue
        devrt.COUNTS["mesh_itx_shares"] += 1
        t = devrt.upload(np.concatenate([jobs.ravel(), groups.ravel(),
                                         arena[lo:hi]]), dev)
        a, c = jobs.size, jobs.size + groups.size
        parts.append(devrt.call(
            "itx", ditx.itx_frame, t[c:], t[:a].view(jobs.shape),
            t[a:c].view(groups.shape), n_out, f.bitdepth))
    sizes = [s[3][3] for s in shares]
    out = mesh.fetch(parts, sizes=sizes)
    # the frame's job table: each share's rows, offsets into the whole
    jobs = np.concatenate([s[3][1] for s in shares])
    start = np.repeat(np.cumsum(sizes) - sizes,
                      [len(s[3][1]) for s in shares])
    jobs[:, ditx.J_OUT] += start.astype(np.int32)
    jobs[:, ditx.J_CF] += np.repeat([s[0] for s in shares],
                                    [len(s[3][1]) for s in shares]) \
        .astype(np.int32)
    order = np.concatenate([s[2][s[3][0]] for s in shares])
    return order, jobs, out


class _McDevice:
    """Batched device-MC stage state: which blocks it owns, and the
    launched predictions in the frame's layout (plane ``pl`` at
    ``bases[pl]:bases[pl + 1]`` of ``out``)."""

    __slots__ = ("handled", "block_idxs", "out", "bases")


# filter2d -> horizontal filter type (reference dav1d_filter_2d order)
_F2D_HTYPE = np.array([0, 0, 0, 2, 2, 2, 1, 1, 1], dtype=np.int32)


def _resident_planes(slot, bitdepth, device):
    """The slot's final planes on ``device``: the resident planes its
    frame left there, or (for a slot that never had them: imported
    state) its host planes, uploaded once and kept on the slot."""
    if slot.dev_planes is None:
        slot.dev_planes = state.upload_planes(slot.planes, bitdepth, device)
    return slot.dev_planes


def mc_select(f, cb):
    """The blocks the device MC stage predicts: plain translational
    single-reference inter blocks (no compound/OBMC/warp/interintra,
    a regular filter2d), from an unscaled reference that holds pixels,
    no global-motion warp, and not sub-8x8 chroma (reference
    pipeline._launch_mc_device).  Returns (sel, ref0)."""
    from . import tables

    bdim = tables.block_dimensions
    bw4s = bdim[cb["bs"], 0].astype(np.int32)
    bh4s = bdim[cb["bs"], 1].astype(np.int32)
    hdr = f.frame_hdr
    ref0 = cb["pad0"].astype(np.int32) - 1

    ref_ok = np.zeros(7, dtype=bool)
    for i in range(7):
        slot = f.refp[i] if f.refp is not None else None
        ref_ok[i] = (slot is not None and slot.planes is not None
                     and slot.frame_hdr is not None
                     and slot.frame_hdr.width[1] == hdr.width[0]
                     and slot.frame_hdr.height == hdr.height)
    gwa = np.asarray([bool(v) for v in f.gmv_warp_allowed], dtype=bool)
    r0c = np.clip(ref0, 0, 6)
    sel = ((cb["kind"] == 1) & (cb["interintra_type"] == 0)
           & (cb["comp_type"] == 0) & (cb["motion_mode"] == 0)
           & (cb["filter2d"] <= 8) & (ref0 >= 0) & ref_ok[r0c]
           & ~((cb["inter_mode"] == 2) & gwa[r0c])
           & (bw4s > f.ss_hor) & (bh4s > f.ss_ver))
    return sel, ref0


def _launch_mc_device(f, glue, n):
    """Batched translational MC on ``f.device``: every block of
    :func:`mc_select` contributes one job per plane (its origin, size,
    and the two 8-tap filter rows of its subpel phase), and ONE kernel
    launch filters every job of the frame straight from the resident
    reference planes, clamping each read to the reference's coded size
    (emu_edge).  The reference's three tiers (Pallas gather from a
    replicated-border stack, XLA clamped gather, host-gathered windows,
    dav1d_tpu/pipeline.py:404-523) and its 4/8/16 tile bucketing are
    shapes of the TPU; here one job is one block plane.  Returns None
    when no block qualifies."""
    from . import tables

    cb = glue.cap_blocks[:n]
    sel, ref0 = mc_select(f, cb)
    idxs = np.flatnonzero(sel)
    if idxs.size == 0:
        return None

    bdim = tables.block_dimensions
    bw4 = bdim[cb["bs"][idxs], 0].astype(np.int32)
    bh4 = bdim[cb["bs"][idxs], 1].astype(np.int32)
    bx = cb["bx"][idxs].astype(np.int32)
    by = cb["by"][idxs].astype(np.int32)
    mv = cb["mv"][idxs]
    mvy = mv[:, 0, 0].astype(np.int32)
    mvx = mv[:, 0, 1].astype(np.int32)
    f2d = cb["filter2d"][idxs].astype(np.int32)
    refs = ref0[idxs]
    ht = _F2D_HTYPE[f2d]
    vt = f2d % 3
    hdr = f.frame_hdr
    ss_hor, ss_ver = f.ss_hor, f.ss_ver
    n_pl = 3 if f.layout != 0 else 1
    subf = np.ascontiguousarray(tables.mc_subpel_filters, dtype=np.int32)

    def taps(sets, phase):
        """(N, 8) filter rows: the identity row at phase 0, else the
        subpel row of the set (mx/my == 0 collapses the H/V-only and
        copy paths into the fused one, ops/mc.py docstring)."""
        rows = np.zeros((len(phase), 8), dtype=np.int32)
        rows[:, 3] = 64
        nz = phase != 0
        rows[nz] = subf[sets[nz], phase[nz] - 1]
        return rows

    # device table: one entry per (ref slot, plane) the jobs read
    entries = {}
    planes, coded = [], []
    for r in np.unique(refs):
        devp = _resident_planes(f.refp[int(r)], f.bitdepth, f.device)
        for pl in range(n_pl):
            ss_h = ss_hor if pl else 0
            ss_v = ss_ver if pl else 0
            entries[int(r), pl] = len(planes)
            planes.append(devp[pl])
            # clamp to the CODED size: rows/cols beyond it in the
            # allocation are scratch (reference pipeline.py:201-204,
            # :396-399)
            coded.append(((hdr.height + ss_v) >> ss_v,
                          (hdr.width[1] + ss_h) >> ss_h))
    ent_of = np.full((7, 3), -1, dtype=np.int32)
    for (r, pl), e in entries.items():
        ent_of[r, pl] = e

    cols = []
    for pl in range(n_pl):
        ss_h = ss_hor if pl else 0
        ss_v = ss_ver if pl else 0
        h_mul, v_mul = 4 >> ss_h, 4 >> ss_v
        sh_h, sh_v = (0 if ss_h else 1), (0 if ss_v else 1)
        mx = (mvx & (15 >> sh_h)) << sh_h
        my = (mvy & (15 >> sh_v)) << sh_v
        w_px = bw4 * h_mul
        h_px = bh4 * v_mul
        # 4-px dimensions take the 4-tap sets (3 + (type & 1))
        fh_set = np.where(w_px > 4, ht, 3 + (ht & 1))
        fv_set = np.where(h_px > 4, vt, 3 + (vt & 1))
        cols.append(dict(
            pl=np.full(len(idxs), pl, np.int32), entry=ent_of[refs, pl],
            dy=by * v_mul + (mvy >> (3 + ss_v)),
            dx=bx * h_mul + (mvx >> (3 + ss_h)), w=w_px, h=h_px,
            fh=taps(fh_set, mx), fv=taps(fv_set, my),
            dst_y=(by * 4) >> ss_v, dst_x=(bx * 4) >> ss_h))
    J = {k: np.concatenate([c[k] for c in cols]) for k in cols[0]}

    # the output buffer is the current frame's planes, narrow and back to
    # back: every job's block lands where the frame needs it
    shapes = [f.planes[pl].shape for pl in range(n_pl)]
    base = np.cumsum([0] + [h * w for h, w in shapes])
    stride = np.array([w for _, w in shapes], dtype=np.int64)[J["pl"]]
    jobs, tiles, n_pix = dmc.job_table(
        J["entry"], J["dy"], J["dx"], J["w"], J["h"],
        base[J["pl"]] + J["dst_y"] * stride + J["dst_x"], stride, J["fh"],
        J["fv"], int(base[-1]))
    # jobs and tiles go up in one copy
    both = devrt.upload(np.concatenate([jobs.ravel(), tiles.ravel()]),
                        f.device)
    out = devrt.call("mc", dmc.put_8tap_resident, planes, coded,
                     both[:jobs.size].view(jobs.shape),
                     both[jobs.size:].view(tiles.shape), n_pix,
                     int(base[-1]), f.bitdepth)

    mc_st = _McDevice()
    mc_st.handled = np.zeros(n, dtype=np.uint8)
    mc_st.handled[idxs] = 1
    mc_st.block_idxs = idxs.astype(np.int64)
    mc_st.out = out
    mc_st.bases = base
    devrt.COUNTS["mc_blocks"] += len(idxs)
    return mc_st


def _scatter_mc_device(f, mc_st):
    """Download the frame's device predictions (narrow, once) and copy
    them into the frame's planes, whole.  Exact before phase A: the
    pixels no job wrote are rewritten later by the blocks that own them
    (every pixel of every block is predicted, by the replay of phase A
    or B) or are the allocation padding, which is zero in both (the
    buffer starts zeroed; decode/frame.FrameContext zeroes the padding)
    unless an edge block's prediction covers it, as on the host."""
    with devrt.span("pass2.mc.fetch"):  # waits for the kernel
        out = devrt.fetch(mc_st.out)
    with devrt.span("pass2.mc.copy"):
        for pl, p in enumerate(f.planes[:len(mc_st.bases) - 1]):
            np.copyto(p, out[mc_st.bases[pl]:mc_st.bases[pl + 1]].reshape(
                p.shape))


def run_pass2(f, st) -> None:
    """Arena-driven pass 2 with the residuals ``st`` computed in pass 1:
    the device MC launch, the copy of its predictions into the frame
    with their residual adds, the native phase-A replay of the other
    inter blocks with theirs, then the native phase-B ordered intra
    walk (or, with ``f.device_intra``, the device intra stage of
    recon/device_intra.py, which hands the frames it does not cover to
    that walk); Python replays only the blocks C reports back (scaled
    references, intrabc, interintra, consistency stops).  Nothing here
    catches a device failure: it raises out of the decode."""
    from .native import lib as _nlib

    glue = f._nat
    t = TaskContext(f)
    t.pass_ = 2
    # the residuals came down while later frames ran pass 1
    # (max_frame_delay): every replay below reads them, so the reference's
    # host_tier=0 variant, which overlaps phase A with the device
    # (dav1d_tpu/pipeline.py:574, :605-618), has nothing to hide here
    with devrt.span("pass2.itx.collect"):
        st.collect()
    n = int(glue.c.n_blocks)
    if n == 0:
        return
    rc = glue.build_replay_ctx(st.ptrs, st.elsz)
    ic = glue.build_inter_ctx()

    # batched device MC.  Its predictions come back before phase A: the
    # whole-plane copy needs no per-block scatter on the host, and
    # phase A and B then overwrite every pixel it must not keep
    devrt.COUNTS["inter_blocks"] += int(
        np.count_nonzero(glue.cap_blocks[:n]["kind"] == 1))
    with devrt.span("pass2.mc"):
        with devrt.span("pass2.mc.launch"):
            mc_st = _launch_mc_device(f, glue, n)
        if mc_st is not None:
            _scatter_mc_device(f, mc_st)
            with devrt.span("pass2.mc.resid"):
                _nlib.dtpu_add_block_residuals(ctypes.byref(rc),
                                               mc_st.block_idxs.ctypes.data,
                                               len(mc_st.block_idxs))

    # phase A: order-free inter predictions + residual adds (the host
    # tier: the residuals are already computed).  Walks are ranged per
    # tile slice: parallel pass 1 leaves zeroed gap rows between slices
    # that must never be visited (serial mode is one range).
    ranges = glue.block_ranges()
    handled_ptr = mc_st.handled.ctypes.data if mc_st is not None else None
    skipped = np.empty(n, dtype=np.int64)
    ns = 0
    for s, e in ranges:
        if s < e:
            ns += int(_nlib.dtpu_inter_replay(
                ctypes.byref(rc), ctypes.byref(ic), s, e, 1,
                skipped.ctypes.data + 8 * ns, handled_ptr))
    for bi in skipped[:ns]:
        _replay_one(t, glue.build_record(int(bi), st.resid_of_meta))

    # phase B on the device: the wavefront levels of recon/device_intra
    if f.device_intra:
        from .recon.device_intra import intra_frame_device
        if intra_frame_device(f, st):
            return
        devrt.COUNTS["intra_host_frames"] += 1

    # phase B: ordered intra walk, stopping at blocks needing Python.
    # Per-tile ranges are a valid order: intra prediction never crosses
    # tile boundaries.
    with devrt.span("pass2.intra.host"):
        for s, e in ranges:
            cursor = s
            while cursor < e:
                k = int(_nlib.dtpu_intra_replay(ctypes.byref(rc), cursor, e))
                cursor += k
                if cursor < e:
                    _replay_one(t, glue.build_record(cursor,
                                                     st.resid_of_meta))
                    cursor += 1

