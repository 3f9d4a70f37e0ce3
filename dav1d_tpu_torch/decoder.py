"""Public decoder API: open / send_data / get_picture / flush / close.

Capability parity with the reference API surface (reference
include/dav1d/dav1d.h:134-323, src/lib.c:140-763): temporal-unit input,
reorder-queue output, 8-slot reference state (pictures + segmaps + CDFs),
show_existing_frame, operating-point/layer filtering, sequence-change reset.

``Decoder(settings, device="cuda")`` decodes on an explicit torch
device: the batched MC of pass 2 and the in-loop filter chain run there
(through the CUDA kernels of ``csrc/`` on a CUDA device, their plain
PyTorch versions on the CPU), and each reference slot keeps the frame's
final planes resident on it (``_RefSlot.dev_planes``) for the MC of
later frames.  The device defaults to ``"cuda"``; without CUDA the
constructor raises instead of running on the CPU.  The CPU tests pass
``device="cpu"``.  Film grain runs there at output (recon/filmgrain.py).

``Settings(mesh=Mesh(devices))`` (mesh.py) spreads the frame's inverse
transforms, deblock, CDEF and loop restoration over several devices as
row bands of the resident planes and shares of the unit work; with
``Mesh(devices, group=pg)`` over the ranks of a torch.distributed
process group.  The output is the single-device decode's, bit for bit.

``device_intra=True`` moves phase B of pass 2, the ordered intra walk,
to the device as well (recon/device_intra.py: wavefront levels of
prediction units, one kernel launch per level and kind).  It is off by
default, as in the reference (dav1d_tpu/dispatch.py: ``ipred`` is off
unless DAV1D_TPU_DEVICE_IPRED=1).
"""

from __future__ import annotations

import dataclasses
import io
import pickle
from typing import Optional

import numpy as np
import torch

from . import devrt
from .cdf import CdfContext
from .decode.frame import (FrameContext, decode_frame_pass1,
                           decode_frame_finish)
from .getbits import GetBits
from .headers import FrameType, ObuType, PixelLayout, PRIMARY_REF_NONE
from . import obu as obu_mod


@dataclasses.dataclass
class Settings:
    """Mirror of Dav1dSettings (reference include/dav1d/dav1d.h:78-99).

    n_threads >= 2 enables the reconstruction worker: pass 2 + the
    filter chain of frame N run on a worker thread while the main
    thread entropy-decodes frame N+1 — the reference's frame-threading
    overlap (src/lib.c:109-126) with real thread parallelism on
    multi-core hosts (the native C passes release the GIL).  Output
    order and bit-exactness are unchanged: reconstruction stays
    strictly in order on the single worker."""

    n_threads: int = 0
    max_frame_delay: int = 0
    apply_grain: bool = True
    operating_point: int = 0
    all_layers: bool = True
    frame_size_limit: int = 0
    strict_std_compliance: bool = False
    output_invisible_frames: bool = False
    # bitmask of in-loop filters to apply: 1 deblock, 2 cdef,
    # 4 restoration (reference Dav1dInloopFilterType, dav1d.h:61-67)
    inloop_filters: int = 7
    # 0 all, 1 only frames referenced by others, 2 only intra, 3 only key
    # (reference Dav1dDecodeFrameType, dav1d.h:69-75)
    decode_frame_type: int = 0
    # two-pass host/device pipeline: pass 1 entropy+capture, pass 2
    # batched device reconstruction + ordered replay
    two_pass: bool = False
    # multi-device decode (mesh.Mesh, reference decoder.py:55): row bands
    # of the resident planes, and shares of the itx and restoration work,
    # over the mesh's devices or ranks.  Forces two-pass and a frame
    # delay of 2; the mesh's first device must be the decoder's device
    mesh: object = None
    # pluggable logger (reference Dav1dLogger, include/dav1d/dav1d.h:48):
    # a callable taking one formatted message string; None silences.
    # Decode errors still raise — the logger reports them (and non-fatal
    # events: sequence resets, skipped frames) before they propagate.
    logger: object = None


@dataclasses.dataclass
class DataProps:
    """Per-packet metadata carried through the decoder (reference
    Dav1dDataProps, include/dav1d/data.h:41-59): set on send_data,
    surfaced on the Picture(s) decoded from that packet (Dav1dPicture.m)
    and on Decoder.decode_error_props after a failed decode
    (dav1d_get_decode_error_data_props, reference src/lib.c:716)."""

    timestamp: int = -9223372036854775808  # INT64_MIN, like the reference
    duration: int = 0
    offset: int = -1
    size: int = 0
    user_data: object = None


@dataclasses.dataclass
class Picture:
    planes: list  # numpy int32 planes, cropped
    width: int
    height: int
    layout: PixelLayout
    bitdepth: int
    seq_hdr: object
    frame_hdr: object
    visible: bool = True
    content_light: object = None
    mastering_display: object = None
    itut_t35: list = dataclasses.field(default_factory=list)
    props: object = None  # DataProps of the originating packet
    # the frame's final planes resident on the decoder's device (int32,
    # allocation-sized), which film grain reads; dropped at output
    dev_planes: object = dataclasses.field(default=None, repr=False)

    def plane_buffer(self, pl: int) -> np.ndarray:
        """Output-width view of a plane: one contiguous cast (uint8 at
        8-bit, little-endian uint16 above), no tobytes copy.  Accepted
        anywhere the buffer protocol is (hashlib.update, file.write)."""
        arr = self.planes[pl]
        if self.bitdepth == 8:
            return arr.astype(np.uint8)
        return arr.astype("<u2")

    def plane_bytes(self, pl: int) -> bytes:
        return self.plane_buffer(pl).tobytes()


class _RefSlot:
    __slots__ = ("frame_hdr", "seq_hdr", "planes", "segmap", "cdf",
                 "showable", "visible", "refmvs", "refpoc", "dev_planes",
                 "ready")

    def __init__(self):
        import threading

        self.frame_hdr = None
        self.seq_hdr = None
        self.planes = None
        self.dev_planes = None  # final planes resident on the device
        self.segmap = None
        self.cdf = None
        self.showable = False
        self.visible = False
        self.refmvs = None  # saved temporal-MV 8x8 grid (refmvs.TMV_DT)
        self.refpoc = [0] * 7
        # pixel-readiness token (the reference's per-picture filtered-
        # row progress, src/picture.h:62, at frame granularity): SET
        # when `planes` holds final filtered pixels — or when the slot
        # will never get pixels (header-only refresh, initial slots) so
        # a reader sees planes=None and takes the existing error paths
        # instead of blocking.  Cleared only while a refreshing frame's
        # reconstruction is in flight.
        self.ready = threading.Event()
        self.ready.set()


@dataclasses.dataclass
class _TileGroup:
    data: bytes
    start_offset: int
    end_offset: int
    tile_start: int
    tile_end: int


class Decoder:
    """Single-threaded decode pipeline (frame threading and the device
    batch pipeline layer on top of this state machine)."""

    def __init__(self, settings: Settings | None = None, device="cuda",
                 device_intra: bool = False):
        self.device = devrt.resolve_device(device)
        self.device_intra = bool(device_intra)
        self.settings = settings or Settings()
        mesh = self.settings.mesh
        # a mesh runs the bands' work between the passes
        self._two_pass = self.settings.two_pass or mesh is not None
        if mesh is not None:
            if mesh.devices[0] != self.device:
                raise ValueError(f"the mesh's first device {mesh.devices[0]}"
                                 f" is not the decoder's device "
                                 f"{self.device}")
            if mesh.group is not None and self.settings.n_threads >= 2:
                # frames finishing on several threads would issue the
                # collectives in a different order on each rank
                raise ValueError("a process-group mesh needs n_threads < 2")
        self.strict_std_compliance = self.settings.strict_std_compliance
        self.seq_hdr = None
        self.frame_hdr = None
        self.refs = [_RefSlot() for _ in range(8)]
        self.operating_point_idc = 0
        self.max_spatial_id = 0
        self.tile_groups: list[_TileGroup] = []
        self.n_tiles = 0
        self.out_queue: list[Picture] = []
        self.event_flags = 0
        # props of the packet whose decode failed (reference
        # dav1d_get_decode_error_data_props)
        self.decode_error_props = None
        self._cur_props = None
        self.content_light = None
        self.mastering_display = None
        self.itut_t35: list = []
        # frames submitted (pass 1 done, device residual batches in
        # flight) but not yet finished (pass 2 + filters) — the frame
        # pipeline (reference frame threading, src/lib.c:109-126 /
        # src/thread_task.c); bounded by Settings.max_frame_delay
        self._pending: list = []
        # n_threads >= 2: reconstruction workers.  Pool size follows the
        # reference's frame-context count n_fc = ceil(sqrt(n_threads)),
        # capped at 8 (src/lib.c:109-126).  Frames are SUBMITTED in
        # decode order but execute concurrently, each gated only on the
        # readiness of the ref slots it actually reads (_RefSlot.ready)
        # — the frame-granular form of the reference's lowest_pixel/
        # progress protocol (src/thread_task.c:393-439).  Outputs drain
        # via the in-order futures queue, so emission order and bytes
        # are unchanged at any thread count.
        self._worker = None
        self._futures: list = []
        if self.settings.n_threads >= 2:
            import math
            from concurrent.futures import ThreadPoolExecutor

            self.n_fc = min(8, math.isqrt(self.settings.n_threads - 1) + 1)
            self._worker = ThreadPoolExecutor(
                max_workers=self.n_fc, thread_name_prefix="dav1d_tpu-recon")
        else:
            self.n_fc = 1

    # -- input ---------------------------------------------------------------

    def _log(self, msg: str) -> None:
        cb = self.settings.logger
        if cb is not None:
            cb(msg)

    def send_data(self, data: bytes, props: DataProps | None = None) \
            -> None:
        """Consume a temporal unit / arbitrary OBU chunk.  props (opt.)
        rides along to the decoded Picture(s) (.props) and, on a failed
        decode, to Decoder.decode_error_props."""
        if props is None:
            props = DataProps(size=len(data))
        elif props.size == 0:
            props = dataclasses.replace(props, size=len(data))
        self._cur_props = props
        try:
            for o in obu_mod.split_obus(data):
                self._handle_obu(data, o)
        except Exception as e:
            self.decode_error_props = props
            self._log(f"error: {e}")
            raise

    def _handle_obu(self, data: bytes, o) -> None:
        payload = data[o.payload_start : o.payload_end]
        ty = o.type
        if ty is None:
            return
        # layer filtering (reference src/obu.c:1202-1210)
        if (ty not in (ObuType.SEQ_HDR, ObuType.TD) and o.has_extension
                and self.operating_point_idc):
            in_t = (self.operating_point_idc >> o.temporal_id) & 1
            in_s = (self.operating_point_idc >> (o.spatial_id + 8)) & 1
            if not in_t or not in_s:
                return

        if ty == ObuType.SEQ_HDR:
            gb = GetBits(payload)
            seq = obu_mod.parse_seq_hdr(gb, self.strict_std_compliance)
            op_idx = (self.settings.operating_point
                      if self.settings.operating_point
                      < seq.num_operating_points else 0)
            self.operating_point_idc = seq.operating_points[op_idx].idc
            spatial_mask = self.operating_point_idc >> 8
            self.max_spatial_id = spatial_mask.bit_length() - 1 \
                if spatial_mask else 0
            if self.seq_hdr is None:
                self.frame_hdr = None
            elif not seq.equal_binary_content(self.seq_hdr):
                # new sequence: finish in-flight frames, drop all state
                self._log("sequence header changed: resetting decoder "
                          "state")
                self._drain_pending()
                self.frame_hdr = None
                self.refs = [_RefSlot() for _ in range(8)]
            self.seq_hdr = seq
        elif ty in (ObuType.FRAME_HDR, ObuType.REDUNDANT_FRAME_HDR,
                    ObuType.FRAME):
            if ty == ObuType.REDUNDANT_FRAME_HDR and self.frame_hdr:
                return
            if self.seq_hdr is None:
                raise obu_mod.ObuError("frame header before sequence header")
            gb = GetBits(payload)
            hdr = obu_mod.parse_frame_hdr(self, gb)
            hdr.temporal_id = o.temporal_id
            hdr.spatial_id = o.spatial_id
            self.frame_hdr = hdr
            self.tile_groups = []
            self.n_tiles = 0
            if ty != ObuType.FRAME:
                obu_mod.check_trailing_bits(gb, self.strict_std_compliance)
            if ty == ObuType.FRAME and not hdr.show_existing_frame:
                gb.bytealign()
                self._handle_tile_group(payload, gb)
        elif ty == ObuType.TILE_GRP:
            if self.frame_hdr is None:
                raise obu_mod.ObuError("tile group without frame header")
            gb = GetBits(payload)
            self._handle_tile_group(payload, gb)
        elif ty == ObuType.METADATA:
            self._handle_metadata(payload)
        elif ty == ObuType.TD:
            pass
        # frame-complete trigger
        if self.seq_hdr is not None and self.frame_hdr is not None:
            hdr = self.frame_hdr
            if hdr.show_existing_frame:
                self._show_existing()
                self.frame_hdr = None
            elif self.n_tiles == hdr.tiling.cols * hdr.tiling.rows \
                    and self.tile_groups:
                if self._skip_frame_type(hdr):
                    # refresh ref slots with headers only, dropping the
                    # picture but keeping CDF/segmap/refmvs state like
                    # the reference (src/obu.c:1671-1684 "skip" path);
                    # fresh slot objects since slots can be aliased after
                    # show_existing key-frame propagation
                    for i in range(8):
                        if hdr.refresh_frame_flags & (1 << i):
                            old = self.refs[i]
                            slot = _RefSlot()
                            slot.frame_hdr = hdr
                            slot.seq_hdr = self.seq_hdr
                            slot.cdf = old.cdf
                            slot.segmap = old.segmap
                            slot.refmvs = old.refmvs
                            slot.refpoc = old.refpoc
                            self.refs[i] = slot
                else:
                    self._submit_frame()
                self.frame_hdr = None
                self.tile_groups = []
                self.n_tiles = 0

    def _skip_frame_type(self, hdr) -> bool:
        """decode_frame_type filtering (reference src/obu.c:1640-1657)."""
        dft = self.settings.decode_frame_type
        if dft == 0:
            return False
        if hdr.frame_type.is_inter_or_switch:
            return dft > 1 or (dft == 1 and not hdr.refresh_frame_flags)
        if hdr.frame_type == FrameType.KEY:
            return False
        # intra-only
        return dft > 2 or (dft == 1 and not hdr.refresh_frame_flags)

    def _handle_metadata(self, payload: bytes) -> None:
        """CLL / MDCV / ITU-T T.35 metadata OBUs (reference src/obu.c
        :1356-1515); attached to subsequently output pictures."""
        from .headers import ContentLightLevel, MasteringDisplay
        gb = GetBits(payload)
        meta_type = gb.get_uleb128()
        if meta_type == 1:  # HDR_CLL
            cll = ContentLightLevel(
                max_content_light_level=gb.get_bits(16),
                max_frame_average_light_level=gb.get_bits(16))
            if not gb.error:
                self.content_light = cll
        elif meta_type == 2:  # HDR_MDCV
            md = MasteringDisplay()
            md.primaries = [[gb.get_bits(16), gb.get_bits(16)]
                            for _ in range(3)]
            md.white_point = [gb.get_bits(16), gb.get_bits(16)]
            md.max_luminance = gb.get_bits(32)
            md.min_luminance = gb.get_bits(32)
            if not gb.error:
                self.mastering_display = md
        elif meta_type == 4:  # ITUT_T35
            data = payload[gb.byte_pos():]
            # strip trailing bits (trailing_one + zero bytes)
            size = len(data)
            while size > 0 and data[size - 1] == 0:
                size -= 1
            size -= 1
            if size <= 0:
                return
            country_code = data[0]
            pos = 1
            ext = 0
            if country_code == 0xFF:
                ext = data[1]
                pos = 2
            self.itut_t35.append(
                dict(country_code=country_code,
                     country_code_extension_byte=ext,
                     payload=data[pos:size]))
        # SCALABILITY (3) / TIMECODE (5): ignored like the reference

    def _handle_tile_group(self, payload: bytes, gb: GetBits) -> None:
        hdr = self.frame_hdr
        n_tiles = hdr.tiling.cols * hdr.tiling.rows
        have_tile_pos = gb.get_bit() if n_tiles > 1 else 0
        if have_tile_pos:
            n_bits = hdr.tiling.log2_cols + hdr.tiling.log2_rows
            start = gb.get_bits(n_bits)
            end = gb.get_bits(n_bits)
        else:
            start, end = 0, n_tiles - 1
        gb.bytealign()
        if gb.error:
            raise obu_mod.ObuError("tile group header overrun")
        if start > end or start != self.n_tiles:
            raise obu_mod.ObuError("tile groups out of order")
        self.tile_groups.append(_TileGroup(
            payload, gb.byte_pos(), len(payload), start, end))
        self.n_tiles += 1 + end - start

    # -- decode --------------------------------------------------------------

    def _in_cdf_for(self, hdr) -> CdfContext:
        if hdr.primary_ref_frame == PRIMARY_REF_NONE:
            return CdfContext.from_defaults(hdr.quant.yac)
        ref = self.refs[hdr.refidx[hdr.primary_ref_frame]]
        if ref.cdf is None:
            raise obu_mod.ObuError("missing ref CDF")
        return ref.cdf

    def _submit_frame(self) -> None:
        hdr = self.frame_hdr
        seq = self.seq_hdr
        limit = self.settings.frame_size_limit
        if limit and hdr.width[1] * hdr.height > limit:
            # reference: picture alloc fails with ERANGE
            # (src/picture.c:126-131)
            raise obu_mod.ObuError(
                f"frame size {hdr.width[1]}x{hdr.height} exceeds "
                f"frame_size_limit {limit}")
        prev_segmap = None
        if hdr.segmentation.enabled and not hdr.segmentation.update_map \
                or (hdr.segmentation.enabled and hdr.segmentation.temporal):
            if hdr.primary_ref_frame != PRIMARY_REF_NONE:
                prev_segmap = self.refs[
                    hdr.refidx[hdr.primary_ref_frame]].segmap
        f = FrameContext(seq, hdr, prev_segmap=prev_segmap,
                         in_cdf=self._in_cdf_for(hdr),
                         refs=[self.refs[hdr.refidx[i]] for i in range(7)]
                         if hdr.frame_type.is_inter_or_switch else None)
        f.inloop_filters = self.settings.inloop_filters
        f.n_threads = self.settings.n_threads
        f.device = self.device
        f.device_intra = self.device_intra
        f.mesh = self.settings.mesh
        f._props = self._cur_props
        if not self._two_pass:
            # fused reconstruction reads ref pixels during pass 1 —
            # cannot overlap with unfinished frames
            self._drain_pending()
        with devrt.span("pass1"):
            decode_frame_pass1(f, self.tile_groups, two_pass=self._two_pass)

        # reference state update with the PASS-1 products (reference
        # src/decode.c:3669-3695).  Fresh slot objects: earlier
        # still-in-flight frames hold the old slot objects as their refs,
        # so a refresh must not mutate them.  slot.planes stays None
        # until this frame's pass 2 finishes — no later frame's pass 1
        # reads pixels, and finishes run in submission order, so a
        # dependent frame's pass 2 always sees filled ref planes.
        out_cdf = f.out_cdf if hdr.refresh_context else f.in_cdf
        slots = []
        for i in range(8):
            if hdr.refresh_frame_flags & (1 << i):
                slot = _RefSlot()
                slot.frame_hdr = hdr
                slot.seq_hdr = seq
                slot.segmap = f.cur_segmap
                slot.cdf = out_cdf
                slot.showable = bool(hdr.showable_frame)
                slot.visible = bool(hdr.show_frame)
                slot.refmvs = (f.rf.rp if f.rf is not None
                               and not hdr.allow_intrabc else None)
                slot.refpoc = list(f.refpoc)
                slot.ready.clear()  # pixels arrive at pass-2 finish
                self.refs[i] = slot
                slots.append(slot)

        # picture metadata binds at submission time (T.35 applies to the
        # next frame after the metadata OBU, reference src/obu.c:1500-1515)
        meta = (self.content_light, self.mastering_display, self.itut_t35)
        self.itut_t35 = []
        self._pending.append((f, hdr, meta, slots))
        delay = self.settings.max_frame_delay
        if delay <= 0:
            # auto: one frame in flight when the two-pass pipeline can
            # overlap device residual batches with the next pass 1;
            # with a worker pool, enough to keep every frame context
            # busy (reference get_frame_delay, src/lib.c:118-126)
            delay = 2 if self._two_pass else 1
            delay = max(delay, self.n_fc + 1)
        self._collect_futures(wait=False)
        while len(self._pending) + len(self._futures) > delay:
            if self._pending:
                self._finish_one()
            else:
                self._collect_futures(wait=True, one=True)

    def _finish_one(self) -> None:
        """Pass 2 + filter chain for the oldest in-flight frame; fills its
        ref-slot planes and emits its output picture.  With the
        reconstruction worker active this only *submits* — the worker
        runs frames strictly in order (slot.planes of frame N are bound
        on the worker before frame N+1's pass 2 reads them there)."""
        item = self._pending.pop(0)
        if self._worker is not None:
            self._futures.append(self._worker.submit(self._finish_task,
                                                     *item))
            return
        pic = self._finish_task(*item)
        if pic is not None:
            self.out_queue.append(pic)

    def _finish_task(self, f, hdr, meta, slots):
        try:
            # gate on the ref slots this frame actually reads — frames
            # whose references are already final (or that have none)
            # reconstruct concurrently on the worker pool
            if f.refp is not None:
                for slot in {id(s): s for s in f.refp if s is not None
                             }.values():
                    slot.ready.wait()
            try:
                decode_frame_finish(f)
            except BaseException:
                # planes are no longer pre-zeroed (bufpool); a frame
                # that errored half-written must stay deterministic in
                # case later frames still reference its slot
                for p in f.planes:
                    if p is not None:
                        p[:] = 0
                self.decode_error_props = getattr(f, "_props", None)
                raise
            for slot in slots:
                slot.planes = f.sr_planes
                slot.dev_planes = getattr(f, "_dev_planes", None)
        finally:
            # readiness publishes even on error: a dependent frame sees
            # planes=None and raises through the existing paths instead
            # of deadlocking behind a failed producer
            for slot in slots:
                slot.ready.set()
        # output (reference src/decode.c:3544: invisible frames are
        # output too when output_invisible_frames is set)
        pic = self._make_picture(f)
        pic.content_light, pic.mastering_display, pic.itut_t35 = meta
        if hdr.show_frame or self.settings.output_invisible_frames:
            pic.visible = bool(hdr.show_frame)
            return pic
        return None

    def _collect_futures(self, wait: bool, one: bool = False) -> None:
        """Move finished worker frames (in order) into the out queue."""
        while self._futures and (wait or self._futures[0].done()):
            pic = self._futures.pop(0).result()
            if pic is not None:
                self.out_queue.append(pic)
            if one:
                return

    def _drain_pending(self) -> None:
        while self._pending:
            self._finish_one()
        self._collect_futures(wait=True)

    def _show_existing(self) -> None:
        self._drain_pending()  # the shown slot's planes may be in flight
        hdr = self.frame_hdr
        slot = self.refs[hdr.existing_frame_idx]
        if slot.frame_hdr is None or slot.planes is None:
            raise obu_mod.ObuError("show_existing_frame without picture")
        w = slot.frame_hdr.width[1]
        h = slot.frame_hdr.height
        layout = slot.seq_hdr.layout
        planes = [slot.planes[0][:h, :w]]
        if layout != PixelLayout.I400:
            ss_hor = int(layout != PixelLayout.I444)
            ss_ver = int(layout == PixelLayout.I420)
            cw = (w + ss_hor) >> ss_hor
            ch = (h + ss_ver) >> ss_ver
            planes += [p[:ch, :cw] for p in slot.planes[1:]]
        pic = Picture(
            planes=planes, width=w, height=h,
            layout=layout, bitdepth=slot.seq_hdr.bitdepth,
            seq_hdr=slot.seq_hdr, frame_hdr=slot.frame_hdr,
            dev_planes=slot.dev_planes)
        self.out_queue.append(pic)
        if slot.frame_hdr.frame_type == FrameType.KEY:
            # key-frame ref propagation (reference src/obu.c:1620-1639)
            slot.showable = False
            for i in range(8):
                if i == hdr.existing_frame_idx:
                    continue
                self.refs[i] = slot

    def _make_picture(self, f: FrameContext) -> Picture:
        hdr = f.frame_hdr
        w = hdr.width[1]
        h = hdr.height
        planes = [f.sr_planes[0][:h, :w]]
        if f.layout != PixelLayout.I400:
            cw = (w + f.ss_hor) >> f.ss_hor
            ch = (h + f.ss_ver) >> f.ss_ver
            planes += [p[:ch, :cw] for p in f.sr_planes[1:]]
        return Picture(planes=planes, width=w, height=h, layout=f.layout,
                       bitdepth=f.bitdepth, seq_hdr=f.seq_hdr,
                       frame_hdr=hdr, props=getattr(f, "_props", None),
                       dev_planes=getattr(f, "_dev_planes", None))

    # -- output --------------------------------------------------------------

    def _maybe_apply_grain(self, pic: Picture) -> Picture:
        """Output-stage film grain (reference output_image, src/lib.c:311;
        reference pictures stay grain-free), on the decoder's device
        (recon/filmgrain.apply_grain: one film-grain kernel launch per
        plane with grain).  The kernel reads the frame's final planes
        where they stay resident (``Picture.dev_planes``: frames that
        refresh a reference slot, and shown existing frames), else the
        picture's planes, uploaded; the grained planes come down into
        pooled copies of the picture's planes, which replace them."""
        hdr = pic.frame_hdr
        dev_planes, pic.dev_planes = pic.dev_planes, None
        if not self.settings.apply_grain or hdr is None:
            return pic
        fg = hdr.film_grain
        d = fg.data
        if not fg.present or not (d.num_y_points or d.num_uv_points[0]
                                  or d.num_uv_points[1]):
            return pic
        from .recon.filmgrain import apply_grain
        from .bufpool import take as _take
        copies = []
        for p in pic.planes:
            c = _take(p.shape, p.dtype)
            c[:] = p
            copies.append(c)
        pic.planes = copies
        with devrt.span("grain"):
            apply_grain(pic, self.device, dev_planes)
        return pic

    def get_picture(self) -> Optional[Picture]:
        self._collect_futures(wait=False)
        while not self.out_queue and (self._pending or self._futures):
            if self._worker is not None:
                # keep the n_fc pool fed: submit every deferred frame
                # (each gates itself on its refs' readiness) BEFORE
                # blocking on the oldest — one-at-a-time submission
                # would serialize independent frames
                while self._pending:
                    self._finish_one()
                self._collect_futures(wait=True, one=True)
            else:
                self._finish_one()
                self._collect_futures(wait=not self._pending, one=True)
        if self.out_queue:
            return self._maybe_apply_grain(self.out_queue.pop(0))
        return None

    def flush(self) -> None:
        """Discard in-flight frames and queued output (reference
        dav1d_flush, src/lib.c:610-664 — pending frames are dropped, the
        caller restarts at a random access point)."""
        self._pending.clear()
        # let in-flight worker frames complete (they mutate ref slots);
        # discard their output and swallow their errors — the caller is
        # abandoning this decode position anyway
        for fut in self._futures:
            try:
                fut.result()
            except Exception:
                pass
        self._futures.clear()
        self.out_queue.clear()
        self.frame_hdr = None
        self.tile_groups = []
        self.n_tiles = 0

    def export_state(self) -> bytes:
        """Serialize the decode position: the 8-slot reference state
        (pictures, segmaps, per-slot CDFs, temporal MVs, ref POCs) plus
        sequence context.  This is the mid-GOP handoff protocol of the
        GOP-parallel axis (SURVEY §2.7 "GOPs → hosts"): a second host
        imports these bytes and continues the stream from here with
        byte-identical output — the ref-plane broadcast the reference's
        shared-memory frame threads get for free, made explicit.  Every
        sent TU must be fully decoded and drained (send_data + while
        get_picture()) before exporting.

        Uses pickle: the payload is decoder-internal state exchanged
        between trusted workers of one deployment, not a container
        format; import only states you produced."""
        self._collect_futures(wait=True)
        if self._pending or self.tile_groups:
            raise RuntimeError("export_state with frames in flight")
        slots = []
        for s in self.refs:
            slots.append(dict(
                frame_hdr=s.frame_hdr, seq_hdr=s.seq_hdr,
                planes=[np.ascontiguousarray(p) for p in s.planes]
                if s.planes is not None else None,
                segmap=s.segmap, cdf=s.cdf, showable=s.showable,
                visible=s.visible, refmvs=s.refmvs,
                refpoc=list(s.refpoc)))
        return pickle.dumps(dict(
            seq_hdr=self.seq_hdr,
            operating_point_idc=self.operating_point_idc,
            max_spatial_id=self.max_spatial_id,
            refs=slots), protocol=pickle.HIGHEST_PROTOCOL)

    def import_state(self, blob: bytes) -> None:
        """Seed this decoder from export_state() bytes (see there), this
        package's or the JAX package's (:func:`load_state`)."""
        st = load_state(blob)
        self.flush()
        self.seq_hdr = st["seq_hdr"]
        self.operating_point_idc = st["operating_point_idc"]
        self.max_spatial_id = st["max_spatial_id"]
        self.refs = []
        for sd in st["refs"]:
            s = _RefSlot()
            s.frame_hdr = sd["frame_hdr"]
            s.seq_hdr = sd["seq_hdr"]
            s.planes = sd["planes"]
            s.segmap = sd["segmap"]
            s.cdf = sd["cdf"]
            s.showable = sd["showable"]
            s.visible = sd["visible"]
            s.refmvs = sd["refmvs"]
            s.refpoc = list(sd["refpoc"])
            s.ready.set()
            self.refs.append(s)

    def close(self) -> None:
        self.flush()
        if self._worker is not None:
            self._worker.shutdown(wait=True)
            self._worker = None
        self.refs = [_RefSlot() for _ in range(8)]
        if self.settings.logger is not None:
            for line in memory_stats().splitlines():
                self._log(line)


# what a state blob may name besides this package's classes: numpy's
# array and dtype reconstructors and plain builtin types
_STATE_NUMPY = frozenset({"dtype", "ndarray", "_frombuffer", "_reconstruct",
                          "scalar"})
_STATE_BUILTINS = frozenset({"bool", "bytearray", "bytes", "complex", "dict",
                             "float", "frozenset", "int", "list", "range",
                             "set", "slice", "str", "tuple"})


class _StateUnpickler(pickle.Unpickler):
    """Unpickler of export_state() blobs.  ``dav1d_tpu.<mod>`` (the JAX
    package, whose blobs a relay may hand over) reads as
    ``dav1d_tpu_torch.<mod>``, whose classes are its verbatim copies; the
    JAX package itself is never imported.  Anything else but a class of
    this package, numpy's array reconstructors and plain builtin types
    is refused."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == "dav1d_tpu":
            module = "dav1d_tpu_torch" + module[len("dav1d_tpu"):]
            top = "dav1d_tpu_torch"
        if "." not in name:
            if top == "dav1d_tpu_torch":
                obj = super().find_class(module, name)
                if isinstance(obj, type) and obj.__module__ == module:
                    return obj
            elif (top == "numpy" and name in _STATE_NUMPY) or \
                    (module == "builtins" and name in _STATE_BUILTINS):
                return super().find_class(module, name)
        raise pickle.UnpicklingError(f"state blob names {module}.{name}, "
                                     "which a decoder state does not hold")


def load_state(blob: bytes) -> dict:
    """The dict an export_state() blob holds (see :class:`_StateUnpickler`
    for what it may name)."""
    return _StateUnpickler(io.BytesIO(blob)).load()


def memory_stats() -> str:
    """Per-category allocation accounting (the reference's
    TRACK_HEAP_ALLOCATIONS dump, src/mem.c:52-101 / src/lib.c:604):
    arena-pool allocs vs reuses and peak bytes, process-wide."""
    from .native.decode_glue import ALLOC_STATS

    lines = ["memory: category allocs reuses peak_bytes"]
    for name, (allocs, reuses, _cur, peak) in sorted(ALLOC_STATS.items()):
        lines.append(f"memory: {name} {allocs} {reuses} {peak}")
    return "\n".join(lines)
