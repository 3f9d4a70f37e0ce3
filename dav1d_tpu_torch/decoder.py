"""Public decoder of the port (counterpart of dav1d_tpu/decoder.py).

``Decoder(settings, device="cuda")`` is the reference's decoder — the
same API (send_data / get_picture / flush / close / export_state /
import_state), the same Settings and Picture — with its frames decoded
through the port: pass 1 and the finish come from
dav1d_tpu_torch/decode/frame.py, so the in-loop filter chain runs on
``device``.

The device is explicit.  It defaults to ``"cuda"``; without CUDA the
constructor raises instead of running on the CPU.  The CPU tests pass
``device="cpu"``, where the chain runs the plain PyTorch versions of its
kernels.

The reference binds its frame functions by name at import
(dav1d_tpu/decoder.py:17-18), so this class overrides the methods that
call them, ``_submit_frame`` and ``_finish_task``, and the output-stage
film grain ``_maybe_apply_grain``; it rebinds nothing in ``dav1d_tpu``:
both packages decode side by side in one process.  No stage of the
port's decode consults ``dav1d_tpu.dispatch``, so the decode never
imports jax nor runs a jax program, whatever is installed.
"""

from __future__ import annotations

import torch

from dav1d_tpu import obu as obu_mod
from dav1d_tpu.decode.frame import FrameContext
from dav1d_tpu.decoder import (DataProps, Picture,  # noqa: F401  (API)
                               Settings, _RefSlot)
from dav1d_tpu.bufpool import take as _take
from dav1d_tpu.decoder import Decoder as _RefDecoder
from dav1d_tpu.headers import PRIMARY_REF_NONE

from . import devrt
from .decode.frame import decode_frame_finish, decode_frame_pass1
from .recon.filmgrain import apply_grain


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it is a CUDA device and
    CUDA is not available (no silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available (pass device='cpu' to run the "
                               "plain PyTorch versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class Decoder(_RefDecoder):
    """The reference decoder with the port's frame pipeline."""

    def __init__(self, settings: Settings | None = None, device="cuda"):
        self.device = resolve_device(device)
        super().__init__(settings)
        if self.settings.mesh is not None:
            raise ValueError("Settings.mesh is a JAX mesh; the port runs "
                             "on one torch device")

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
        f.mesh = None
        f.n_threads = self.settings.n_threads
        f.device = self.device
        f._props = self._cur_props
        two_pass = self.settings.two_pass
        if not two_pass:
            # fused reconstruction reads ref pixels during pass 1 —
            # cannot overlap with unfinished frames
            self._drain_pending()
        with devrt.span("pass1"):
            decode_frame_pass1(f, self.tile_groups, two_pass=two_pass)

        # reference state update with the pass-1 products (fresh slot
        # objects: in-flight frames hold the old ones as their refs)
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

        meta = (self.content_light, self.mastering_display, self.itut_t35)
        self.itut_t35 = []
        self._pending.append((f, hdr, meta, slots))
        delay = self.settings.max_frame_delay
        if delay <= 0:
            delay = max(2 if two_pass else 1, self.n_fc + 1)
        self._collect_futures(wait=False)
        while len(self._pending) + len(self._futures) > delay:
            if self._pending:
                self._finish_one()
            else:
                self._collect_futures(wait=True, one=True)

    def _finish_task(self, f, hdr, meta, slots):
        try:
            # gate on the ref slots this frame actually reads
            if f.refp is not None:
                for slot in {id(s): s for s in f.refp if s is not None
                             }.values():
                    slot.ready.wait()
            try:
                decode_frame_finish(f)
            except BaseException:
                # a frame that errored half-written must stay
                # deterministic in case later frames reference its slot
                for p in f.planes:
                    if p is not None:
                        p[:] = 0
                self.decode_error_props = getattr(f, "_props", None)
                raise
            for slot in slots:
                slot.planes = f.sr_planes
        finally:
            # readiness publishes even on error (no deadlock behind a
            # failed producer)
            for slot in slots:
                slot.ready.set()
        pic = self._make_picture(f)
        pic.content_light, pic.mastering_display, pic.itut_t35 = meta
        if hdr.show_frame or self.settings.output_invisible_frames:
            pic.visible = bool(hdr.show_frame)
            return pic
        return None

    def _maybe_apply_grain(self, pic: Picture) -> Picture:
        """Output-stage film grain on the host (reference output_image,
        src/lib.c:311; reference pictures stay grain-free)."""
        hdr = pic.frame_hdr
        if not self.settings.apply_grain or hdr is None:
            return pic
        fg = hdr.film_grain
        d = fg.data
        if not fg.present or not (d.num_y_points or d.num_uv_points[0]
                                  or d.num_uv_points[1]):
            return pic
        copies = []
        for p in pic.planes:
            c = _take(p.shape, p.dtype)
            c[:] = p
            copies.append(c)
        pic.planes = copies
        apply_grain(pic)
        return pic
