"""CDF context: per-tile adaptive probability state.

Mirrors the reference's CdfContext capability (reference src/cdf.h:129-134,
src/cdf.c:3915-4065): default tables per quantizer category, per-tile mutable
copies adapted by the MSAC decoder, and the post-frame `update` that
propagates adapted probabilities with their counters reset (refresh_context).

Arrays keep the reference's padded trailing dims; the adaptation counter
lives at index n_symbols of the last axis (n_symbols = alphabet size - 1).
"""

from __future__ import annotations

import numpy as np

from . import tables


class _Group:
    """Attribute bag of numpy arrays."""

    def __init__(self, arrays: dict[str, np.ndarray]):
        self.__dict__.update(arrays)

    def copy(self) -> "_Group":
        return _Group({k: v.copy() for k, v in self.__dict__.items()})


class MvComp(_Group):
    pass


# count-slot index (= n_symbols at the decode call site) per field;
# callables receive the leading index tuple. From reference
# dav1d_cdf_thread_update (src/cdf.c:3932-4020).
_COEF_NSYM = {
    "eob_bin_16": 4, "eob_bin_32": 5, "eob_bin_64": 6, "eob_bin_128": 7,
    "eob_bin_256": 8, "eob_bin_512": 9, "eob_bin_1024": 10,
    "eob_base_tok": 2, "base_tok": 3, "br_tok": 3, "eob_hi_bit": 1,
    "skip": 1, "dc_sign": 1,
}

_M_NSYM_INTRA = {
    "uv_mode": lambda idx: 13 if idx[0] else 12,
    "partition": lambda idx: 7 if idx[0] == 0 else (3 if idx[0] == 4 else 9),
    "cfl_alpha": 15, "txtp_inter1": 15, "txtp_inter2": 11,
    "txtp_intra1": 6, "txtp_intra2": 4, "cfl_sign": 7, "angle_delta": 6,
    "filter_intra": 4, "seg_id": 7, "pal_sz": 6,
    "color_map": lambda idx: idx[1] + 1,
    "txsz": lambda idx: min(idx[0] + 1, 2),
    "delta_q": 3, "delta_lf": 3, "restore_switchable": 2,
    "restore_wiener": 1, "restore_sgrproj": 1, "txtp_inter3": 1,
    "use_filter_intra": 1, "txpart": 1, "skip": 1, "pal_y": 1, "pal_uv": 1,
}

_M_NSYM_INTER = {
    "y_mode": 12, "wedge_idx": 15, "comp_inter_mode": 7, "filter": 2,
    "interintra_mode": 3, "motion_mode": 2, "skip_mode": 1, "newmv_mode": 1,
    "globalmv_mode": 1, "refmv_mode": 1, "drl_bit": 1, "intra": 1, "comp": 1,
    "comp_dir": 1, "jnt_comp": 1, "mask_comp": 1, "wedge_comp": 1, "ref": 1,
    "comp_fwd_ref": 1, "comp_bwd_ref": 1, "comp_uni_ref": 1, "seg_pred": 1,
    "interintra": 1, "interintra_wedge": 1, "obmc": 1,
}

_MV_NSYM = {
    "classes": 10, "sign": 1, "class0": 1, "class0_fp": 3, "class0_hp": 1,
    "classN": 1, "classN_fp": 3, "classN_hp": 1,
}


def _copy_reset(dst: np.ndarray, src: np.ndarray, nsym) -> None:
    """dst <- src with the adaptation counter(s) zeroed."""
    np.copyto(dst, src)
    if callable(nsym):
        lead = dst.shape[:-1]
        it = np.ndindex(*lead) if lead else iter([()])
        for idx in it:
            dst[idx + (nsym(idx),)] = 0
    else:
        dst[..., nsym] = 0


class CdfContext:
    """coef + m + mv[2] + kfym probability arrays."""

    def __init__(self, coef: _Group, m: _Group, mv: list[MvComp],
                 mv_joint: np.ndarray, kfym: np.ndarray):
        self.coef = coef
        self.m = m
        self.mv = mv
        self.mv_joint = mv_joint
        self.kfym = kfym

    @classmethod
    def from_defaults(cls, qidx: int) -> "CdfContext":
        qcat = (qidx > 20) + (qidx > 60) + (qidx > 120)
        coef = _Group({k: v.copy() for k, v in
                       tables.default_cdf_coef(qcat).items()})
        mode = tables.default_cdf_mode()
        m = _Group({k[len("m."):]: v.copy() for k, v in mode.items()
                    if k.startswith("m.")})
        comp_fields = {k.split("].")[1]: v for k, v in mode.items()
                       if k.startswith("mv.comp[0].")}
        mv = [MvComp({k: v.copy() for k, v in comp_fields.items()})
              for _ in range(2)]
        return cls(coef, m, mv, mode["mv.joint"].copy(),
                   mode["kfym"].copy())

    def copy(self) -> "CdfContext":
        return CdfContext(
            self.coef.copy(), self.m.copy(),
            [MvComp({k: v.copy() for k, v in c.__dict__.items()})
             for c in self.mv],
            self.mv_joint.copy(), self.kfym.copy(),
        )

    def update(self, src: "CdfContext", frame_is_intra: bool) -> None:
        """Refresh-context propagation: copy src's adapted probabilities for
        the refreshable fields, resetting counters; intrabc and kfym are
        never propagated (reference src/cdf.c:3915-4021)."""
        for name, nsym in _COEF_NSYM.items():
            _copy_reset(getattr(self.coef, name), getattr(src.coef, name), nsym)
        for name, nsym in _M_NSYM_INTRA.items():
            _copy_reset(getattr(self.m, name), getattr(src.m, name), nsym)
        if frame_is_intra:
            return
        for name, nsym in _M_NSYM_INTER.items():
            _copy_reset(getattr(self.m, name), getattr(src.m, name), nsym)
        for k in range(2):
            for name, nsym in _MV_NSYM.items():
                _copy_reset(getattr(self.mv[k], name),
                            getattr(src.mv[k], name), nsym)
        _copy_reset(self.mv_joint, src.mv_joint, 3)
