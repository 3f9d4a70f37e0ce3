"""Host ms of the filter chain (span ``chain``) over the frames decoded."""


def read(rec):
    return _per_frame(rec, "chain")


def _per_frame(rec, span):
    s = rec["spans"].get(span)
    if s is None or not rec["frames_decoded"]:
        return None
    return s * 1e3 / rec["frames_decoded"]
