"""Host ms of pass 2 (span ``pass2``) over the frames decoded."""


def read(rec):
    return _per_frame(rec, "pass2")


def _per_frame(rec, span):
    s = rec["spans"].get(span)
    if s is None or not rec["frames_decoded"]:
        return None
    return s * 1e3 / rec["frames_decoded"]
