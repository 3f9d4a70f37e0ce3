"""Host ms of pass 1 (span ``pass1``) over the frames decoded: those of
every unit sent from the window's start on, hidden frames included (the
drain after the window finishes the last of them, spans and all)."""


def read(rec):
    return _per_frame(rec, "pass1")


def _per_frame(rec, span):
    s = rec["spans"].get(span)
    if s is None or not rec["frames_decoded"]:
        return None
    return s * 1e3 / rec["frames_decoded"]
