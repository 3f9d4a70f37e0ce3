"""Drains of the frame pipeline a decoded frame: the times the caller
waited for every frame in flight (``COUNTS`` ``frames.drains``) over the
frames decoded.  The window's counts leave out a count that did not
move, so a program that keeps the pipeline's counts and never drained
reads 0 where it queued a shown existing frame behind the frames in
flight (``frames.existing_queued``); None where neither count is there,
as for a program without them."""


def read(rec):
    c = rec["counts"]
    if ("frames.drains" not in c and "frames.existing_queued" not in c) \
            or not rec["frames_decoded"]:
        return None
    return c.get("frames.drains", 0) / rec["frames_decoded"]
