"""MB uploaded and downloaded (``XFER`` up + down) over the frames decoded."""


def read(rec):
    x = rec["xfer"]
    if not x or not rec["frames_decoded"]:
        return None
    return (x.get("up", 0) + x.get("down", 0)) / 1e6 / rec["frames_decoded"]
