"""Share of inter blocks whose prediction the device MC computed
(``COUNTS`` ``mc_blocks`` over ``inter_blocks``), %."""


def read(rec):
    c = rec["counts"]
    if not c.get("inter_blocks"):
        return None
    return 100.0 * c.get("mc_blocks", 0) / c["inter_blocks"]
