"""Share of the pictures grained whose planes the film-grain kernel read
resident on the card, with no upload (``COUNTS`` ``grain.resident`` over
``grain.pictures``), %."""


def read(rec):
    c = rec["counts"]
    n = c.get("grain.pictures")
    if not n:
        return None
    return 100.0 * c.get("grain.resident", 0) / n
