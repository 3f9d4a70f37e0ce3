"""MB the output stage's film grain moved a picture grained: the tables
and any planes uploaded, the grained planes fetched and the pooled
copies of the picture's planes (``COUNTS`` ``grain.up_bytes`` +
``grain.down_bytes`` + ``grain.copy_bytes`` over ``grain.pictures``)."""

PARTS = ("grain.up_bytes", "grain.down_bytes", "grain.copy_bytes")


def read(rec):
    c = rec["counts"]
    n = c.get("grain.pictures")
    if not n or not any(k in c for k in PARTS):
        return None
    return sum(c.get(k, 0) for k in PARTS) / 1e6 / n
