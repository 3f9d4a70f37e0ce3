"""Host ms of the output stage's film grain (span ``grain``: the pooled
copies of the picture's planes, the host tables, the uploads, the
film-grain kernel and the download) over the pictures grained
(``COUNTS`` ``grain.pictures``)."""


def read(rec):
    s = rec["spans"].get("grain")
    n = rec["counts"].get("grain.pictures")
    if s is None or not n:
        return None
    return s * 1e3 / n
