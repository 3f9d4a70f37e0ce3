"""Decoder construction and close, ms, mean over the window's clips
(the harness's clock around them)."""


def read(rec):
    ms = rec["api_ms"]
    return sum(ms) / len(ms) if ms else None
