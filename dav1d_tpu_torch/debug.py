"""Bit-exactness triage: per-symbol trace in the reference's
DEBUG_BLOCK_INFO format (reference src/recon.h:34, printfs in decode.c /
recon_tmpl.c), so traces diff 1:1 against a debug build of the oracle.

Enable with DAV1D_TPU_TRACE=1 or debug.TRACE = True.
"""

import os
import sys

TRACE = bool(int(os.environ.get("DAV1D_TPU_TRACE", "0")))


def trace(fmt, *args):
    if TRACE:
        print(fmt % args if args else fmt, file=sys.stdout)
