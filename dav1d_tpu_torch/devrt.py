"""Device-dispatch funnel (counterpart of dav1d_tpu/devrt.py).

Every device operation of the decoder goes through :func:`call`, every
kernel launch through :func:`launch`, every upload through
:func:`upload` and every download through :func:`fetch` or
:func:`fetch_async`, so a run can observe what went to the device:

* ``SINK``: when a list, ``call`` appends ``(tag, fn, args, kw)``;
* ``XFER``: when a dict ``{"up": 0, "down": 0}``, uploads and downloads
  add their bytes;
* ``LAUNCHES``: kernel launches per tag.  Only :func:`launch` adds to it,
  and it is called only where a CUDA kernel is launched — a plain
  PyTorch version run on the CPU never counts;
* ``CAPTURE``: when a list, :func:`launch` appends ``(tag, cfn, args,
  keep)``, so a caller can repeat the bare C call (:func:`replay_ms`
  times launches that way; ``keep`` holds the device tensors the call
  reads that the wrapper does not return);
* ``SPANS``: when a dict, :func:`span` adds the host wall seconds of
  each decode stage (pass1, pass2, chain and their parts) under its tag;
* ``COUNTS``: work counted by the stages, always on: ``inter_blocks``
  (inter blocks of the decoded frames), ``mc_blocks`` (the blocks
  whose predictions the batched MC stage computed on the device),
  ``itx_blocks`` (the transform blocks whose residuals the itx stage
  computed), ``lr_wiener_units`` and ``lr_sgr_units`` (the stripe units
  the loop-restoration stage filtered); with device intra
  (recon/device_intra.py), ``intra_levels`` (the wavefront levels of
  its schedules), ``intra_{pred,cfl,pal}_units`` (the units of each
  kind), ``intra_{pred,cfl,pal}_levels`` (the levels holding units of
  each kind), ``intra_walk_launches`` (its walk launches: one per chain
  holding units) and ``intra_host_frames`` (the frames it handed to the
  host walk); with a mesh (mesh.py), ``halo_bytes`` (the halo rows the
  bands received: deblock's post-vertical rows and written-back rows,
  CDEF's pre-filter rows) and, per kind of band work, the bands or
  shares that launched it: ``mesh_deblock_v_bands``,
  ``mesh_deblock_h_bands``, ``mesh_cdef_dir_bands``,
  ``mesh_cdef_bands``, ``mesh_itx_shares``, ``mesh_lr_wiener_shares``,
  ``mesh_lr_sgr_shares``.

``XFER["mesh"]`` counts the bytes a mesh (mesh.Mesh.gather) moved
between devices or ranks.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import numpy as np
import torch

SINK = None
CAPTURE = None
XFER = None
SPANS = None
LAUNCHES: collections.Counter = collections.Counter()
COUNTS: collections.Counter = collections.Counter()
_LAUNCH_LOCK = threading.Lock()


def call(tag, fn, *args, **kw):
    """Run one device operation ``fn(*args, **kw)``; record it when a
    sink is installed."""
    if SINK is not None:
        SINK.append((tag, fn, args, kw))
    return fn(*args, **kw)


def launch(tag, cfn, *args, keep=None) -> None:
    """Call the C entry point ``cfn`` of a CUDA kernel, raise on a nonzero
    ``cudaError_t`` and count the launch under ``tag``.  ``keep``: the
    wrapper's temporaries that ``args`` point into (kept alive with a
    captured launch)."""
    if CAPTURE is not None:
        CAPTURE.append((tag, cfn, args, keep))
    rc = cfn(*args)
    if rc != 0:
        from .kernels.build import error_string

        raise RuntimeError(f"{tag}: CUDA launch failed: {rc} "
                           f"({error_string(rc)})")
    with _LAUNCH_LOCK:  # worker threads launch too (Settings.n_threads)
        LAUNCHES[tag] += 1


# launches queued behind one spin: well inside CUDA's queue of
# pending launches, which blocks the host once it is full (so a longer
# list could never be queued before its spin ends)
REPLAY_CHUNK = 256


def replay_ms(captured, reps=1):
    """Device ms of one pass over ``captured`` (``CAPTURE`` entries) run
    again back to back: ``reps`` passes of the bare C calls, in chunks of
    ``REPLAY_CHUNK`` launches, each chunk queued behind a spin kernel
    that outlasts the host's queueing and timed by CUDA events around it,
    so the card runs each chunk without the host between its launches.
    Returns (ms a pass, host ms of the queueing).  Raises if a launch
    fails."""
    calls = [(cfn, cargs) for _ in range(reps)
             for _, cfn, cargs, _ in captured]
    dev_ms = host_ms = 0.0
    for i in range(0, len(calls), REPLAY_CHUNK):
        d, h = _behind_spin(calls[i:i + REPLAY_CHUNK])
        dev_ms += d
        host_ms += h
    return dev_ms / reps, host_ms


def _behind_spin(calls):
    """(device ms, host ms of the queueing) of ``calls`` queued behind a
    spin kernel (~50 us a launch).  Where the host took longer to queue
    them than the spin lasted (the card would have waited on it inside
    the timed span), they run again behind a spin sized from that
    reading; raises if a third try is still outrun."""
    cycles = max(10_000_000, 100_000 * len(calls))
    for _ in range(3):
        torch.cuda.synchronize()
        es, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        h0 = time.perf_counter()
        es.record()
        torch.cuda._sleep(cycles)
        e0.record()
        rcs = [cfn(*cargs) for cfn, cargs in calls]
        host_ms = (time.perf_counter() - h0) * 1e3
        e1.record()
        torch.cuda.synchronize()
        if any(rcs):
            raise RuntimeError(f"replayed launches failed: {rcs}")
        spin_ms = es.elapsed_time(e0)
        if host_ms < spin_ms:
            return e0.elapsed_time(e1), host_ms
        cycles = int(cycles * 2 * host_ms / spin_ms)
    raise RuntimeError(f"queueing {len(calls)} launches took {host_ms:.3f} "
                       f"ms of host time, longer than the {spin_ms:.3f} ms "
                       "spin ahead of them")


@contextlib.contextmanager
def span(tag):
    """Time the enclosed stage into ``SPANS[tag]`` when spans are on."""
    if SPANS is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SPANS[tag] = SPANS.get(tag, 0.0) + time.perf_counter() - t0


def upload(a: np.ndarray, device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (transfer accounted)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if XFER is not None:
        XFER["up"] += a.nbytes
    return t


def fetch(x: torch.Tensor) -> np.ndarray:
    """Device tensor -> host numpy array (transfer accounted)."""
    a = x.cpu().numpy()
    if XFER is not None:
        XFER["down"] += a.nbytes
    return a


def fetch_async(x: torch.Tensor):
    """Start the download of ``x`` into pinned host memory on the current
    stream (transfer accounted); returns (host tensor, CUDA event), the
    host tensor valid once :func:`wait` on the event returns.  A CPU
    tensor is its own host copy (event None).  The counterpart of the
    reference's ``copy_to_host_async`` (dav1d_tpu/pipeline.py:162-163)."""
    if x.device.type == "cpu":
        host, event = x, None
    else:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(x.device))
    if XFER is not None:
        XFER["down"] += host.numel() * host.element_size()
    return host, event


def wait(event) -> None:
    """Block until the download started by :func:`fetch_async` is done."""
    if event is not None:
        event.synchronize()


def narrow_cast(bitdepth: int):
    """Cast of an int32 pixel plane to its narrow storage dtype before a
    download: uint8 at 8-bit, int16 above (torch has no uint16
    arithmetic; pixels stay below 4096).  Every filter stage clips into
    [0, 2^bd), so the cast is exact and moves 4x (8-bit) / 2x
    (10/12-bit) fewer bytes."""
    dt = torch.uint8 if bitdepth == 8 else torch.int16
    return lambda p: p.to(dt)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device, a CUDA one with its index; raises
    when it is a CUDA device and CUDA is not available (no silent CPU
    run), and on any device that is neither CPU nor CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but CUDA "
                               "is not available (pass device='cpu' to "
                               "run the plain PyTorch versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
