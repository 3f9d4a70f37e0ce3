"""Device-dispatch funnel (counterpart of dav1d_tpu/devrt.py).

Every device operation of the decoder goes through :func:`call`, every
kernel launch through :func:`launch`, every upload through
:func:`upload` and every download through :func:`fetch` or
:func:`fetch_async`, so a run can observe what went to the device:

* ``SINK``: when a list, ``call`` appends ``(tag, fn, args, kw)``;
* ``XFER``: when a dict ``{"up": 0, "down": 0}``, uploads and downloads
  add their bytes, as totals under ``up`` and ``down`` and apart by the
  host memory they move through under ``up_pageable``, ``up_pinned``,
  ``down_pageable`` and ``down_pinned`` (:func:`upload` and
  :func:`fetch` copy through pageable memory, :func:`fetch_async` on a
  card through pinned memory);
* ``LAUNCHES``: kernel launches per tag.  Only :func:`launch` adds to it,
  and it is called only where a CUDA kernel is launched — a plain
  PyTorch version run on the CPU never counts;
* ``CAPTURE``: when a list, :func:`launch` appends ``(tag, cfn, args,
  keep)``, so a caller can repeat the bare C call (:func:`replay_ms`
  times launches that way; ``keep`` holds the device tensors the call
  reads that the wrapper does not return);
* ``SPANS``: when a dict, :func:`span` adds the host wall seconds of
  each decode stage (pass1, pass2, chain and their parts) under its tag,
  from whichever thread runs it; the decoder's API calls (``api.open``,
  ``api.send``, ``api.get``, ``api.close``), the caller's time between
  them (``api.client``), its waits (``wait.frames``: the caller blocked
  on a frame worker; ``wait.refs``: a worker blocked on a reference
  slot), each frame's time between its pass 1 and the start of its
  reconstruction (``frame.queued``) and the return of its capture
  arenas after the chain (``frame.release``) go there too.  Beside them
  ``frames.busy``, the seconds in which at least one frame stage
  (:data:`FRAME_STAGES`) is open on any thread, and ``pass2.cpu`` and
  ``chain.cpu``, the thread CPU seconds inside those spans
  (:data:`CPU_SPANS`);
* ``RANGES``: when true, :func:`span` also opens a
  ``torch.profiler.record_function`` range named by its tag, so the
  stages sit in a profiler's trace beside the kernels and copies they
  start, on its clock; :func:`trace_to` sets it around a profiled run
  and writes the trace, each range with the frame it works on
  (:func:`frame`) and its parent span on its thread;
* ``COUNTS``: work counted by the stages, always on: ``inter_blocks``
  (inter blocks of the decoded frames), ``mc_blocks`` (the blocks
  whose predictions the batched MC stage computed on the device),
  ``mc_compound_blocks`` (those of them with two references, counted
  in ``mc_blocks`` too),
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
  ``mesh_lr_sgr_shares``; with film grain at output
  (decoder.Decoder._maybe_apply_grain, recon/filmgrain.apply_grain),
  ``grain.pictures`` and ``grain.planes`` (pictures and planes grained),
  ``grain.resident`` (pictures whose planes the kernel read resident,
  with no upload), ``grain.up_bytes`` (the tables and any planes
  uploaded), ``grain.down_bytes`` (the grained planes fetched) and
  ``grain.copy_bytes`` (the pooled copies of the picture's planes that
  the grained planes replace).

``XFER["mesh"]`` counts the bytes a mesh (mesh.Mesh.gather) moved
between devices or ranks.

With ``SPANS``, ``XFER`` and ``RANGES`` unset (the default) each site
costs its early return: no clock is read and no lock is taken.  To see
where a decode's time goes::

    with devrt.trace_to("trace.json", device):
        ...  # decode

writes one Chrome trace (chrome://tracing, Perfetto) of the stage
ranges, the torch ops and, on a card, the kernels and copies;
``python -m dav1d_tpu_torch.cli ... --trace-out trace.json`` does so
around a CLI decode.
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
RANGES = False
LAUNCHES: collections.Counter = collections.Counter()
COUNTS: collections.Counter = collections.Counter()
_LAUNCH_LOCK = threading.Lock()
# the stages a frame is in while it is worked on: frames.busy is the
# union of their spans over the process's threads
FRAME_STAGES = frozenset({"pass1", "pass2", "chain"})
# spans whose thread CPU seconds are summed beside their wall seconds
CPU_SPANS = {"pass2": "pass2.cpu", "chain": "chain.cpu"}
_SPAN_LOCK = threading.Lock()
_busy = [0, 0.0]  # frame stages open in the process, and since when
# per thread: ``frame``, the id of the frame it works on (with RANGES),
# and ``stack``, the tags of its open ranges
_local = threading.local()
# with RANGES: (native thread id, tag, frame id, parent tag) of every
# range opened, in the order each thread opened them
RANGE_LOG: list = []


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


# what span and frame return while tracing is off
_OFF = contextlib.nullcontext()


def span(tag):
    """A context that times the enclosed stage into ``SPANS[tag]`` when
    spans are on, and opens a profiler range named ``tag`` when
    ``RANGES`` is."""
    spans = SPANS
    if spans is None and not RANGES:
        return _OFF
    return _traced(spans, tag)


@contextlib.contextmanager
def _traced(spans, tag):
    with contextlib.ExitStack() as stack:
        if RANGES:
            stack.enter_context(_range(tag))
        if spans is not None:
            stack.enter_context(_timed(spans, tag))
        yield


@contextlib.contextmanager
def _timed(spans, tag):
    """``span``'s seconds, with ``frames.busy`` and the thread CPU
    seconds of :data:`CPU_SPANS`."""
    cpu = CPU_SPANS.get(tag)
    stage = tag in FRAME_STAGES
    c0 = time.thread_time() if cpu else 0.0
    t0 = time.perf_counter()
    if stage:
        with _SPAN_LOCK:  # frame workers open and close spans too
            if not _busy[0]:
                _busy[1] = t0
            _busy[0] += 1
    try:
        yield
    finally:
        t1 = time.perf_counter()
        c1 = time.thread_time() if cpu else 0.0
        with _SPAN_LOCK:
            spans[tag] = spans.get(tag, 0.0) + t1 - t0
            if cpu:
                spans[cpu] = spans.get(cpu, 0.0) + c1 - c0
            if stage:
                _busy[0] -= 1
                if not _busy[0]:
                    spans["frames.busy"] = (spans.get("frames.busy", 0.0)
                                            + t1 - _busy[1])


@contextlib.contextmanager
def _range(tag):
    """A ``torch.profiler.record_function`` range named ``tag``, logged
    in :data:`RANGE_LOG` with its frame and parent."""
    from torch.profiler import record_function

    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    RANGE_LOG.append((threading.get_native_id(), tag,
                      getattr(_local, "frame", None),
                      stack[-1] if stack else None))
    stack.append(tag)
    try:
        with record_function(tag):
            yield
    finally:
        stack.pop()


def frame(fid):
    """A context that marks the enclosed work, on this thread, as frame
    ``fid``'s (``(decoder serial, decode index)``): the ranges opened
    inside carry it (with ``RANGES`` only)."""
    return _OFF if not RANGES else _in_frame(fid)


@contextlib.contextmanager
def _in_frame(fid):
    prev = getattr(_local, "frame", None)
    _local.frame = fid
    try:
        yield
    finally:
        _local.frame = prev


def stamp():
    """``time.perf_counter()`` while spans are on, else None."""
    return None if SPANS is None else time.perf_counter()


def add_since(tag, t0) -> None:
    """Add the seconds since :func:`stamp` ``t0`` to ``SPANS[tag]``;
    nothing where ``t0`` is None or spans are off."""
    spans = SPANS
    if t0 is None or spans is None:
        return
    dt = time.perf_counter() - t0
    with _SPAN_LOCK:
        spans[tag] = spans.get(tag, 0.0) + dt


@contextlib.contextmanager
def trace_to(path, device="cpu"):
    """Profile the enclosed code with ``torch.profiler`` (CPU activity on
    every thread, and CUDA activity where ``device`` is a card), every
    :func:`span` a range of the trace (``RANGES``); keep the trace in
    memory and at exit write it to ``path`` as one Chrome trace, each
    range's args holding ``frame`` (``d<decoder>.f<index>``, where it
    works on a frame) and ``parent`` (the enclosing span on its
    thread)."""
    global RANGES
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda" and torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # frame workers are threads the profiler would not follow otherwise
    prof = profile(activities=acts, experimental_config=_ExperimentalConfig(
        profile_all_threads=True))
    RANGE_LOG.clear()
    prof.start()
    RANGES = True
    try:
        yield
    finally:
        RANGES = False
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        log, RANGE_LOG[:] = list(RANGE_LOG), []
        _write_trace(prof, path, log)


def _write_trace(prof, path, log) -> None:
    """Export ``prof``'s Chrome trace to ``path`` with each range of
    ``log`` given its ``frame`` and ``parent`` args: the ranges of one tag
    on one thread match the log's entries in the order they opened."""
    import json
    from pathlib import Path

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    want = collections.defaultdict(list)
    for tid, tag, fid, parent in log:
        want[(tid, tag)].append((fid, parent))
    got = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and \
                (e.get("tid"), e.get("name")) in want:
            got[(e["tid"], e["name"])].append(e)
    for key, events in got.items():
        if len(events) != len(want[key]):
            continue  # a range the profiler dropped: leave the tag's bare
        events.sort(key=lambda e: e["ts"])
        for e, (fid, parent) in zip(events, want[key]):
            args = e.setdefault("args", {})
            if fid is not None:
                args["frame"] = f"d{fid[0]}.f{fid[1]}"
            args["parent"] = parent
    path.write_text(json.dumps(trace))


def upload(a: np.ndarray, device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (transfer accounted)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if XFER is not None:
        _xfer("up", "up_pageable", a.nbytes)
    return t


def fetch(x: torch.Tensor) -> np.ndarray:
    """Device tensor -> host numpy array (transfer accounted)."""
    a = x.cpu().numpy()
    if XFER is not None:
        _xfer("down", "down_pageable", a.nbytes)
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
        _xfer("down", "down_pinned" if event is not None else "down_pageable",
              host.numel() * host.element_size())
    return host, event


def _xfer(total, part, nbytes) -> None:
    """Add ``nbytes`` to ``XFER[total]`` and ``XFER[part]``."""
    xfer = XFER
    if xfer is None:
        return
    with _SPAN_LOCK:  # frame workers move bytes too
        xfer[total] += nbytes
        xfer[part] = xfer.get(part, 0) + nbytes


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
