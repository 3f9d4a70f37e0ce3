"""The benchmark's core: a cell's sessions, its measured window, its
end-to-end metrics, and the record that the per-layer readers read.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``: the clips, their reference digests and the
decoder's ``Settings``) and a traffic mix (``traffic/<mix>.json``, whose
parameters ``generator.py``, the one generator of load, reads and
checks).  Every session sends its requests, as the mix says, for
``--seconds`` from a start that all sessions share; after the window
has closed it drains its decoder and judges what it returned
(``check.py``).  The decoder sees only the clips' bytes.
"""

from __future__ import annotations

import collections
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

import generator

HERE = Path(__file__).resolve().parent
# the program under test, and what no process of a run may load: the
# JAX package it was ported from, JAX itself, and libraries built on it
PROGRAM = "dav1d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "dav1d_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names of ``modules`` (default ``sys.modules``) that are
    forbidden, compared whole (``dav1d_tpu_torch`` is not
    ``dav1d_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# -- the spec ----------------------------------------------------------------


def load_cell(root: Path, workload: str) -> dict:
    """The cell's spec entries and files, found by name: its workload,
    configuration (the file its ``configs`` entry names), traffic mix
    (``av1bench/traffic/<mix>.json``, checked by
    :func:`generator.parse_mix`), and the metrics it reports."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    path = root / "av1bench" / "traffic" / f"{cell['traffic']}.json"
    if not path.is_file():
        raise SystemExit(f"unknown traffic mix {cell['traffic']!r}: no "
                         f"{path.relative_to(root)}")
    try:
        mix = generator.parse_mix(json.loads(path.read_text()))
    except ValueError as e:
        raise SystemExit(f"{path.relative_to(root)}: {e}") from None
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return {"root": root, "cell": cell, "config": config, "mix": mix,
            "end_to_end": e2e, "per_layer": per_layer,
            "run_seconds": spec["run_seconds"]}


def reader(root: Path, name: str):
    """The ``read(rec)`` function of per-layer metric ``name``
    (``av1bench/metrics/<name>.py``)."""
    path = root / "av1bench" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"av1bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def _resolve(path: str):
    mod, _, attr = path.partition(":")
    return getattr(importlib.import_module(mod), attr)


# -- one session ---------------------------------------------------------------


class _Session:
    """The decode loop of one session and what it records."""

    def __init__(self, job: dict):
        import torch

        sys.path.insert(0, str(job["root"]))
        self.job = job
        root, cfg = job["root"], job["config"]
        self.mix = job["mix"]
        self.device = torch.device(job["device"])
        self.devrt = importlib.import_module(f"{PROGRAM}.devrt")
        self.tables = importlib.import_module(f"{PROGRAM}.tables")
        settings_cls = _resolve(f"{PROGRAM}.decoder:Settings")
        self.decoder_cls = _resolve(job["decoder"])
        over = cfg["control"]["settings"] if job["control"] else {}
        self.settings = lambda: settings_cls(**{**cfg["settings"], **over})
        import check
        import ivf

        sdir = root / cfg["streams"]
        self.units = [ivf.read((sdir / f).read_bytes())
                      for f in cfg["clip_files"]]
        self.ref = check.load_reference(root, cfg)
        self.frames = [c["frames"] for c in self.ref["clips"]]
        self.judge = check.Judge(self.ref, cfg["bitdepth"])
        self.sample = np.random.default_rng([job["seed"], 2, job["index"]])
        self.sample_p = 1.0 / cfg["sample_every"]
        self.requests = generator.requests(self.mix, job["seed"],
                                           job["index"],
                                           [len(u) for u in self.units])
        self.lat, self.late, self.clip_ms, self.api_ms = [], [], [], []
        self.pictures = self.frames_sent = 0
        self.t0, self.t_end = 0.0, float("inf")
        self.dec = None

    def open(self):
        return self.decoder_cls(self.settings(), device=self.device)

    def load_tables(self) -> None:
        """Read every table of the program once, here, before any decoder
        thread starts.  The program reads its tables lazily from one zip
        file, and pass 1's tile threads, reading it at once on a process's
        first frames, have failed on it (``zipfile.BadZipFile``: a fault
        of the program, PERF.md's first open question); once each is
        read, no thread opens the file again.  To be taken out by a
        benchmark PR after the program's repair of the fault."""
        for name in self.tables._z().files:
            getattr(self.tables, name)

    def warm_up(self) -> None:
        """The first ``warmup_tus`` units of the first clip through a
        decoder of the cell's settings, judged like the window's
        pictures: every clip has the frame size and the coding tools of
        the others."""
        self.load_tables()
        n = min(self.job["config"]["warmup_tus"], len(self.units[0]))
        dec = self.open()
        inflight = collections.deque()
        for tu in range(n):
            self._send(dec, inflight, 0, tu, timed=False)
            if len(inflight) >= self.mix.in_flight:
                self._got(dec.get_picture(), inflight.popleft())
        while inflight:
            self._got(dec.get_picture(), inflight.popleft())
        dec.close()

    def _pace(self, k: int):
        """The due time of the window's ``k``-th unit in an open loop
        (waited for), or None in a closed loop."""
        if self.mix.pace_fps is None:
            return None
        due = self.t0 + k / self.mix.pace_fps
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        return due

    def _send(self, dec, inflight, clip, tu, timed=True, deliver=True,
              due=None) -> None:
        self.judge.expect(clip, tu)
        inflight.append((time.perf_counter(), timed and deliver, due))
        dec.send_data(self.units[clip][tu])
        if timed:
            self.frames_sent += self.frames[clip][tu]

    def _got(self, pic, sent) -> float:
        """Judge a returned picture; record it where it is delivered in
        the window (a sample of the window's pictures is kept for the
        comparison after it)."""
        t = time.perf_counter()
        if pic is None:
            return t
        sent_at, counted, due = sent
        keep = counted and self.sample.random() < self.sample_p
        self.judge.seen(pic.planes, keep)
        if counted and t <= self.t_end:
            self.pictures += 1
            self.lat.append(t - sent_at)
            if due is not None:
                self.late.append(t - due - self.mix.in_flight
                                 / self.mix.pace_fps)
        return t

    def drive(self, units=None) -> int:
        """Send the mix's requests until the window closes (``units``
        None) or, untimed, until ``units`` temporal units have been sent;
        a request that has begun is finished where it has a decoder of
        its own, and every unit sent is answered.  Returns the units
        sent."""
        timed = units is None
        per_request = self.mix.decoder == "request"
        inflight = collections.deque()
        sent = 0

        def over():
            return (time.perf_counter() >= self.t_end if timed
                    else sent >= units)

        dec = self.dec
        while not over():
            req = next(self.requests)
            if per_request:
                t_open = time.perf_counter()
                dec = self.open()
                open_s = time.perf_counter() - t_open
                last = t_open
            for tu in range(req.units):
                if not per_request and over():
                    break
                due = self._pace(sent) if timed else None
                self._send(dec, inflight, req.clip, tu, timed,
                           tu >= req.deliver_from, due)
                sent += 1
                if len(inflight) >= self.mix.in_flight:
                    last = self._got(dec.get_picture(), inflight.popleft())
            if per_request:
                while inflight:
                    last = self._got(dec.get_picture(), inflight.popleft())
                t_close = time.perf_counter()
                dec.close()
                close_s = time.perf_counter() - t_close
                if timed and last <= self.t_end:
                    self.clip_ms.append((last - t_open) * 1e3)
                    self.api_ms.append((open_s + close_s) * 1e3)
        while inflight:
            self._got(dec.get_picture(), inflight.popleft())
        return sent


def session(job: dict, sync) -> dict:
    """Run one session: set-up (the program, its build on a checkout's
    first run, the clips, warm-up), ``sync()`` for the window's start,
    the window, the drain, the judgement, and in a traced run on a card
    the roofline's sample after it.  Returns what it recorded."""
    import torch

    s = _Session(job)
    devrt = s.devrt
    s.warm_up()
    cuda = s.device.type == "cuda"
    tracer = None
    if job["trace"] and cuda:
        import devtrace as dtrace

        tracer = dtrace.DeviceTrace()
    if s.mix.decoder == "session":
        s.dec = s.open()
    if job["trace"]:
        devrt.SPANS, devrt.XFER = {}, {"up": 0, "down": 0}
    if tracer is not None:
        tracer.start()
    counts0 = collections.Counter(devrt.COUNTS)
    launches0 = collections.Counter(devrt.LAUNCHES)
    t0 = s.t0 = sync()
    s.t_end = t0 + job["seconds"]
    name = torch.cuda.get_device_name(s.device) if cuda else "cpu"
    if job["trace"]:
        devrt.SPANS.clear()
        devrt.XFER.update(up=0, down=0)
    s.drive()
    rec = {"index": job["index"], "t0": t0, "device_name": name,
           "pictures": s.pictures,
           "frames_decoded": s.frames_sent,
           "latency_ms": [x * 1e3 for x in s.lat],
           "late_ms": [x * 1e3 for x in s.late], "clip_ms": s.clip_ms,
           "api_ms": s.api_ms}
    if job["trace"]:
        rec["spans"] = dict(devrt.SPANS)
        rec["xfer"] = dict(devrt.XFER)
        rec["counts"] = dict(collections.Counter(devrt.COUNTS) - counts0)
        rec["launches"] = dict(collections.Counter(devrt.LAUNCHES)
                               - launches0)
        devrt.SPANS = devrt.XFER = None
    if tracer is not None:
        t_stop = time.perf_counter()
        events = tracer.stop()
        import devtrace as dtrace

        lo = min((e[0] for e in events), default=t0)
        hi = max((e[1] for e in events), default=t0)
        rec["device_events"] = dtrace.clip(events, t0, s.t_end)
        # the kernels of every frame sent from the window's start on,
        # those the drain finishes too, as the spans count them
        rec["kernel_s"] = dtrace.by_name(
            (max(a, t0), b, dtrace.base_name(n)) for a, b, n in events
            if b > t0)
        # the shifted events must lie where the host saw the profiler
        # running: otherwise the clock is not shown to be shared
        rec["clock_ok"] = bool(events) and lo >= t0 - 5.0 and hi <= (
            t_stop + 1.0)
        rec["clock_err_s"] = tracer.err_ns * 1e-9
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(s.device)
                                if cuda else 0)
    if job["trace"] and cuda:
        rec["roofline"] = roofline_sample(s)
    if s.dec is not None:
        s.dec.close()
    rec["faults"] = s.judge.finish()
    rec["compared"] = s.judge.compared
    rec["attempted"] = s.judge.expected
    rec["forbidden"] = forbidden_modules()
    return rec


def roofline_sample(s: _Session) -> dict:
    """The least device time of each kernel's calls against the time the
    card took for them, over the next ``roofline_units`` units of the
    session's own traffic after the window (its decoder, its next
    requests): the bound of every call is worked out as the call is made
    (``roofline.py``, which needs device work and waits of its own and
    so would slow the window's spans and fill its idle time), and the
    profiler times the calls."""
    import roofline
    import devtrace as dtrace

    bound = collections.Counter()

    class Sink(list):
        def append(self, record):
            tag, _, args, _ = record
            name = roofline.kernel_of(tag, args)
            kernel = roofline.KERNEL_OF_CALL.get(name)
            if kernel is not None:
                bound[kernel] += roofline.bound_ms(name, args)

    devrt = s.devrt
    tracer = dtrace.DeviceTrace()
    devrt.SINK = Sink()
    tracer.start()
    try:
        n = s.drive(units=int(s.job["config"]["roofline_units"]))
    finally:
        devrt.SINK = None
        events = tracer.stop()
    took = collections.Counter()
    for a, b, name in events:
        k = dtrace.base_name(name)
        if k in roofline.KERNELS:
            took[k] += (b - a) * 1e3
    return {"bound_ms": dict(bound), "kernel_ms": dict(took), "units": n}


# -- processes -------------------------------------------------------------------


def _worker(job, results, start, t0):
    """A session in a process of its own; puts ("ready", i), then its
    record (or ("error", i, text)) on ``results``."""
    import traceback

    sys.path.insert(0, str(HERE))

    def sync():
        results.put(("ready", job["index"]))
        start.wait()
        while time.perf_counter() < t0.value:
            time.sleep(0.001)
        return t0.value

    try:
        results.put(("done", session(job, sync)))
    except BaseException:
        results.put(("error", job["index"], traceback.format_exc()))
        raise


def run_sessions(jobs: list, start_timeout: float = 1500.0) -> list:
    """Every session's record: one session in this process, several in
    processes of their own that start their windows together."""
    if len(jobs) == 1:
        return [session(jobs[0], time.perf_counter)]
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results, start = ctx.Queue(), ctx.Event()
    t0 = ctx.Value("d", 0.0)
    procs = [ctx.Process(target=_worker, args=(j, results, start, t0),
                         daemon=True) for j in jobs]
    for p in procs:
        p.start()
    import queue

    recs, ready, errors = [], 0, []
    deadline = time.perf_counter() + start_timeout
    try:
        while len(recs) + len(errors) < len(jobs):
            try:
                msg = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if not p.is_alive() and p.exitcode != 0]
                if dead or time.perf_counter() > deadline:
                    errors.append(f"sessions ended without a record "
                                  f"(exit codes {dead}) or timed out")
                    break
                continue
            if msg[0] == "ready":
                ready += 1
                if ready == len(jobs):
                    t0.value = time.perf_counter() + 0.05
                    start.set()
                    deadline = t0.value + jobs[0]["seconds"] + 300
            elif msg[0] == "done":
                recs.append(msg[1])
            else:
                errors.append(msg[2])
                start.set()
    finally:
        start.set()
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a session failed:\n" + "\n".join(errors))
    return sorted(recs, key=lambda r: r["index"])
