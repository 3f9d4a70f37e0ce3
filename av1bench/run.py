"""The benchmark of dav1d_tpu_torch, the PyTorch and CUDA AV1 decoder.

    python3 av1bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control]

Runs one cell of ``BENCHMARK.json`` on ``cuda:0`` from the root of a
checkout and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (and with ``--trace 1`` a ``breakdown``) and
``checks``, each number compared beside its limit.  Exits non-zero and
prints no result when CUDA is not available or has fewer devices than
the cell asks for, when a module of JAX or of the JAX package
``dav1d_tpu`` was loaded by any process of the run, or when the program
under test is missing.  ``--control`` runs the configuration's control
(``config["control"]``: a path of the program that breaks a guarantee
the configuration states), which has to come out not correct.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import harness  # noqa: E402

# a library that loads JAX by itself is kept from it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def _cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernel library and native C build into
    ``dav1d_tpu_torch/_build/``, a fixed path of the checkout)."""
    cache = root / "av1bench" / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def _pct(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) \
        if len(values) else None


# the samples a tail is taken over: a picture's latency from its unit's
# send_data to the get_picture that returns it; a request's from the
# call that opens its decoder to its last picture; a paced picture's
# lateness against the time it was due (generator.py)
SAMPLES = {"frame_ms": "latency_ms", "clip_ms": "clip_ms",
           "late_ms": "late_ms"}
UNITS = {"fps": "frames/s", "setup_s": "s"}
TAIL = re.compile(r"^(%s)_p([1-9][0-9]?)$" % "|".join(SAMPLES))


def end_to_end(recs, seconds,
               names=("fps", "frame_ms_p95", "clip_ms_p90", "setup_s")):
    """The end-to-end metrics ``names`` over the whole window, every
    session pooled: ``fps``, the pictures delivered over the window;
    ``setup_s``; and ``<sample>_p<q>``, the ``q``-th percentile of every
    sample of :data:`SAMPLES` that the window holds.  (value or None,
    unit) by name."""
    out = {}
    for name in names:
        if name == "fps":
            out[name] = (sum(r["pictures"] for r in recs) / seconds,
                         UNITS[name])
        elif name == "setup_s":
            out[name] = (min(r["t0"] for r in recs) - T_START, UNITS[name])
        elif (m := TAIL.match(name)):
            key = SAMPLES[m.group(1)]
            out[name] = (_pct([x for r in recs for x in r.get(key, [])],
                              int(m.group(2))), "ms")
        else:
            raise ValueError(f"no end-to-end metric {name!r}: the harness "
                             f"takes fps, setup_s and <{'|'.join(SAMPLES)}>"
                             "_p<q>")
    return out


def layer_record(recs, seconds) -> dict:
    """What the per-layer readers read: every session's spans, counts,
    transfers and device intervals merged, and the roofline's samples
    after the window summed over the sessions."""
    import devtrace
    import roofline

    def add(key):
        out = {}
        for r in recs:
            for k, v in r.get(key, {}).items():
                out[k] = out.get(k, 0) + v
        return out

    events = [e for r in recs for e in r.get("device_events", [])]
    clock_ok = all(r.get("clock_ok") for r in recs)
    union = devtrace.union_s(events)
    if not clock_ok:
        # without one clock the sessions' intervals cannot be merged: the
        # busiest session's own union is a lower bound
        union = max(devtrace.union_s(r.get("device_events", []))
                    for r in recs)
    kernels = {}
    for r in recs:
        for k, v in r.get("kernel_s", {}).items():
            if k in roofline.KERNELS:
                kernels[k] = kernels.get(k, 0.0) + v
    samples = [r["roofline"] for r in recs if "roofline" in r]
    sample = None
    if samples:
        sample = {"units": sum(x["units"] for x in samples),
                  "sessions": len(samples)}
        for key in ("bound_ms", "kernel_ms"):
            sample[key] = {}
            for x in samples:
                for k, v in x[key].items():
                    sample[key][k] = sample[key].get(k, 0.0) + v
    return {
        "window_s": seconds, "sessions": len(recs),
        "pictures": sum(r["pictures"] for r in recs),
        "frames_decoded": sum(r["frames_decoded"] for r in recs),
        "spans": add("spans"), "counts": add("counts"),
        "launches": add("launches"), "xfer": add("xfer"),
        "api_ms": [x for r in recs for x in r["api_ms"]],
        "latency_ms": [x for r in recs for x in r["latency_ms"]],
        "late_ms": [x for r in recs for x in r["late_ms"]],
        "clip_ms": [x for r in recs for x in r["clip_ms"]],
        "device": {"busy_s": union, "summed_s": devtrace.summed_s(events),
                   "clock_ok": clock_ok, "kernel_s": kernels,
                   "events": len(events)},
        "roofline": sample,
        "_events": events,
    }


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None, device=None, decoder=None, root=None) -> int:
    """Run a cell.  ``device``: None looks for the cell's cards and runs
    on ``cuda:0``; a test passes ``"cpu"`` (the program's plain
    versions).  ``decoder``: the decoder class as ``module:attr``."""
    args = _args(argv)
    root = Path(root or HERE.parent)
    _cache_dirs(root)
    spec = harness.load_cell(root, args.workload)
    chips = spec["cell"]["chips"]
    if device is None:
        import torch

        if not torch.cuda.is_available():
            print("CUDA is not available: no result", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < chips:
            print(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                  f"for {chips}: no result", file=sys.stderr)
            return 3
        device = "cuda:0"
    mix = spec["mix"]
    jobs = [{"root": root, "config": spec["config"], "mix": mix,
             "seed": args.seed, "index": i, "seconds": args.seconds,
             "trace": bool(args.trace), "device": device,
             "control": args.control,
             "decoder": decoder or f"{harness.PROGRAM}.decoder:Decoder"}
            for i in range(mix.processes)]
    recs = harness.run_sessions(jobs)
    found = sorted(set(harness.forbidden_modules()).union(
        *(r["forbidden"] for r in recs)))
    if found:
        print(f"forbidden modules loaded: {found}: no result",
              file=sys.stderr)
        return 4

    faults = {k: sum(r["faults"][k] for r in recs)
              for k in recs[0]["faults"]}
    import check

    ok = check.correct(faults)
    checks = check.verdict(faults)
    checks["pictures_compared"] = {
        "value": sum(r["compared"] for r in recs), "limit": "at least 1"}
    ok = ok and checks["pictures_compared"]["value"] > 0
    metrics, extra = {}, {}
    if not args.trace:
        e2e = end_to_end(recs, args.seconds,
                         [m["name"] for m in spec["end_to_end"]])
        for m in spec["end_to_end"]:
            value, unit = e2e[m["name"]]
            if value is None:
                raise RuntimeError(f"{m['name']}: no sample in the window")
            metrics[m["name"]] = {"value": value, "unit": unit}
    else:
        rec = layer_record(recs, args.seconds)
        for m in spec["per_layer"]:
            value = harness.reader(root, m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = _traced_report(rec, recs, args.seconds)
    peak = sum(r["memory_peak_bytes"] for r in recs)
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": recs[0]["device_name"], "count": chips,
           "memory_peak_bytes": peak}
    if args.trace:
        dev["busy_s"] = extra["busy_s"]
        dev["window_s"] = args.seconds
    out = {"correct": bool(ok),
           "attempted": sum(r["attempted"] for r in recs),
           "failed": sum(faults.values()), "metrics": metrics,
           "device": dev}
    if args.trace:
        out["breakdown"] = extra["breakdown"]
    out["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


def _traced_report(rec, recs, seconds) -> dict:
    """Print what a traced run shows beside its metrics; the busy
    seconds and the breakdown of the result line."""
    import devtrace

    events = rec.pop("_events")
    frames = max(rec["frames_decoded"], 1)
    print(f"traced fps {rec['pictures'] / seconds} frames/s "
          f"({rec['pictures']} pictures, {rec['frames_decoded']} frames "
          f"decoded, {rec['sessions']} sessions)")
    print("spans ms/frame " + json.dumps(
        {k: v * 1e3 / frames for k, v in sorted(rec["spans"].items())}))
    print("launches " + json.dumps(dict(sorted(rec["launches"].items()))))
    print("counts " + json.dumps(dict(sorted(rec["counts"].items()))))
    print("xfer bytes " + json.dumps(rec["xfer"]))
    print(f"device busy {rec['device']['busy_s']} s (summed "
          f"{rec['device']['summed_s']} s) of {seconds} s, "
          f"{rec['device']['events']} events, one clock "
          f"{rec['device']['clock_ok']}")
    print("roofline sample " + json.dumps(rec["roofline"]))
    print(f"usable cores {len(os.sched_getaffinity(0))}; peak device "
          f"memory {[r['memory_peak_bytes'] for r in recs]} B; card "
          f"{_card()}", flush=True)
    ops = sorted(((devtrace.base_name(n), s)
                  for n, s in devtrace.by_name(events).items()),
                 key=lambda t: -t[1])
    merged = {}
    for n, s in ops:
        merged[n] = merged.get(n, 0.0) + s
    top = sorted(merged.items(), key=lambda t: -t[1])[:10]
    t0 = min(r["t0"] for r in recs)
    gaps = devtrace.idle_gaps(events, t0, t0 + seconds) \
        if rec["device"]["clock_ok"] else []
    return {"busy_s": rec["device"]["busy_s"],
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": gaps}}


if __name__ == "__main__":
    sys.exit(main())
