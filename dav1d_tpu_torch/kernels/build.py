"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All ``csrc/*.cu`` files compile into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds): one nvcc per
source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <src>.o csrc/<src>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> *.o

The library is built at first use into ``dav1d_tpu_torch/_build/``
(listed in .gitignore), named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads at once; a file lock
there keeps processes that start together to one build.  ptxas's
register/spill report is kept beside it (``<lib>.log``).  Nothing here
runs at import: the CPU tests import every module of the package.

Each C entry point launches on the stream it is given (the wrapper
passes ``torch.cuda.current_stream()``) and returns ``cudaGetLastError()``;
``devrt.launch`` raises on a nonzero return.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from csrc/ on the machine with the GPU")
    return nvcc


def build() -> Path:
    """Compile csrc/*.cu into the hash-tagged library (once) and return
    its path.  Raises with the compiler's output if nvcc fails."""
    tag = _tag()
    out = BUILD_DIR / f"libdav1d_tpu_torch_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one build per tag at a time (worker processes start together,
    # dav1d_tpu_torch/gop.py): the first to hold the lock builds, the
    # others find its library
    with open(BUILD_DIR / f"kernels_{tag}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for src in sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp / f"{src.stem}.o"),
                   str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in jobs]
        for cmd, log, rc in logs:
            _check(cmd, log, rc)
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / "lib.so"),
                *(str(tmp / f"{src.stem}.o") for src in sources())]
        r = subprocess.run(link, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        _check(link, r.stdout, r.returncode)
        Path(str(out) + ".log").write_text("".join(log for _, log, _ in logs))
        os.replace(tmp / "lib.so", out)  # atomic: no partial file loads
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _check(cmd, log, rc):
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")


def build_log() -> str:
    p = Path(str(build()) + ".log")
    return p.read_text() if p.exists() else ""


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

_SIGNATURES = {
    # src, dst, cells, H, W, vertical, bitdepth, luma, stream
    "dtpu_deblock": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # plane, H, W, bitdepth, bin_weights, dir, var, stream
    "dtpu_cdef_dir": [_P, _I, _I, _I, _P, _P, _P, _P],
    # src, dst, H, W, ph, pw, top, bot, pm, sm, ncols, dmap, vmap, R8, W8,
    # uw, uh, damping, bitdepth, luma, layout_422, stream
    "dtpu_cdef_filter": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P,
                         _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # table, jobs, tiles, n_tiles, out, bitdepth, stream
    "dtpu_mc_put_8tap": [_P, _P, _P, _I, _P, _I, _P],
    # cf, jobs, groups, n_groups, out, bitdepth, stream
    "dtpu_itx_frame": [_P, _P, _P, _I, _P, _I, _P],
    # out[6]: registers, static shared bytes, CTAs per SM (8/10, 12-bit)
    "dtpu_itx_occupancy": [_P],
    # srcs[n], outs[n], geo[8 n], n, bitdepth, stream
    "dtpu_resize": [_P, _P, _P, _I, _I, _P],
    # out[3]: registers, shared bytes (static and dynamic), CTAs per SM
    "dtpu_resize_attrs": [_P],
    # post, pre, out, H, W, chunks, n_chunks, bitdepth, stream
    "dtpu_lr_sgr": [_P, _P, _P, _I, _I, _P, _I, _I, _P],
    # post, pre, out, H, W, chunks, n_chunks, bitdepth, stream
    "dtpu_lr_wiener": [_P, _P, _P, _I, _I, _P, _I, _I, _P],
    # out[4]: registers, static shared bytes (wiener, sgr)
    "dtpu_lr_attrs": [_P],
    # src, src_stride, luma, luma_stride, lw, out, w, h, lut, scaling,
    # offs, n_blocks, prm (host ints), stream
    "dtpu_fg": [_P, _L, _P, _L, _I, _P, _I, _I, _P, _P, _P, _I, _P, _P],
    # out[4]: registers, static shared bytes (luma, chroma)
    "dtpu_fg_attrs": [_P],
    # stream
    "dtpu_empty": [_P],
    # canvas, resid, H, W, ph, jobs, n_jobs, bitdepth, stream
    "dtpu_ipred": [_P, _P, _I, _I, _I, _P, _I, _I, _P],
    # canvas, luma, resid, H, W, ph, YH, YW, jobs, n_jobs, ss_hor, ss_ver,
    # bitdepth, stream
    "dtpu_ipred_cfl": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I,
                       _P],
    # canvas, resid, H, W, jobs, n_jobs, pidx, bitdepth, stream
    "dtpu_ipred_pal": [_P, _P, _I, _I, _P, _I, _P, _I, _P],
    # canvas, luma, resid, H, W, ph, YH, YW, jobs, tags, counts, sync,
    # n_jobs, n_levels, max_ctas, pidx, ss_hor, ss_ver, bitdepth, stream
    "dtpu_ipred_walk": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                        _I, _I, _P, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    so = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    so.dtpu_error_string.argtypes = [_I]
    so.dtpu_error_string.restype = ctypes.c_char_p
    return so


def error_string(rc: int) -> str:
    return lib().dtpu_error_string(int(rc)).decode()


def on_cuda(*tensors: torch.Tensor) -> bool:
    """Where a wrapper runs: True when every tensor lies on one CUDA
    device (launch the kernel), False when every tensor lies on the CPU
    (run the plain version).  Anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError("tensors on several devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def check(t: torch.Tensor, name: str, shape=None,
          dtype=torch.int32) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (and
    ``shape``, when given) — what the kernels take."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def empty_launch(t: torch.Tensor) -> None:
    """Launch the empty kernel (csrc/runtime.cu) on the current stream of
    ``t``'s device, counted under ``empty``: the device time of a launch
    that does nothing, the floor under every kernel's (chip_smoke.py
    times it)."""
    from .. import devrt

    with torch.cuda.device(t.device):
        devrt.launch("empty", lib().dtpu_empty, stream(t))


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
