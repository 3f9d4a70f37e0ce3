"""dav1d_tpu_torch — the AV1 decoder of dav1d_tpu, ported to PyTorch and
CUDA for NVIDIA Hopper (H100).

The JAX package ``dav1d_tpu`` stays the reference.  This package stands
alone: it imports nothing of ``dav1d_tpu`` and never imports jax.  It
carries its own copies of the reference's host building blocks (OBU
parsing, the native C entropy decode and prediction replay in
``native/``, built with ``cc`` into ``_build/``, the golden ``recon/``
models), each stage in its host form only.  Device work runs on torch
tensors on an explicit device, through hand-written CUDA kernels on a
CUDA device (``csrc/``) and their plain PyTorch versions on the CPU.

Layout (counterparts in ``dav1d_tpu`` keep their module names):

* ``decoder.Decoder`` — the public decoder (``send_data``/``get_picture``)
  taking ``device=``;
* ``decode.frame`` — pass 1 and the finish (pass 2 + filter chain);
* ``pipeline`` — the residual launch of pass 1 (every inverse transform
  of a frame on the device, ``ops.itx``) and pass 2, with batched
  translational MC on the device (``ops.mc``) from the reference planes
  that stay resident on it;
* ``recon.device_chain`` — deblock -> CDEF on resident device planes,
  then host super-res and ``recon.lr_apply`` (loop restoration);
* ``recon.filmgrain`` — output-stage film grain (host);
* ``ops.lf`` / ``ops.cdef`` / ``ops.mc`` / ``ops.itx`` — deblock, CDEF
  direction, CDEF filter, MC, inverse transforms: each a plain PyTorch
  function plus its CUDA kernel wrapper;
* ``kernels.build`` — nvcc build of ``csrc/*.cu`` and the ctypes loader;
* ``devrt``, ``state`` — launch funnel, device-side constant tables.
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Keep large numpy temporaries on the heap instead of mmap.

    The batched host kernels churn through multi-MB temporaries every
    frame; glibc malloc serves those via mmap/munmap by default, so every
    allocation page-faults from scratch (measured ~10x slowdown on the
    full-frame CDEF batch). Raising the mmap/trim thresholds makes the
    heap retain and reuse those buffers. Best-effort: silently skipped on
    non-glibc platforms.
    """
    import ctypes
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except (OSError, AttributeError):
        pass


_tune_malloc()
