"""dav1d_tpu_torch — the AV1 decoder of dav1d_tpu, ported to PyTorch and
CUDA for NVIDIA Hopper (H100).

The JAX package ``dav1d_tpu`` stays the reference.  This package reuses
its host building blocks (OBU parsing, the native C entropy decode and
prediction replay, the LR / super-res / grain filters) and owns every
stage that the reference routes through its dispatch, so nothing here
consults ``dav1d_tpu.dispatch``.  The in-loop filter chain runs on torch
tensors on an explicit device, through hand-written CUDA kernels on a
CUDA device (``csrc/``) and their plain PyTorch versions on the CPU.

Layout (counterparts in ``dav1d_tpu`` keep their module names):

* ``decoder.Decoder`` — the public decoder (``send_data``/``get_picture``),
  a subclass of ``dav1d_tpu.decoder.Decoder`` taking ``device=``;
* ``decode.frame`` — pass 1 and the finish (pass 2 + filter chain);
* ``pipeline`` — the host-tier residual launch of pass 1 and pass 2;
* ``recon.device_chain`` — deblock -> CDEF on resident device planes,
  then host super-res and ``recon.lr_apply`` (loop restoration);
* ``recon.filmgrain`` — output-stage film grain (host);
* ``ops.lf`` / ``ops.cdef`` — deblock, CDEF direction, CDEF filter: each
  a plain PyTorch function plus its CUDA kernel wrapper;
* ``kernels.build`` — nvcc build of ``csrc/*.cu`` and the ctypes loader;
* ``devrt``, ``state`` — launch funnel, device-side constant tables.

This package never imports jax.
"""

__version__ = "0.1.0"
