"""Film grain synthesis, host tier (counterpart of
dav1d_tpu/recon/filmgrain.apply_grain without its device branch).

The reference's ``apply_grain`` consults its dispatch, which imports
jax and runs the grain as a jax program on an accelerator.  The port's
grain is not ported to the device yet: it runs the reference's native
whole-frame pass (native/fg.c, reference dav1d_apply_grain,
src/fg_apply_tmpl.c:225-241).
"""

from __future__ import annotations

from dav1d_tpu.recon.filmgrain import _apply_grain_native


def apply_grain(pic) -> None:
    """Apply film grain to an output Picture in place (its planes must
    be writable copies).  Needs the native library, as the port's
    two-pass decode does."""
    if not _apply_grain_native(pic):
        raise RuntimeError("film grain needs the native library "
                           "(dav1d_tpu.native)")
