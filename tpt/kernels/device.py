"""Where the Pallas kernels run: compiled for the GPU, or interpreted.

One decision for every kernel entry point and for the callers that pick
kernel settings (the CLI's and the viewer's static primitive counts):

* on JAX platform ``gpu`` the kernels compile through Pallas's Triton route;
* the Pallas interpreter runs them only when asked for explicitly — by
  ``interpret=True`` at the call, or process-wide by
  :func:`set_interpret` (the test suite does this on the CPU);
* on any other platform the entry points raise: there is no silent
  fallback to the interpreter, whose speed nobody deploys.
"""

from __future__ import annotations

import jax

_interpret = False


def set_interpret(on: bool) -> None:
    """Run every kernel in the Pallas interpreter from now on (``True``),
    or compile them for the GPU again (``False``)."""
    global _interpret
    _interpret = bool(on)


def interpret_requested() -> bool:
    """Whether :func:`set_interpret` asked for the interpreter."""
    return _interpret


def use_interpreter(interpret: bool | None = None) -> bool:
    """Resolve a kernel call's ``interpret`` argument.

    ``True`` (or a process-wide :func:`set_interpret`) -> interpreter;
    otherwise compile, which needs the GPU platform."""
    if interpret or (interpret is None and _interpret):
        return True
    platform = jax.default_backend()
    if platform != "gpu":
        raise RuntimeError(
            f"tpt's Pallas kernels compile for the GPU only, and JAX's "
            f"platform here is {platform!r}.  Render with the XLA oracle "
            f"instead (--backend oracle, backend='oracle'), or run the "
            f"kernels in the Pallas interpreter (interpret=True, "
            f"tpt.kernels.device.set_interpret(True)).")
    return False
