"""Pallas GPU kernels (Triton route): the production light-transport path."""

from .device import set_interpret, use_interpreter
from .trace import pallas_trace

__all__ = ["pallas_trace", "set_interpret", "use_interpreter"]
