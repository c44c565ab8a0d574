"""DSP primitives (reference L5). Submodules and the re-exported helpers
import lazily (PEP 562): the device ops pull in jax, and the host-numpy
paths (noise_np, the sibling-tool CLI) must be importable without paying
the jax import (see cli/tools.py)."""

import importlib

_SUBMODULES = ("cmath", "iir", "blocked_iir", "phase", "noise", "noise_np",
               "roll")
_REEXPORTS = {
    "c_div": "cmath", "c_int": "cmath", "clampu8": "cmath",
    "clips16": "cmath", "dbfs": "cmath",
    "iir_lowpass": "iir", "iir_lowpass_cascade": "iir",
    "iir_highpass": "iir", "delay_writeback": "iir",
    "scanline_phase_xi": "phase",
    "random_walk": "noise", "smoothed_noise_walk": "noise",
}

__all__ = list(_SUBMODULES) + list(_REEXPORTS)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"cvsim_tpu.ops.{name}")
    if name in _REEXPORTS:
        mod = importlib.import_module(f"cvsim_tpu.ops.{_REEXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module 'cvsim_tpu.ops' has no attribute {name!r}")
