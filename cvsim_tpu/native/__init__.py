"""ctypes binding for the native host runtime (libhostio), and the build
rule every native part of the repo shares (ensure_built).

Builds the shared library on first use with g++ (no pip deps). Falls back to
a NumPy implementation when no compiler is available (slower, same results).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
import threading

# numpy imports lazily inside the classes that need it: build_av_tool()
# serves the numpy-free restore-tool fast path (cli/toolargs.py), where
# the numpy import alone costs ~0.3 s of a one-shot process

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "hostio.cpp")
_LIB = os.path.join(_DIR, "libhostio.so")
_lock = threading.Lock()
_lib = None

_AV_SRC = os.path.join(_DIR, "avio.cpp")
_AV_PIX_SRC = os.path.join(_DIR, "hostpix.cpp")  # restore-tool kernels,
# compiled into cvsim-av so the in-process tool loops share the exact
# pixel implementation the Python fallback dlopens (libhostpix.so)
_AV_BIN = os.path.join(_DIR, "cvsim-av")
_AV_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale",
            "-lswresample"]
_av_lock = threading.Lock()
_av_state: list = []  # [path | None] once resolved


@functools.lru_cache(maxsize=1)
def _native_target() -> str:
    """What -march=native turns on for this host's g++ (every -m target
    option and its value). A build tuned for one CPU must not be reused on
    another, so this is part of the build key."""
    try:
        return subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""


def build_key(sources, flags, libs=(), native=False) -> str:
    """Hash of everything a build depends on: the source bytes, the
    compiler flags and libraries, and (for -march=native builds) the host
    target."""
    h = hashlib.sha256()
    for part in (*flags, "|", *libs, "|", str(native),
                 _native_target() if native else ""):
        h.update(part.encode() + b"\0")
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def ensure_built(out, sources, flags, libs=(), native=False) -> str:
    """Build `out` from `sources` with g++ unless it was already built from
    these very sources, flags and host target (the key sits beside it in
    `out + ".key"`; file times play no part). native=True tries
    -march=native first and falls back to baseline code generation.
    Builds to a private temp name and renames, so concurrent processes
    never load a half-written file. Raises CalledProcessError / OSError
    when the build fails."""
    key = build_key(sources, flags, libs, native)
    key_path = out + ".key"
    try:
        with open(key_path) as f:
            if f.read() == key and os.path.exists(out):
                return out
    except OSError:
        pass
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = ["g++", *flags, "-o", tmp, *sources, *libs]
    try:
        if native:
            try:
                subprocess.run(cmd[:1] + ["-march=native"] + cmd[1:],
                               check=True, capture_output=True)
            except subprocess.CalledProcessError:
                subprocess.run(cmd, check=True, capture_output=True)
        else:
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(f"{key_path}.tmp.{os.getpid()}", "w") as f:
        f.write(key)
    os.replace(f"{key_path}.tmp.{os.getpid()}", key_path)
    return out


def build_av_tool() -> str | None:
    """Path to the cvsim-av container-I/O binary (native/avio.cpp), built
    on first use against the system FFmpeg libraries.  None when g++ or
    the libav* dev libraries are unavailable (the framework then falls
    back to an `ffmpeg` binary on PATH, or native Y4M/WAV only)."""
    with _av_lock:
        if _av_state:
            return _av_state[0]
        path = None
        try:
            # hostpix.cpp's flags are load-bearing (-ffp-contract=off: FMA
            # would change the f32 results vs numpy; see hostpix.py _load);
            # -march=native vectorizes rintf
            path = ensure_built(
                _AV_BIN, [_AV_SRC, _AV_PIX_SRC],
                ["-O3", "-ffp-contract=off", "-fno-math-errno"],
                libs=_AV_LIBS, native=True)
        except subprocess.CalledProcessError as e:
            print("cvsim: cvsim-av build failed (container I/O limited to "
                  "Y4M/WAV + ffmpeg-on-PATH):\n"
                  + e.stderr.decode(errors="replace")[-800:],
                  file=sys.stderr)
            path = None
        except OSError:
            path = None
        _av_state.append(path)
        return path


class _HsyncDcStateStruct(ctypes.Structure):
    _fields_ = [
        ("filt_prev", ctypes.c_double * 3),
        ("alpha", ctypes.c_double),
        ("dc_level", ctypes.c_double),
        ("a_fast", ctypes.c_double),
        ("a_slow", ctypes.c_double),
        ("delay_len", ctypes.c_int),
        ("delay_pos", ctypes.c_int),
        ("delay", ctypes.c_uint8 * 4096),
    ]


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(ensure_built(_LIB, [_SRC],
                                       ["-O2", "-shared", "-fPIC"]))
        lib.hsync_dc_init.argtypes = [
            ctypes.POINTER(_HsyncDcStateStruct), ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_double, ctypes.c_long]
        lib.hsync_dc_process.argtypes = [
            ctypes.POINTER(_HsyncDcStateStruct), ctypes.c_void_p,
            ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return lib


class HsyncDcTracker:
    """Streaming hsync DC normalizer (ffmpeg_raw28ntsc.cpp:556-598)."""

    def __init__(self, sample_rate: float, one_scanline_time: float,
                 one_frame_time: float):
        cutoff = sample_rate / (one_scanline_time * 0.075 * 0.75)
        self._native = None
        self._params = (sample_rate, cutoff,
                        1.0 / (one_scanline_time * 0.07 * 0.75),
                        1.0 / (one_frame_time * 0.6),
                        int((one_scanline_time * 0.075 * 0.75) * 0.5),
                        128.0, int(one_frame_time))
        try:
            lib = _load()
            st = _HsyncDcStateStruct()
            lib.hsync_dc_init(ctypes.byref(st), *[
                ctypes.c_double(self._params[0]),
                ctypes.c_double(self._params[1]),
                ctypes.c_double(self._params[2]),
                ctypes.c_double(self._params[3]),
                ctypes.c_int(self._params[4]),
                ctypes.c_double(self._params[5]),
                ctypes.c_long(self._params[6]),
            ])
            self._native = (lib, st)
        except Exception:
            self._init_python()

    # ---------------------------------------------------------------- python
    def _init_python(self):
        import math

        import numpy as np
        rate, cutoff, a_fast, a_slow, dlen, pre, pre_n = self._params
        dt = 1.0 / rate
        tau = 1.0 / (cutoff * 2 * math.pi)
        self._alpha = dt / (tau + dt)
        self._prev = [0.0, 0.0, 0.0]
        for _ in range(pre_n):
            lv = pre
            for i in range(3):
                self._prev[i] = lv * self._alpha + (
                    self._prev[i] - self._prev[i] * self._alpha)
                lv = self._prev[i]
        self._dc = 128.0
        self._af, self._as = a_fast, a_slow
        self._delay = np.zeros(dlen, np.uint8)
        self._dpos = 0

    def process(self, raw):
        """raw: uint8 [N]. Returns (delayed_raw uint8 [N], dc uint8 [N])."""
        import numpy as np

        raw = np.ascontiguousarray(raw, np.uint8)
        n = len(raw)
        out_raw = np.empty(n, np.uint8)
        out_dc = np.empty(n, np.uint8)
        if self._native is not None:
            lib, st = self._native
            lib.hsync_dc_process(
                ctypes.byref(st), raw.ctypes.data, ctypes.c_long(n),
                out_raw.ctypes.data, out_dc.ctypes.data)
            return out_raw, out_dc
        # slow path
        a = self._alpha
        dlen = len(self._delay)
        for k in range(n):
            lv = float(raw[k])
            for i in range(3):
                self._prev[i] = lv * a + (self._prev[i] - self._prev[i] * a)
                lv = self._prev[i]
            r = self._af if self._dc > lv else self._as
            self._dc = self._dc * (1 - r) + lv * r
            if dlen:
                out_raw[k] = self._delay[self._dpos]
                self._delay[self._dpos] = raw[k]
                self._dpos = (self._dpos + 1) % dlen
            else:
                out_raw[k] = raw[k]
            out_dc[k] = min(255, max(0, int(lv - self._dc)))
        return out_raw, out_dc
