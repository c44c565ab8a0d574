"""InputFile-style flag parsing + the restore tools' native fast path.

numpy-free ON PURPOSE: `cvsim vhsled|frameblend|filmac` normally runs its
whole decode -> kernel -> encode loop inside the cvsim-av binary (ONE
address space — the reference binaries' cost class, ffmpeg_vhsled.cpp:
838-977, frameblend.cpp:929-1081), and on this class of one-shot process
the numpy import alone costs ~0.3 s against a ~3 s tool run. cli/main.py
dispatches the restore tools here FIRST; anything the fast path does not
handle (parse errors, -h, stdout output, no cvsim-av, exotic -or
fractions, CVSIM_NO_NATIVE_TOOL=1) falls back to the full numpy loop in
cli/tools.py, which imports the same parser from here so the two paths
cannot drift.
"""

from __future__ import annotations

import os
import sys
from fractions import Fraction


class ToolArgs:
    """Minimal left-to-right parser for the shared InputFile-style flags."""

    def __init__(self, argv, extra=None):
        self.inputs = []
        self.output = ""
        self.width = 720
        self.height = 480
        # the restore tools default output dims to the INPUT's dims
        # (ffmpeg_vhsled.cpp:706-714), unlike the preset_NTSC 720x480 of
        # the InputFile tools (ffmpeg_posterize.cpp:51) — they check these
        self.width_set = False
        self.height_set = False
        self.field_rate = Fraction(60000, 1001)
        self.use_422 = False
        self.delay = 1
        self.per_input = []     # list of dicts, one per -i (InputFile style)
        self.extra = {}
        cur = {}
        i = 0
        extra = extra or {}
        while i < len(argv):
            a = argv[i]; i += 1
            if not a.startswith("-"):
                raise ValueError(f"Unhandled arg '{a}'")
            a = a.lstrip("-")
            if a in ("h", "help"):
                # every reference tool prints its flag list and exits
                # nonzero on -h (e.g. ffmpeg_posterize.cpp help());
                # main() prints this ValueError and returns 1
                base = "-i <in> -o <out> -width <n> -d <n> -422 -420 " \
                       "-tvstd <ntsc|pal|720p60|1080p60>"
                more = " ".join(f"-{k}" for k in sorted(extra))
                raise ValueError(f"flags: {base} {more}".rstrip())
            if a == "i":
                cur = dict(cur)  # reference copies prior input's settings
                cur["path"] = argv[i]; i += 1
                self.inputs.append(argv[i - 1])
                self.per_input.append(cur)
            elif a == "o":
                self.output = argv[i]; i += 1
            elif a == "width":
                self.width = int(argv[i]); i += 1
                self.width_set = True
            elif a == "d":
                self.delay = int(argv[i]); i += 1
                if self.delay < 1 or self.delay > 256:
                    raise ValueError("Invalid delay")
            elif a == "422":
                self.use_422 = True
            elif a == "420":
                self.use_422 = False
            elif a == "tvstd":
                v = argv[i]; i += 1
                if v == "pal":
                    self.height, self.field_rate = 576, Fraction(50, 1)
                elif v == "ntsc":
                    self.height, self.field_rate = 480, Fraction(60000, 1001)
                elif v == "720p60":   # preset_720p60, ffmpeg_scanimate.cpp:619
                    self.width, self.height = 1280, 720
                    self.field_rate = Fraction(60000, 1001)
                    self.width_set = True
                elif v == "1080p60":  # preset_1080p60, :628
                    self.width, self.height = 1920, 1080
                    self.field_rate = Fraction(60000, 1001)
                    self.width_set = True
                else:
                    raise ValueError(f"Unknown tv std '{v}'")
                self.height_set = True
            elif a in extra:
                kind, key = extra[a]
                if kind == "flag":
                    cur[key] = True
                    self.extra[key] = True
                else:
                    v = argv[i]; i += 1
                    val = kind(v)
                    cur[key] = val
                    self.extra[key] = val
            else:
                raise ValueError(f"Unknown switch '{a}'")
            if self.per_input:
                self.per_input[-1] = cur


def parse_gamma(v: str) -> float:
    if v in ("vga", "ntsc"):
        return 2.2
    return float(v)


def parse_rate(v: str) -> Fraction:
    """The InputFile tools' -or parser (ffmpeg_vhsled.cpp:516-544):
    "n", "n:d", "n/d" (or backslash); rates below 5 fps clamp to 5."""
    for sep in (":", "/", "\\"):
        if sep in v:
            n, d = v.split(sep, 1)
            r = Fraction(float(n)) / max(1, int(d))
            break
    else:
        r = Fraction(v)
    if r < 5:
        r = Fraction(5)
    return r


# Per-tool x264 profiles matching the reference binaries: the restore
# tools encode superfast/crf16 (ffmpeg_vhsled.cpp:752-754,
# filmac.cpp:740-742 — ~5x faster than the default preset and the
# dominant cost of their frame loop), frameblend 25 Mbps ABR
# (frameblend.cpp:794).
ENC_RESTORE = {"crf": 16, "crf_max": 16, "preset": "superfast"}
ENC_FRAMEBLEND = {"bit_rate": 25_000_000}

# The restore tools' flag tables (shared with cli/tools.run_* so the fast
# and full parses cannot diverge).
RESTORE_EXTRA = {
    "frameblend": {
        "or": (parse_rate, "out_rate"),
        "sqnr": ("flag", "sqnr"),
        "ffa": ("flag", "ffa"),
        "fa": (int, "fa"),
        "gamma": (parse_gamma, "gamma"),
        "height": (int, "height_flag"),
        "underscan": (int, "underscan"),
    },
    "filmac": {
        "gamma": (parse_gamma, "gamma"),
        "height": (int, "height_flag"),
        "underscan": (int, "underscan"),
        "or": (parse_rate, "out_rate"),
    },
    "vhsled": {
        "height": (int, "height_flag"),
        "or": (parse_rate, "out_rate"),
        "underscan": (int, "underscan"),
        "gamma": (parse_gamma, "gamma"),
    },
}


def try_native_restore(tool: str, args: ToolArgs, enc: dict,
                       extra_flags: list) -> int | None:
    """Run the restore tool's whole decode -> kernel -> encode loop inside
    cvsim-av, ONE address space — the reference binaries' cost class
    (ffmpeg_vhsled.cpp:838-977, frameblend.cpp:929-1081), where a Y4M
    pipe bridge to Python loses to them. The native
    loops call the same hostpix.cpp kernels this module's fallback loops
    use through ctypes, so the two paths are byte-identical
    (tests/test_restore_native.py pins y4m-in/y4m-out equality).

    Returns the tool's exit code, or None when the native path doesn't
    apply (no cvsim-av, stdout target, CVSIM_NO_NATIVE_TOOL=1) and the
    caller should run the Python loop."""
    import subprocess

    if os.environ.get("CVSIM_NO_NATIVE_TOOL"):
        return None
    if not args.inputs or not args.output or args.output == "-":
        return None
    from cvsim_tpu import native

    tool_bin = native.build_av_tool()
    if tool_bin is None:
        return None
    cmd = [tool_bin, tool, "-i", args.inputs[0], "-o", args.output]
    if args.width_set:
        cmd += ["-width", str(args.width)]
    if args.height_set or "height_flag" in args.extra:
        cmd += ["-height", str(args.height)]
    if args.use_422:
        cmd += ["-pix", "422"]
    us = args.extra.get("underscan", 0)
    if us:
        cmd += ["-underscan", str(us)]
    cmd += [str(f) for f in extra_flags]
    if "bit_rate" in enc:
        cmd += ["-vb", str(enc["bit_rate"])]
    else:
        cmd += ["-crf", str(enc.get("crf", 18))]
        if "crf_max" in enc:
            cmd += ["-crf-max", str(enc["crf_max"])]
    if "preset" in enc:
        cmd += ["-preset", enc["preset"]]
    return subprocess.run(cmd).returncode


def fast_restore(tool: str, argv) -> int | None:
    """Parse a restore tool's argv and run it natively when possible.
    None -> the caller must run the full cli/tools.py path (which
    reproduces parse errors/-h byte-for-byte — same parser, same table)."""
    try:
        args = ToolArgs(argv, extra=RESTORE_EXTRA[tool])
    except (ValueError, IndexError):
        return None
    if "height_flag" in args.extra:
        args.height = args.extra["height_flag"]
    if tool == "vhsled":
        return try_native_restore("vhsled", args, ENC_RESTORE, [])
    if tool == "filmac":
        gamma = args.extra.get("gamma", -1.0)
        return try_native_restore(
            "filmac", args, ENC_RESTORE,
            ["-gamma", repr(float(gamma))] if gamma > 1 else [])
    # frameblend
    out_rate = args.extra.get("out_rate", args.field_rate)
    # the frame_t products must stay < 2^53 for the native loop's double
    # division to be the identical correctly-rounded value (exotic -or
    # fractions from Fraction(float) fall back to the Python loop)
    if not (out_rate.numerator <= 10**6 and out_rate.denominator <= 10**6):
        return None
    framealt = max(1, min(8, args.extra.get("fa", 1)))
    gamma = args.extra.get("gamma", -1.0)
    fb_flags = ["-or-num", out_rate.numerator,
                "-or-den", out_rate.denominator, "-fa", framealt]
    if args.extra.get("ffa", False):
        fb_flags += ["-ffa"]
    if args.extra.get("sqnr", False):
        fb_flags += ["-sqnr"]
    if gamma > 1:
        fb_flags += ["-gamma", repr(float(gamma))]
    return try_native_restore("frameblend", args, ENC_FRAMEBLEND, fb_flags)
