"""CLI runners for the sibling tools.

Each mirrors its reference tool's flags (cited per function) over the shared
Y4M-in/Y4M-out scaffold: frames -> RGB -> device op (vs a delay-ring canvas
where the tool is stateful) -> RGB -> Y4M at field rate.
"""

from __future__ import annotations

import contextlib
import os
import sys
from fractions import Fraction

import numpy as np

from cvsim_tpu.host import timing, wavio, y4m
from cvsim_tpu.models import tools_np
from cvsim_tpu.native import hostpix
from cvsim_tpu.ops import noise_np

# frame scaling and the restore-tool pixel kernels dispatch to the native
# library (bit-exact numpy fallback inside hostpix)
_scale_frame_to = hostpix.scale_frame_to

# the flag parser, -or/-gamma parsers, encoder profiles and the native
# in-process delegation live in cli/toolargs.py (numpy-free: cli/main.py
# dispatches the restore tools there BEFORE this module's numpy-heavy
# imports load — see toolargs.fast_restore)
from cvsim_tpu.cli.toolargs import (          # noqa: E402
    ENC_FRAMEBLEND as _ENC_FRAMEBLEND,
    ENC_RESTORE as _ENC_RESTORE,
    RESTORE_EXTRA as _RESTORE_EXTRA,
    ToolArgs as _ToolArgs,
    parse_gamma as _parse_gamma,
    parse_rate as _parse_rate,
    try_native_restore as _try_native_restore,
)

# jax (and the device ops module) import lazily inside the tools that use
# the device — scanimate, colormap's LUT build, cassette. The host-numpy
# tools (posterize/colorkey/average-delay/vhsled/frameblend/filmac/
# normalize-ts) never import jax: they are one-shot CLI processes at the
# reference's I/O-bound cost class, and the jax import would be a large
# share of their wall time. tests/test_cli.py pins this with a poisoned
# import finder.


def _open_video_inputs(paths):
    """(readers, cleanups) for a list of video paths: native Y4M, or any
    container through the cvsim-av / ffmpeg backend (the reference's tools
    all demux through libav; ffmpeg_posterize.cpp:789-813 cost class)."""
    from cvsim_tpu.host import ffmpeg_pipe

    if not paths:
        raise ValueError("needs at least one -i <input>")
    readers, cleanups = [], []
    for p in paths:
        r, c = ffmpeg_pipe.resolve_video_input(p)
        readers.append(r)
        cleanups.append(c)
    return readers, cleanups


def _open_video_output(path, enc: dict | None = None):
    """(stream, finalize) for a video output path: plain Y4M file, or an
    H.264 container encode through the backend."""
    from cvsim_tpu.host import ffmpeg_pipe

    if not path:
        raise ValueError("needs -o <output>")
    return ffmpeg_pipe.resolve_video_output(path, **(enc or {}))


class _AsyncWriter:
    """Feeds writer.write(y, u, v) from a worker thread: the container
    encode rides a pipe whose write blocks on x264 backpressure, which
    would otherwise serialize per-frame compute with the encoder (the
    reference tools have the same serialization — beating them is the
    point). Bounded queue; close() flushes and re-raises any writer
    error. Use as a context manager: on error exit, its own secondary
    failure is suppressed (same rationale as _finalizing)."""

    def __init__(self, writer, depth: int = 8):
        import queue
        import threading

        self._w = writer
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is None:
                try:
                    self._w.write(*item)
                except BaseException as e:  # keep draining: no producer hang
                    self._err = e

    def write(self, y, u, v):
        if self._err is not None:
            raise self._err
        self._q.put((y, u, v))

    def close(self):
        self._q.put(None)
        self._t.join()
        if self._err is not None:
            raise self._err

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            try:
                self.close()
            except Exception:
                pass
        return False


@contextlib.contextmanager
def _finalizing(out_finalize):
    """Finalize the encoder on every exit (no live subprocess left behind
    in the resident daemon), but on an exception suppress finalize's OWN
    secondary error — closing a half-fed encoder exits nonzero on the
    truncated stream, and that must not mask the root cause (same guard as
    main._run_common's video stage)."""
    try:
        yield
    except BaseException:
        try:
            out_finalize()
        except Exception:
            pass
        raise
    else:
        out_finalize()


def _advance_fields(args: _ToolArgs, multi: bool):
    """Generator over (frames, fieldno) at the output field rate — the
    reference's layered InputFile advance loop (each input held for its
    own frame duration, all advancing in lockstep). Closes the input
    backends on exhaustion or caller abandonment."""
    paths = args.inputs if multi else args.inputs[:1]
    readers, in_cleanups = _open_video_inputs(paths)
    try:
        fpss = [r.header.fps for r in readers]
        n = len(readers)
        current = 0
        frame_idx = [0] * n
        frames = [None] * n
        next_at = [0] * n
        its = [iter(r) for r in readers]
        eof = [False] * n
        while True:
            for k in range(n):
                while not eof[k] and next_at[k] <= current:
                    try:
                        yf, uf, vf = next(its[k])
                    except StopIteration:
                        eof[k] = True
                        break
                    if uf is None:
                        uf = np.full_like(yf, 128)
                        vf = uf
                    frames[k] = _scale_underscan(
                        yf, uf, vf, args.width, args.height,
                        args.extra.get("underscan", 0))
                    frame_idx[k] += 1
                    next_at[k] = timing.frame_pts_to_field(
                        frame_idx[k], fpss[k], args.field_rate)
            if any(f is None for f in frames) or (
                    all(eof) and current >= max(next_at)):
                return
            yield frames, current
            current += 1
    finally:
        for c in in_cleanups:
            c()


def _open_tool_writer(args: _ToolArgs):
    out_hdr = y4m.Y4MHeader(
        width=args.width, height=args.height, fps=args.field_rate,
        interlacing="p", aspect="4:3",
        colorspace="422" if args.use_422 else "420jpeg")
    out_stream, out_finalize = _open_video_output(args.output)
    return y4m.Y4MWriter(out_stream, out_hdr), out_finalize


def _frame_loop(args: _ToolArgs, per_field, multi: bool = False):
    """Drive input frames at the output field rate; per_field(frame(s),
    fieldno) -> RGB [H, W, 3] output frame."""
    writer, out_finalize = _open_tool_writer(args)
    with _finalizing(out_finalize), _AsyncWriter(writer) as aw:
        for frames, current in _advance_fields(args, multi):
            frame = frames if multi else frames[0]
            _write_rgb(aw, np.asarray(per_field(frame, current)),
                       args.use_422)
            print(f"\x0dOutput field {current} ", end="", file=sys.stderr)
        print("", file=sys.stderr)
    return 0


def _frame_loop_1to1(args: _ToolArgs, per_frame, enc: dict | None = None):
    """One output frame per decoded input frame — the restore tools' loop
    shape (ffmpeg_vhsled.cpp:851-861, filmac.cpp:842-851: a frame is
    processed and encoded only when next_packet() decodes one; the output
    field rate only sets the pts *units* via video_frame_rgb_to_output_f,
    it never duplicates frames). The output stream therefore carries the
    input cadence: header fps is the input rate; -or is accepted for flag
    parity but has no observable effect on a CFR output."""
    (reader,), (in_cleanup,) = _open_video_inputs(args.inputs[:1])
    try:
        # restore-tool default: output dims follow the input unless -width/
        # -height were given (ffmpeg_vhsled.cpp:706-714, filmac.cpp same)
        if not args.width_set:
            args.width = reader.header.width
        if not args.height_set and "height_flag" not in args.extra:
            args.height = reader.header.height
        out_hdr = y4m.Y4MHeader(
            width=args.width, height=args.height, fps=reader.header.fps,
            interlacing="p", aspect="4:3",
            colorspace="422" if args.use_422 else "420jpeg")
        out_stream, out_finalize = _open_video_output(args.output, enc)
        writer = y4m.Y4MWriter(out_stream, out_hdr)
        with _finalizing(out_finalize), _AsyncWriter(writer) as aw:
            n = 0
            for yf, uf, vf in reader:
                if uf is None:
                    uf = np.full_like(yf, 128)
                    vf = uf
                frame = _scale_underscan(
                    yf, uf, vf, args.width, args.height,
                    args.extra.get("underscan", 0), chroma="bilinear")
                _write_rgb(aw, np.asarray(per_frame(frame, n)),
                           args.use_422)
                print(f"\x0dOutput frame {n} ", end="", file=sys.stderr)
                n += 1
            print("", file=sys.stderr)
    finally:
        in_cleanup()
    return 0


def _frame_loop_batched(args: _ToolArgs, per_batch, batch: int,
                        multi: bool = False):
    """Like _frame_loop, but fields are collected into batches of up to
    `batch` and handed to per_batch(frames [n,H,W,3] np, fieldnos [n]) ->
    list of RGB output frames. One device dispatch per batch instead of per
    field — the gen-1 GOP treatment for the compute-heavy sibling tools."""
    writer, out_finalize = _open_tool_writer(args)
    wslot = [None]

    def flush(buf_frames, buf_fields):
        outs = per_batch(np.stack(buf_frames), buf_fields)
        for out_rgb, fieldno in zip(outs, buf_fields):
            _write_rgb(wslot[0], out_rgb, args.use_422)
            print(f"\x0dOutput field {fieldno} ", end="", file=sys.stderr)

    with _finalizing(out_finalize), _AsyncWriter(writer) as aw:
        wslot[0] = aw
        buf_frames, buf_fields = [], []
        for frames, current in _advance_fields(args, multi):
            buf_frames.append(_last_frame(frames))
            buf_fields.append(current)
            if len(buf_frames) >= batch:
                flush(buf_frames, buf_fields)
                buf_frames, buf_fields = [], []
        if buf_frames:
            flush(buf_frames, buf_fields)
        print("", file=sys.stderr)
    return 0


def _last_frame(frames):
    """Reference multi-input semantics for the full-frame tools: every
    input's composite_layer overwrites the output, so the last input with a
    current frame wins (ffmpeg_posterize.cpp:1035-1061 loop shape)."""
    for f in reversed(frames):
        if f is not None:
            return f
    return frames[0]

def run_posterize(argv):
    """ffmpeg_posterize flags (:630-660): -threshhold <n> bit truncation.

    Host-numpy hot path (tools_np): an AND mask gains nothing on the
    device, where a per-field round trip would be the whole tool's cost."""
    args = _ToolArgs(argv, extra={"threshhold": (int, "threshhold")})
    thr = args.extra.get("threshhold", 3)   # InputFile default (ffmpeg_posterize.cpp:71)
    return _frame_loop(args, lambda frames, fieldno: tools_np.posterize(
        _last_frame(frames), thr), multi=True)


def run_colormap(argv):
    """ffmpeg_colormap: first -i is the map image, second the video
    (take_colormap from the middle scanline, :785-799)."""
    args = _ToolArgs(argv)
    if len(args.inputs) < 2:
        print("colormap needs -i <map.y4m> -i <video.y4m>", file=sys.stderr)
        return 1
    map_readers, map_cleanups = _open_video_inputs(args.inputs[:1])
    my, mu, mv = next(iter(map_readers[0]))
    for c in map_cleanups:
        c()
    if mu is None:
        mu = np.full_like(my, 128)
        mv = mu
    map_rgb = np.asarray(_scale_frame_to(my, mu, mv, args.width, args.height))
    lut = tools_np.take_colormap(map_rgb)
    args.inputs = args.inputs[1:]
    return _frame_loop(args, lambda frames, fieldno: tools_np.colormap_apply(
        _last_frame(frames), lut), multi=True)


def run_colorkey(argv):
    """ffmpeg_colorkey flags (:639-698): -color <argb> -threshhold -inv
    -noise <n> -f <fade> -xd <n> -d <ring>. Multiple -i inputs layer in
    order, each keyed with ITS OWN settings (flags apply to the most recent
    -i, and a new -i inherits the previous one's settings — the reference's
    InputFile copy semantics)."""
    args = _ToolArgs(argv, extra={
        "color": (lambda v: int(v, 0), "color"),
        "threshhold": (int, "threshhold"),
        "inv": (lambda v: int(v, 0) > 0, "invert"),
        "noise": (int, "noisekey"),
        "f": (int, "fade"),
        "xd": (int, "xdivr"),
    })

    def layer_fn(cfg):
        color_int = cfg.get("color", 0)
        color = ((color_int >> 16) & 0xFF, (color_int >> 8) & 0xFF,
                 color_int & 0xFF)
        return lambda dst, src, k: tools_np.colorkey_apply(
            dst, src, k, color=color,
            threshhold=cfg.get("threshhold", 0),
            invert=bool(cfg.get("invert", False)),
            noisekey=cfg.get("noisekey", 0),
            fade=cfg.get("fade", 0),
            xdivr=cfg.get("xdivr", 1))

    fns = [layer_fn(c) for c in (args.per_input or [args.extra])]
    ring = [np.zeros((args.height, args.width, 3), np.int32)
            for _ in range(args.delay)]
    idx = {"i": 0}

    def per_field(frames, fieldno):
        canvas = ring[idx["i"]]
        for layer, (fn, frame) in enumerate(zip(fns, frames)):
            # noise streams content-addressed by (fieldno, layer) — same
            # design as the engine noise: restart/batch-invariant
            canvas = fn(canvas, frame,
                        int(noise_np.field_stage_key(0, fieldno, layer)))
        ring[idx["i"]] = canvas
        idx["i"] = (idx["i"] + 1) % args.delay
        return canvas

    return _frame_loop(args, per_field, multi=True)


def run_average_delay(argv):
    """ffmpeg_average_delay flags (:619-655): -d <ring> -n <newlevel>.
    Multiple -i inputs blend into the ring canvas in order, each with its
    own -n level (reference InputFile semantics)."""
    args = _ToolArgs(argv, extra={"n": (int, "newlevel")})
    cfgs = args.per_input or [args.extra]
    fns = [lambda dst, src, fld, nl=c.get("newlevel", 128):
           tools_np.average_delay_blend(dst, src, fld, newlevel=nl,
                                        delay=args.delay)
           for c in cfgs]
    ring = [np.zeros((args.height, args.width, 3), np.int32)
            for _ in range(args.delay)]
    idx = {"i": 0}

    def per_field(frames, fieldno):
        canvas = ring[idx["i"]]
        for fn, frame in zip(fns, frames):
            canvas = fn(canvas, frame, fieldno)
        ring[idx["i"]] = canvas
        idx["i"] = (idx["i"] + 1) % args.delay
        return canvas

    return _frame_loop(args, per_field, multi=True)


def run_scanimate(argv, batch: int = 16):
    """ffmpeg_scanimate flags (:653-698): -inntsc (source is interlaced NTSC),
    plus raster presets 720p60/1080p60 set width/height.

    The phosphor splat is the one sibling tool with real compute (matmul
    splat, models/tools._splat_matmul), so it keeps the device — but
    batched: one dispatch per `batch` fields (two with -inntsc, one per
    field parity since the source-row start is a static layout parameter),
    and only the uint8 gray raster rides D2H (the RGB expansion is a host
    stack)."""
    args = _ToolArgs(argv, extra={"inntsc": ("flag", "inntsc")})
    input_ntsc = bool(args.extra.get("inntsc", False))

    from functools import partial

    import jax
    import jax.numpy as jnp

    from cvsim_tpu.models import tools as ops

    @partial(jax.jit, static_argnums=(2,))
    def fnb_jit(frames, fieldnos, fld):
        def one(f, fno):
            r = ops.scanimate_field(f, args.height, args.width, fld, fno,
                                    input_ntsc=input_ntsc)
            return jnp.clip(r, 0, 255).astype(jnp.uint8)
        return jax.vmap(one)(frames, fieldnos)

    compiled = {}

    def fnb(frames, fieldnos, fld):
        # one compiled program per (shape, fld)
        key = (frames.shape, fld)
        fn = compiled.get(key)
        if fn is None:
            fn = fnb_jit.lower(frames, fieldnos, fld).compile()
            compiled[key] = fn
        return fn(frames, fieldnos)

    prev = {"frame": None}

    def dispatch(frames, fieldnos, fld, target=batch):
        # pad short (final / parity-split) batches up to `target` so every
        # dispatch reuses one compiled shape per path
        n = frames.shape[0]
        pad = target - n if n < target else 0
        if pad:
            frames = np.concatenate(
                [frames, np.zeros((pad,) + frames.shape[1:], frames.dtype)])
            fieldnos = list(fieldnos) + [0] * pad
        out = fnb(jnp.asarray(frames, jnp.int32),
                  jnp.asarray(fieldnos, jnp.int32), fld)
        return np.asarray(out)[:n]

    def per_batch(frames, fieldnos):
        if input_ntsc:
            # source-row parity is static: split the batch by parity, one
            # dispatch each, re-interleave
            par = np.asarray([(f & 1) ^ 1 for f in fieldnos])
            gray = np.empty((len(fieldnos), args.height, args.width),
                            np.uint8)
            for p in (0, 1):
                sel = np.nonzero(par == p)[0]
                if sel.size:
                    # contiguous fields alternate parity, so each group is
                    # at most ceil(batch/2)
                    gray[sel] = dispatch(frames[sel],
                                         [fieldnos[i] for i in sel], p,
                                         target=(batch + 1) // 2)
        else:
            gray = dispatch(frames, fieldnos, 0)
        outs = []
        for k, fieldno in enumerate(fieldnos):
            out = np.repeat(gray[k].astype(np.int32)[..., None], 3, axis=-1)
            parity = (fieldno & 1) ^ 1
            if parity == 1 and prev["frame"] is not None:
                # the copy-to-screen loop starts at y=field (:965): on odd
                # fields output row 0 keeps the persistent canvas's content
                out[0] = prev["frame"][0]
            prev["frame"] = out
            outs.append(out)
        return outs

    return _frame_loop_batched(args, per_batch, batch, multi=True)


def run_cassette(argv):
    """ffmpeg_cassette flags (:420-560): -low -high -headalign
    -headalignwaver -mono -preset 0..4 -audio-hiss -preemphasis -deemphasis.
    Audio-only: -i in.wav -o out.wav."""
    import jax
    import jax.numpy as jnp

    from cvsim_tpu.audio.cassette import (
        CASSETTE_PRESETS, CassetteConfig, cassette_audio_process,
        init_cassette_state)

    kw = dict()
    in_path = out_path = ""
    ss = se = dur = -1.0
    i = 0
    while i < len(argv):
        a = argv[i].lstrip("-"); i += 1
        if a in ("h", "help"):
            print("flags: -i <in.wav> -o <out.wav> -preset <0..4> -mono "
                  "-low <hz> -high <hz> -headalign <n> -headalignwaver <n> "
                  "-audio-hiss <dB> -preemphasis <0|1> -deemphasis <0|1> "
                  "-a <idx> -an -ss <s> -se <s> -t <s>", file=sys.stderr)
            return 1
        if a == "i":
            in_path = argv[i]; i += 1
        elif a == "o":
            out_path = argv[i]; i += 1
        elif a == "mono":
            kw["mono_downmix"] = True
        elif a == "headalign":
            kw["head_tilt"] = float(int(float(argv[i]))); i += 1  # atoi in ref
        elif a == "headalignwaver":
            kw["head_tilt_waver"] = float(int(float(argv[i]))); i += 1
        elif a == "low":
            kw["lowpass_hz"] = float(argv[i]); i += 1
        elif a == "high":
            kw["highpass_hz"] = float(argv[i]); i += 1
        elif a == "audio-hiss":
            kw["hiss_db"] = float(argv[i]); i += 1
        elif a == "preemphasis":
            kw["emulating_preemphasis"] = int(argv[i]) > 0; i += 1
        elif a == "deemphasis":
            kw["emulating_deemphasis"] = int(argv[i]) > 0; i += 1
        elif a == "preset":
            kw.update(CASSETTE_PRESETS[int(argv[i])]); i += 1
        elif a == "ss":
            ss = float(argv[i]); i += 1
        elif a == "se":
            se = float(argv[i]); i += 1
        elif a == "t":
            dur = float(argv[i]); i += 1
        elif a in ("a", "an"):
            if a == "a":
                i += 1
        else:
            print(f"Unknown switch '{a}'", file=sys.stderr)
            return 1
    if not in_path or not out_path:
        print("cassette needs -i in.wav -o out.wav", file=sys.stderr)
        return 1

    # preset values may be overridden by later flags: _ToolArgs-style ordering
    # is already handled because we apply dict.update in argv order.
    cfg = CassetteConfig(**{k: v for k, v in kw.items()
                            if k in CassetteConfig._fields})
    from cvsim_tpu.host import ffmpeg_pipe

    # WAV natively; any other container/codec through the backend (the
    # reference decodes via libav, ffmpeg_cassette.cpp input loop)
    samples, rate = ffmpeg_pipe.resolve_audio_input(in_path, cfg.rate, 2)
    if rate != cfg.rate:
        from cvsim_tpu.host.pipeline import _resample_sinc
        samples = _resample_sinc(samples, rate, cfg.rate)
    if ss >= 0 or se >= 0 or dur >= 0:
        if se < 0 and dur >= 0:
            se = max(ss, 0) + dur
        s0 = int(max(ss, 0) * cfg.rate)
        s1 = int(se * cfg.rate) if se >= 0 else len(samples)
        samples = samples[s0:s1]
    if samples.shape[1] != cfg.channels:
        if cfg.channels == 2 and samples.shape[1] == 1:
            samples = np.repeat(samples, 2, axis=1)
        else:
            samples = samples[:, :cfg.channels]

    state = init_cassette_state(cfg)
    key = jax.random.PRNGKey(0)
    outs = []
    pos = 0
    # big chunks: dispatches are serialized by the carried state and each
    # pays a launch and a round trip (same rationale as pipeline.run_audio)
    chunk = 1 << 20
    while pos < len(samples):
        out, state = cassette_audio_process(
            jnp.asarray(samples[pos:pos + chunk], jnp.int32), state, key,
            cfg=cfg)
        outs.append(np.asarray(out))
        pos += chunk
    wavio.write_wav(out_path, np.concatenate(outs).astype(np.int16), cfg.rate)
    return 0


def _scale_underscan(yf, uf, vf, w, h, underscan, chroma="repeat"):
    """Frame scale with the InputFile tools' -underscan: the image renders
    at (100-u)% size centered on a black canvas (ffmpeg_vhsled.cpp:307-331,
    same block in frameblend.cpp/filmac.cpp). The restore tools pass
    chroma="bilinear": the reference's InputFile ingest interpolates chroma
    up through an SWS_BILINEAR resampler (ffmpeg_vhsled.cpp:318-323)."""
    if underscan <= 0:
        return _scale_frame_to(yf, uf, vf, w, h, chroma)
    u = min(99, underscan)
    fw = max(1, (w * (100 - u)) // 100)
    fh = max(1, (h * (100 - u)) // 100)
    img = np.asarray(_scale_frame_to(yf, uf, vf, fw, fh, chroma))
    canvas = np.zeros((h, w, 3), img.dtype)
    x0, y0 = (w - fw) // 2, (h - fh) // 2
    canvas[y0:y0 + fh, x0:x0 + fw] = img
    return canvas


def run_frameblend(argv):
    """frameblend flags (:522-568): -or <rate> output rate, -sqnr squelch,
    -fa <n> alternate-frame step, -ffa full-frame-alt, -gamma <x|vga|ntsc>."""
    from cvsim_tpu.models import restore

    args = _ToolArgs(argv, extra=_RESTORE_EXTRA["frameblend"])
    if "height_flag" in args.extra:
        args.height = args.extra["height_flag"]
    out_rate = args.extra.get("out_rate", args.field_rate)
    framealt = max(1, min(8, args.extra.get("fa", 1)))
    fullframealt = bool(args.extra.get("ffa", False))
    squelch = bool(args.extra.get("sqnr", False))
    gamma = args.extra.get("gamma", -1.0)
    gdec = genc = None
    if gamma > 1:
        gdec, genc = restore.gamma_tables(gamma)

    # the frame_t products must stay < 2^53 for the native loop's double
    # division to be the identical correctly-rounded value (exotic -or
    # fractions from Fraction(float) fall back to the Python loop)
    if (out_rate.numerator <= 10**6 and out_rate.denominator <= 10**6):
        fb_flags = ["-or-num", out_rate.numerator,
                    "-or-den", out_rate.denominator, "-fa", framealt]
        if fullframealt:
            fb_flags += ["-ffa"]
        if squelch:
            fb_flags += ["-sqnr"]
        if gamma > 1:
            fb_flags += ["-gamma", repr(float(gamma))]
        rc = _try_native_restore("frameblend", args, _ENC_FRAMEBLEND,
                                 fb_flags)
        if rc is not None:
            return rc

    (reader,), (in_cleanup,) = _open_video_inputs(args.inputs[:1])
    fps = reader.header.fps
    # output dims follow the input unless given (frameblend.cpp:751-752)
    if not args.width_set:
        args.width = reader.header.width
    if not args.height_set and "height_flag" not in args.extra:
        args.height = reader.header.height
    out_hdr = y4m.Y4MHeader(
        width=args.width, height=args.height, fps=Fraction(out_rate),
        interlacing="p", aspect="4:3",
        colorspace="422" if args.use_422 else "420jpeg")
    out_stream, out_finalize = _open_video_output(args.output,
                                                  _ENC_FRAMEBLEND)
    writer = y4m.Y4MWriter(out_stream, out_hdr)

    try:
        with _finalizing(out_finalize), _AsyncWriter(writer) as aw:
            _run_frameblend_loop(args, reader, aw, out_rate, fps,
                                 framealt, fullframealt, squelch, gdec, genc)
    finally:
        in_cleanup()
    return 0


def _run_frameblend_loop(args, reader, writer, out_rate, fps, framealt,
                         fullframealt, squelch, gdec, genc):
    from cvsim_tpu.models import restore

    it = iter(reader)
    frames = []        # RGB numpy frames
    frame_t = []       # in output-frame units
    src_idx = 0
    eof = False
    current = 0
    while True:
        while not eof and (not frame_t or frame_t[-1] < current + 30):
            try:
                yf, uf, vf = next(it)
            except StopIteration:
                eof = True
                break
            if uf is None:
                uf = np.full_like(yf, 128)
                vf = uf
            frames.append(np.asarray(_scale_underscan(
                yf, uf, vf, args.width, args.height,
                args.extra.get("underscan", 0), chroma="bilinear")))
            frame_t.append(float(src_idx * out_rate / fps))
            src_idx += 1
        if not frames or (eof and frame_t and current > np.ceil(frame_t[-1])):
            break
        w16, cutoff = restore.frameblend_weights(
            frame_t, current, framealt, fullframealt, squelch)
        used = [frames[i] for i, _ in w16]
        out_rgb = hostpix.frameblend_mix(used, w16, gdec, genc)
        _write_rgb(writer, out_rgb, args.use_422)
        print(f"\x0dOutput frame {current} ", end="", file=sys.stderr)
        current += 1
        if cutoff > 0:
            frames = frames[cutoff:]
            frame_t = frame_t[cutoff:]
        if eof and current > (frame_t[-1] if frame_t else 0) + 1:
            break
    print("", file=sys.stderr)


def run_filmac(argv):
    """filmac flags (:486-560): -gamma <x|vga|ntsc>, 1:1 frame AGC."""
    from cvsim_tpu.models import restore

    args = _ToolArgs(argv, extra=_RESTORE_EXTRA["filmac"])
    if "height_flag" in args.extra:
        args.height = args.extra["height_flag"]
    if "out_rate" in args.extra:
        args.field_rate = args.extra["out_rate"]
    gamma = args.extra.get("gamma", -1.0)
    rc = _try_native_restore(
        "filmac", args, _ENC_RESTORE,
        ["-gamma", repr(float(gamma))] if gamma > 1 else [])
    if rc is not None:
        return rc
    gdec = genc = None
    if gamma > 1:
        gdec, genc = restore.gamma_tables(gamma)
    state = restore.FilmacState()

    def per_frame(frame, n):
        # 1:1 with input frames (filmac.cpp:842-851) — the temporal level
        # IIR (:927-942) must advance once per decoded frame, not once per
        # output field, or AGC converges at double speed
        minv, maxv, scaleto = hostpix.filmac_measure(frame, gdec)
        restore.filmac_update_levels(state, minv, maxv)
        return hostpix.filmac_rescale(frame, state, scaleto, gdec, genc)

    return _frame_loop_1to1(args, per_frame, enc=_ENC_RESTORE)


def run_vhsled(argv):
    """vhsled: per-scanline left-edge de-jitter, one output frame per
    input frame (ffmpeg_vhsled.cpp:851-861). Flags (:476-567): -or <rate>
    (pts units only in the reference — no cadence effect), -underscan
    <pct>; -gamma is parsed for parity but the reference's gamma tables
    have no callers in this tool (dead flag), so it is accepted and
    ignored here too."""
    args = _ToolArgs(argv, extra=_RESTORE_EXTRA["vhsled"])
    if "height_flag" in args.extra:
        args.height = args.extra["height_flag"]
    if "out_rate" in args.extra:
        args.field_rate = args.extra["out_rate"]
    rc = _try_native_restore("vhsled", args, _ENC_RESTORE, [])
    if rc is not None:
        return rc
    return _frame_loop_1to1(
        args, lambda frame, n: hostpix.vhsled_dejitter(frame),
        enc=_ENC_RESTORE)


def run_raw28ntsc(argv):
    """Software composite-signal decoder (ffmpeg_raw28ntsc)."""
    from cvsim_tpu.cli.raw28 import run as run_raw
    return run_raw(argv)


def run_normalize_ts(argv):
    """normalize_ts: monotonic PTS rewrite (normalize_ts.cpp:171-188,
    438-467 per-stream tracking).

    Y4M carries no timestamps, so the container timestamps ride a sidecar
    packet log: `-pts-in <file>` lines are `<stream_index> <pts|none>` (or
    bare `<pts>` for stream 0), one per packet in mux order — the shape an
    `ffmpeg -copyts`/ffprobe packet dump reduces to. Each stream's PTS run
    is rewritten monotonic by timing.StreamTsState (backward jumps lifted,
    forward jumps clamped to -maxfwd ticks) and written to `-pts-out`.
    Video frames (stream 0 packets) copy through unchanged. Without
    -pts-in, a container input's OWN packet timestamps are demuxed
    directly (cvsim-av decode -pkt-log — the reference reads them off
    av_read_frame, normalize_ts.cpp:430-436); a Y4M input's frames are
    implicitly monotonic and this is a remux/validation pass."""
    import tempfile

    from cvsim_tpu.host import ffmpeg_pipe

    args = _ToolArgs(argv, extra={"program": (int, "program"),
                                  "maxfwd": (int, "maxfwd"),
                                  "pts-in": (str, "pts_in"),
                                  "pts-out": (str, "pts_out")})
    maxfwd = args.extra.get("maxfwd", 0)

    def read_pkt_log(path):
        pkts = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                sidx, pts = (("0", parts[0]) if len(parts) == 1
                             else (parts[0], parts[1]))
                pkts.append((int(sidx),
                             None if pts == "none" else int(pts)))
        return pkts

    packets = None
    if "pts_in" in args.extra:
        packets = read_pkt_log(args.extra["pts_in"])

    if not args.inputs or not args.output:
        raise ValueError("normalize-ts needs -i <in> -o <out>")
    in_path = args.inputs[0]
    auto_log = None
    if (packets is None and not in_path.endswith(".y4m")
            and ffmpeg_pipe.av_tool() is not None):
        fd, auto_log = tempfile.mkstemp(prefix="cvsim_pts_", suffix=".log")
        os.close(fd)

    n = 0
    out, out_finalize = _open_video_output(args.output)
    with _finalizing(out_finalize):
        if auto_log is not None:
            reader, proc = ffmpeg_pipe.open_video_reader(
                in_path, pkt_log=auto_log)
            w = y4m.Y4MWriter(out, reader.header)
            try:
                for yf, uf, vf in reader:
                    w.write(yf, uf, vf)
                    n += 1
                proc.stdout.close()
                rc = proc.wait()
                if rc != 0:
                    # a decoder that died mid-stream looks like clean EOF
                    # to the Y4M reader — don't report a truncated remux
                    # as success
                    raise RuntimeError(
                        f"demuxer exited with rc {rc} after {n} frames")
                packets = read_pkt_log(auto_log)
            finally:
                if os.path.exists(auto_log):
                    os.unlink(auto_log)
            if "pts_out" not in args.extra:
                args.extra["pts_out"] = args.output + ".pts"
        else:
            reader, cleanup = ffmpeg_pipe.resolve_video_input(in_path)
            w = y4m.Y4MWriter(out, reader.header)
            for yf, uf, vf in reader:
                w.write(yf, uf, vf)
                n += 1
            cleanup()

    if packets is not None:
        states: dict[int, timing.StreamTsState] = {}
        lines = []
        for sidx, pts in packets:
            st = states.setdefault(
                sidx, timing.StreamTsState(max_forward=maxfwd))
            p = st.rewrite(pts)
            lines.append(f"{sidx} {'none' if p is None else p}")
        out_path = (args.extra["pts_out"] if "pts_out" in args.extra
                    else args.extra["pts_in"] + ".norm")
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"{n} frames remuxed; {len(packets)} packet timestamps "
              f"normalized across {len(states)} stream(s)", file=sys.stderr)
    else:
        print(f"{n} frames remuxed (monotonic)", file=sys.stderr)
    return 0


def _write_rgb(writer, rgb, use_422: bool):
    y, u, v = hostpix.rgb_to_yuv_planes(np.asarray(rgb))
    if use_422:
        writer.write(y, u[:, 0::2], v[:, 0::2])
    else:
        writer.write(y, u[0::2, 0::2], v[0::2, 0::2])
