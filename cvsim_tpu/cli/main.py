"""cvsim-tpu command line (reference L8).

Subcommands map 1:1 to the reference tools; flags within each subcommand use
the reference's exact names and preset-layering semantics
(ffmpeg_to_composite.cpp:1272-1323 help text is the contract).

I/O formats: video is Y4M in/out (`-i in.y4m -o out.y4m`); audio rides
sidecar WAV (`-audio-in in.wav -audio-out out.wav`) since Y4M carries no
audio. With an `ffmpeg` binary on PATH any container works via pipes.
"""

from __future__ import annotations

import os
import signal
import sys

from cvsim_tpu import presets


def compile_cache_dir(environ=None) -> str | None:
    """Where this program puts JAX's persistent compilation cache: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX then uses that directory and the
    program sets none), else the fixed path <checkout>/.jax_cache. The path
    is part of the cache's key, so it must not move between runs."""
    environ = os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache (see compile_cache_dir)."""
    import jax

    from cvsim_tpu.utils.log import phase

    phase("jax_imported")
    path = compile_cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)


def cli_entry():
    """Console-script entry point (`cvsim`)."""
    raise SystemExit(main())


def _soft_sigint():
    """Soft Ctrl-C: finish the current batch and write the trailer; abort
    after 20 signals (reference DIE counter, ffmpeg_to_composite.cpp:62-66)."""
    state = {"die": 0}

    def handler(sig, frame):
        state["die"] += 1
        if state["die"] >= 20:
            raise SystemExit(130)

    for s in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
        try:
            signal.signal(s, handler)
        except (ValueError, OSError):
            pass
    return state


def _cli_mesh(n_devices: int):
    """-devices n: build the n-chip ('dp','sp') mesh, failing loud if the
    backend shows fewer devices (parallel.make_mesh contract)."""
    if not n_devices:
        return None
    from cvsim_tpu.parallel import make_mesh

    return make_mesh(n_devices)


def cmd_to_composite(argv):
    """Flagship gen-1 tool (ffmpeg_to_composite)."""
    st = presets.parse_composite_flags(argv, gen2=False)
    if ((not st.input_files and not st.audio_in)
            or (st.input_files and not st.output_file)):
        print("You must specify an input and output file (-i and -o).",
              file=sys.stderr)
        return 1
    return _run_common(st, gen1=True)


def cmd_ntsc(argv):
    """Gen-2 YIQ engine tool (ffmpeg_ntsc): multi-input layering + delay ring."""
    st = presets.parse_composite_flags(argv, gen2=True)
    if not st.output_file and not st.audio_out:
        print("No output file specified", file=sys.stderr)
        return 1
    from cvsim_tpu.host.pipeline_yiq import YIQPipeline
    from cvsim_tpu.host import ffmpeg_pipe

    die = _soft_sigint()
    cfg = st.to_run_config(gen1=False)
    # -checkpoint: resumable runs (original extension, gen-1 semantics —
    # host/checkpoint.py). Only a native Y4M output can be
    # truncated-and-appended; encoder pipes cannot.
    ckpt_path = None
    resuming = False
    if st.checkpoint and st.output_file:
        if st.output_file.endswith(".y4m"):
            ckpt_path = st.output_file + ".ckpt"
            from cvsim_tpu.host import checkpoint as _ckpt

            loaded = _ckpt.load(ckpt_path)
            resuming = bool(
                loaded
                and loaded[0].get("cfg_hash") == _ckpt.config_hash(cfg)
                and os.path.exists(st.output_file))
        else:
            print("-checkpoint requires a .y4m output; ignoring",
                  file=sys.stderr)
    pipe = YIQPipeline(cfg, frame_delay=st.frame_delay, die=die,
                       mesh=_cli_mesh(st.devices))
    will_encode_video = bool(st.input_files and st.video_stream_index >= 0
                             and st.output_file)

    # audio first so a processed WAV can mux into the video container
    # (same stage order as _run_common; -an disables like gen-1)
    mux_wav = None
    audio_tmp = None
    fields = 0
    try:
        if st.audio_in and st.audio_stream_index >= 0:
            audio_dst = st.audio_out
            want_mux = (not audio_dst and will_encode_video
                        and not st.output_file.endswith(".y4m")
                        and ffmpeg_pipe.have_backend())
            if want_mux:
                import tempfile

                fd, audio_tmp = tempfile.mkstemp(suffix=".wav",
                                                 prefix="cvsim_mux_")
                os.close(fd)
                audio_dst = audio_tmp
            if audio_dst:
                if (resuming and os.path.exists(audio_dst)
                        and audio_dst != audio_tmp):
                    print("Resume: audio output already complete; skipping",
                          file=sys.stderr)
                else:
                    _audio_pipe(cfg).run_audio(st.audio_in, audio_dst)
                if want_mux:
                    mux_wav = audio_dst
            else:
                print("audio input given but no -audio-out and no container "
                      "video output to mux into; skipping audio",
                      file=sys.stderr)
        if will_encode_video:
            readers, cleanups = [], []
            for path in st.input_files:
                r, c = ffmpeg_pipe.resolve_video_input(path)
                readers.append(r)
                cleanups.append(c)
            if resuming:
                out_stream = open(st.output_file, "r+b")
                finalize = out_stream.close
            else:
                out_stream, finalize = ffmpeg_pipe.resolve_video_output(
                    st.output_file, mux_wav=mux_wav)
            frame_log, log_rate = None, 90000
            if st.video_pts_in:
                from cvsim_tpu.host import timing as _timing

                frame_log, log_rate = _timing.read_frame_pts_log(
                    st.video_pts_in)
            try:
                fields = pipe.run_video(readers, out_stream,
                                        ckpt_path=ckpt_path,
                                        frame_log=frame_log,
                                        frame_log_rate=log_rate)
            except BaseException:
                try:
                    finalize()   # never mask the root cause
                except Exception:
                    pass
                raise
            else:
                finalize()
            finally:
                for c in cleanups:
                    c()
    finally:
        if audio_tmp:
            try:
                os.unlink(audio_tmp)
            except OSError:
                pass
    print(f"\n{fields} fields", file=sys.stderr)
    return 0


def _audio_pipe(cfg):
    from cvsim_tpu.host.pipeline import CompositePipeline
    return CompositePipeline(cfg)


def _run_common(st, gen1: bool):
    from cvsim_tpu.host.pipeline import CompositePipeline

    die = _soft_sigint()
    cfg = st.to_run_config(gen1=gen1)
    print(f"Transcoding from {max(0.0, st.transcode_start):.2f} to "
          f"{st.transcode_end:.2f}", file=sys.stderr)
    print(f"VHS head switching point: {st.vhs_head_switching_point:.6f}",
          file=sys.stderr)
    print(f"VHS head switching noise: {st.vhs_head_switching_phase_noise:.6f}",
          file=sys.stderr)
    from cvsim_tpu.host import ffmpeg_pipe

    pipe = CompositePipeline(cfg, die=die, mesh=_cli_mesh(st.devices))
    fields = 0
    # -checkpoint: resumable runs (original extension; see host/checkpoint.py).
    # Only the native Y4M output path can be truncated-and-appended; encoder
    # pipes cannot.
    ckpt_path = None
    resuming = False
    if st.checkpoint and st.output_file:
        if st.output_file.endswith(".y4m"):
            ckpt_path = st.output_file + ".ckpt"
            from cvsim_tpu.host import checkpoint as _ckpt

            loaded = _ckpt.load(ckpt_path)
            resuming = bool(
                loaded
                and loaded[0].get("cfg_hash") == _ckpt.config_hash(cfg)
                and os.path.exists(st.output_file))
        else:
            print("-checkpoint requires a .y4m output; ignoring",
                  file=sys.stderr)
    # Audio first: a processed WAV can then be muxed into the video
    # container in the same encode pass (reference: one output file with
    # H.264 + PCM S16LE, ffmpeg_to_composite.cpp:2034-2106). Sidecar WAV
    # output (-audio-out) still works and wins when given.
    mux_wav = None
    audio_tmp = None
    if st.audio_in and st.audio_stream_index >= 0:
        audio_dst = st.audio_out
        # muxing needs the video stage to actually run (the container is
        # written by the video encoder); without it the processed WAV
        # would land in a temp file and be deleted
        will_encode_video = bool(st.input_files
                                 and st.video_stream_index >= 0
                                 and st.output_file)
        want_mux = (not audio_dst and will_encode_video
                    and not st.output_file.endswith(".y4m")
                    and ffmpeg_pipe.have_backend())
        if not audio_dst and not want_mux:
            print("audio input given but no -audio-out and no container "
                  "video output to mux into; skipping audio",
                  file=sys.stderr)
        if want_mux:
            import tempfile

            fd, audio_tmp = tempfile.mkstemp(suffix=".wav",
                                             prefix="cvsim_mux_")
            os.close(fd)
            audio_dst = audio_tmp
        if audio_dst:
            if resuming and os.path.exists(audio_dst) and audio_dst != audio_tmp:
                print("Resume: audio output already complete; skipping",
                      file=sys.stderr)
            else:
                pts_packets = None
                if st.audio_pts_in:
                    from cvsim_tpu.host import timing as _t
                    pts_packets = _t.read_audio_pts_log(st.audio_pts_in)
                pipe.run_audio(st.audio_in, audio_dst,
                               pts_packets=pts_packets)
            if want_mux:
                mux_wav = audio_dst
    try:
        if st.input_files and st.video_stream_index >= 0 and st.output_file:
            reader, rclean = ffmpeg_pipe.resolve_video_input(
                st.input_files[0])
            if resuming:
                out_stream = open(st.output_file, "r+b")
                finalize = out_stream.close
            else:
                out_stream, finalize = ffmpeg_pipe.resolve_video_output(
                    st.output_file, mux_wav=mux_wav,
                    interlaced=cfg.output.interlaced_output)
            frame_log, log_rate = None, 90000
            if st.video_pts_in:
                from cvsim_tpu.host import timing as _timing

                frame_log, log_rate = _timing.read_frame_pts_log(
                    st.video_pts_in)
            try:
                fields = pipe.run_video(reader, out_stream,
                                        ckpt_path=ckpt_path,
                                        frame_log=frame_log,
                                        frame_log_rate=log_rate)
            except BaseException:
                # closing a half-fed encoder raises a secondary error
                # (ffmpeg exits nonzero on the truncated stream) that must
                # not mask the root cause
                try:
                    finalize()
                except Exception:
                    pass
                raise
            else:
                finalize()
            finally:
                rclean()
    finally:
        if audio_tmp:
            try:
                os.unlink(audio_tmp)
            except OSError:
                pass
    return 0


def cmd_cassette(argv):
    from cvsim_tpu.cli.tools import run_cassette
    return run_cassette(argv)


def _tool(name):
    def run(argv):
        from cvsim_tpu.cli import tools
        return getattr(tools, f"run_{name}")(argv)
    return run


def _restore_tool(name):
    """vhsled/frameblend/filmac: try the numpy-free native fast path first
    (cli/toolargs.fast_restore — the whole loop runs inside cvsim-av);
    fall back to the full cli/tools loop for anything it declines. The
    numpy import alone is ~0.3 s against these tools' ~3 s runs."""
    def run(argv):
        from cvsim_tpu.cli import toolargs
        rc = toolargs.fast_restore(name, argv)
        if rc is not None:
            return rc
        from cvsim_tpu.cli import tools
        return getattr(tools, f"run_{name}")(argv)
    return run


COMMANDS = {
    "to-composite": cmd_to_composite,
    "ntsc": cmd_ntsc,
    "cassette": cmd_cassette,
    "colorkey": _tool("colorkey"),
    "colormap": _tool("colormap"),
    "posterize": _tool("posterize"),
    "scanimate": _tool("scanimate"),
    "average-delay": _tool("average_delay"),
    "frameblend": _restore_tool("frameblend"),
    "filmac": _restore_tool("filmac"),
    "vhsled": _restore_tool("vhsled"),
    "raw28ntsc": _tool("raw28ntsc"),
    "normalize-ts": _tool("normalize_ts"),
}


def _cmd_vaporwave(argv):
    """text2vaporwave.pl: ASCII -> fullwidth unicode (args or stdin)."""
    from cvsim_tpu.utils import vaporwave

    return vaporwave.main(argv)


COMMANDS["vaporwave"] = _cmd_vaporwave


def _cmd_repo_update_all(argv):
    """git-update-all[-wo-push]: commit the whole tree, push + fetch."""
    from cvsim_tpu.utils import repo_maint

    return repo_maint.main_update_all(argv)


def _cmd_repo_source_pickup(argv):
    """git-source-pickup.pl: dated commit-stamped source .tar.xz."""
    from cvsim_tpu.utils import repo_maint

    return repo_maint.main_source_pickup(argv)


COMMANDS["repo-update-all"] = _cmd_repo_update_all
COMMANDS["repo-source-pickup"] = _cmd_repo_source_pickup


def cmd_serve(argv):
    """Daemon mode (cli/serve.py): resident process amortizing the
    per-process device-program load across tool invocations."""
    from cvsim_tpu.cli import serve

    return serve.run_serve(argv)


COMMANDS["serve"] = cmd_serve

# Commands whose hot path dispatches to the device. Everything else runs
# host-numpy end-to-end (the reference's I/O-bound cost class) and must not
# pay the jax import, so the compile cache is set up for these only.
DEVICE_COMMANDS = {"to-composite", "ntsc", "cassette", "scanimate",
                   "raw28ntsc", "serve"}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) >= 2 and argv[0] == "-via":
        # forward to a running `cvsim serve` (no jax init in this process)
        from cvsim_tpu.cli import serve

        return serve.run_via(argv[1], argv[2:])
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("usage: cvsim [-via <socket>] <command> [flags]\ncommands: "
              + " ".join(sorted(COMMANDS)), file=sys.stderr)
        return 0 if argv else 1
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command '{cmd}'", file=sys.stderr)
        return 1
    if cmd in DEVICE_COMMANDS:
        from cvsim_tpu.utils.log import phase

        phase("cli_entry")          # interpreter + cli imports, pre-jax
        enable_compile_cache()
    try:
        return COMMANDS[cmd](argv[1:])
    except ValueError as e:
        print(f"cvsim {cmd}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
