#!/usr/bin/env python3
"""Smoke test of cvsim on the GPU: the main paths once, at real size.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: only the -devices 4 and
                                  # line-sharded checks

Run from the root of a checkout. All device work happens in this one
process (a JAX process reserves most of a card's memory, so a second one
would fail); the only other JAX processes are reference children forced
onto the CPU backend. Inputs are generated from fixed seeds.

Phases, one line of numbers each:

  device    every JAX device is a GPU; jax version; the card's name and
            power limit from nvidia-smi
  golden    staged float32 chains on full 240-line fields (gen-2 at 720
            and 1888 wide, gen-1 at 720) vs golden/ref_scalar.py with noise
            off (composite defaults, VHS SP, VHS EP with the reference's
            head-switching point): at most 1 LSB on at most 0.5% of
            samples (the tolerance of tests/test_yiq_engine)
  sd / hd   compile time and steady device time per field of the VHS-EP
            chains at the 480i GOP shape and the 1080i field raster
  cli-gen1  `to-composite -vhs -vhs-speed ep` with linear VHS audio on a
            120-frame 480i clip through the CLI entry point; the first GOP
            and the audio vs the same command in a CPU child
  cli-gen2  `ntsc` on the same clip, checked the same way
  daemon    `serve` in a thread of this process, `-via` clients for both
            engines; answers equal the one-shot outputs, repeats are
            byte-identical
  audio     VHS linear audio and cassette chains, 1 s of 44.1 kHz stereo,
            hiss off, vs the scalar references: at most 1 LSB
  raw28     `raw28ntsc` on a synthetic 8xfsc capture vs a CPU child

Cross-backend comparisons allow CROSS_BACKEND_LSB: chroma phase noise
feeds sin/cos, whose last bits differ between XLA's CPU and GPU backends.

Any failure raises and exits non-zero. On success the last line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}} and
the line before it is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

PLATFORM = "gpu"
GOLDEN_LSB, GOLDEN_FRAC = 1, 0.005   # tests/test_yiq_engine.py tolerance
AUDIO_LSB = 1                        # tests/test_audio.py, hiss off
CROSS_BACKEND_LSB = 4

# sizes: module constants so a CPU rehearsal can shrink them
CLIP_FRAMES = 120            # 240 fields = 3.75 GOPs of 64
CLIP_W, CLIP_H = 720, 480    # the CLI's default 480i raster
GOP = 64                     # host/pipeline.py and pipeline_yiq.py default
GOLDEN_LINES = 240          # a whole 480i field: the head-switching bar
                            # sits near its bottom
GOLDEN_WIDTHS_GEN2 = (720, 1888)
GOLDEN_WIDTHS_GEN1 = (720,)
SD_SHAPE = (64, 240, 720)    # one GOP of 480i fields
HD_SHAPE = (8, 540, 1888)    # 1080i field raster
AUDIO_SECONDS = 1.0
RAW28_FIELDS = 6
TIMING_REPS = 10


class SmokeFailure(RuntimeError):
    pass


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU checks (-devices 4 for both "
                         "engines, line-sharded 1080i frame)")
    return ap.parse_args(argv)


def phase_names(args) -> list[str]:
    if args.four:
        return ["device", "four"]
    return ["device", "golden", "sd", "hd", "cli-gen1", "cli-gen2",
            "daemon", "audio", "raw28"]


def diff_stats(got, want) -> tuple[int, float]:
    """(max abs difference, share of elements that differ)."""
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    if got.shape != want.shape:
        raise SmokeFailure(f"shape {got.shape} != {want.shape}")
    if not got.size:
        return 0, 0.0
    d = np.abs(got - want)
    return int(d.max()), float((d > 0).mean())


def check_within(what, got, want, max_lsb, max_frac=1.0):
    """diff_stats, raising SmokeFailure beyond (max_lsb, max_frac)."""
    mx, frac = diff_stats(got, want)
    if mx > max_lsb or frac > max_frac:
        raise SmokeFailure(f"{what}: max diff {mx} LSB on {frac:.4%} of "
                           f"samples (allowed {max_lsb} LSB on "
                           f"{max_frac:.2%})")
    return mx, frac


def say(phase, msg):
    print(f"{phase}: {msg}", flush=True)


# --------------------------------------------------------------- inputs

def write_clip(path, frames, w=CLIP_W, h=CLIP_H, seed=0):
    """Seeded 4:2:0 Y4M: smooth gradients with moving bars and a little
    grain, so every stage has edges, flat areas and chroma to work on."""
    from fractions import Fraction

    from cvsim_tpu.host import y4m

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    with open(path, "wb") as f:
        wr = y4m.Y4MWriter(f, y4m.Y4MHeader(
            width=w, height=h, fps=Fraction(30000, 1001)))
        for k in range(frames):
            y = 16 + (xx * 200 // w + yy * 19 // h) % 220
            y = np.where(((xx + 6 * k) // 48) % 5 == 0, 235, y)
            y = np.clip(y + rng.integers(-6, 7, (h, w)), 16, 235)
            u = 128 + (96 * np.sin(cx / 37.0 + k / 9.0)).astype(np.int64)
            v = 128 + (96 * np.cos(cy / 23.0 - k / 7.0)).astype(np.int64)
            wr.write(y.astype(np.uint8), u.astype(np.uint8),
                     v.astype(np.uint8))


def write_wav(path, seconds, rate=44100, seed=1):
    from cvsim_tpu.host import wavio

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate))[:, None]
    sig = (8000 * np.sin(2 * np.pi * 440 * t / rate)
           + 4000 * np.sin(2 * np.pi * 3000 * t / rate + np.arange(2))
           + rng.normal(0, 800, size=(len(t), 2)))
    wavio.write_wav(path, np.clip(sig, -32768, 32767).astype(np.int16), rate)


def write_raw28(path, fields=RAW28_FIELDS):
    """Synthetic 8-bit 8xfsc capture: per field 12 serration pulses, then
    262 lines of hsync + a luma ramp (as tests/test_raw28.py)."""
    from cvsim_tpu.models.raw28 import RawTiming, rate_preset

    rl = RawTiming(rate_preset("ntsc28")).raw_length
    sync, blank, white = 10, 70, 230
    hsync = int(rl * 0.09)
    out = []
    for f in range(fields):
        for _ in range(12):
            half = np.full(rl // 2, blank, np.uint8)
            half[: int(rl * 0.05)] = sync
            out.append(half)
        for line in range(262):
            row = np.full(rl, blank, np.uint8)
            row[:hsync] = sync
            a0 = hsync + int(rl * 0.06)
            n = rl - a0 - 8
            top = white - (line * 3 + f * 11) % 90
            row[a0:a0 + n] = np.linspace(blank + 10, top, n).astype(np.uint8)
            out.append(row)
    np.concatenate(out).tofile(path)


def read_y4m(path):
    from cvsim_tpu.host import y4m

    with open(path, "rb") as f:
        r = y4m.Y4MReader(f)
        return r.header, [np.concatenate([p.reshape(-1) for p in fr])
                          for fr in r]


def read_wav(path):
    from cvsim_tpu.host import wavio

    return wavio.read_wav(path)[0]


def cpu_child(argv, tag, workdir):
    """Start `python -m cvsim_tpu <argv>` on the CPU backend; returns a
    handle for wait_child."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    log = open(os.path.join(workdir, f"{tag}.cpu.log"), "w")
    proc = subprocess.Popen([sys.executable, "-m", "cvsim_tpu"] + argv,
                            cwd=REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    return proc, log, time.perf_counter()


def wait_child(handle, tag):
    proc, log, t0 = handle
    try:
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if rc != 0:
        with open(log.name) as f:
            tail = f.read()[-3000:]
        raise SmokeFailure(f"{tag}: CPU reference child rc={rc}\n{tail}")
    return time.perf_counter() - t0


def golden_configs():
    from cvsim_tpu.config import CompositeConfig, VHSSpeed

    off = dict(video_noise=0, video_chroma_noise=0,
               video_chroma_phase_noise=0, video_chroma_loss=0)
    return {
        "composite": CompositeConfig(**off),
        "vhs-sp": CompositeConfig(emulating_vhs=True, **off),
        "vhs-ep-headswitch": CompositeConfig(
            emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP,
            vhs_head_switching=True, vhs_head_switching_phase_noise=0.0,
            **off),
    }


def golden_inputs(engine, w):
    rng = np.random.default_rng(w + (engine == "gen1"))
    l = GOLDEN_LINES
    if engine == "gen2":
        return (rng.integers(0, 256, (2, l, w, 3)),)
    return (rng.integers(16, 236, (2, l, w)),
            rng.integers(16, 241, (2, l, w // 2)),
            rng.integers(16, 241, (2, l, w // 2)))


def golden_scalar(engine, name, w):
    """Scalar-oracle output for fields 4 and 5 (parity 0, 1): a
    process-pool job, so the slow Python loops overlap the GPU phases."""
    import golden.ref_scalar as ref

    cfg = golden_configs()[name]
    planes = golden_inputs(engine, w)
    if engine == "gen2":
        return np.stack([ref.composite_layer_scalar(planes[0][k], cfg, 4 + k,
                                                    k) for k in range(2)])
    outs = [ref.composite_video_process_scalar(
        planes[0][k], planes[1][k], planes[2][k], cfg, 4 + k, k)
        for k in range(2)]
    return [np.stack([o[i] for o in outs]) for i in range(3)]


def golden_jobs():
    return ([("gen2", n, w) for w in GOLDEN_WIDTHS_GEN2
             for n in golden_configs()]
            + [("gen1", n, w) for w in GOLDEN_WIDTHS_GEN1
               for n in golden_configs()])


# --------------------------------------------------------------- timing

def compile_and_time(fn, *args, reps=TIMING_REPS):
    """(compiled, compile seconds, median steady seconds per call), each
    call ending in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return compiled, compile_s, float(np.median(times))


# --------------------------------------------------------------- phases

class Smoke:
    def __init__(self, args, workdir):
        self.args = args
        self.dir = workdir
        self.children = {}
        self.golden_refs = {}
        self.pool = None
        self.summary = None

    def path(self, name):
        return os.path.join(self.dir, name)

    # ------------------------------------------------------------ device
    def device(self):
        import jax

        from cvsim_tpu.utils import devinfo

        need = 4 if self.args.four else 1
        try:
            self.summary = devinfo.require_platform(PLATFORM, need)
        except RuntimeError as e:
            raise SmokeFailure(f"device: {e}") from None
        self.card = devinfo.gpu_card_info() if PLATFORM == "gpu" else []
        say("device", f"platform={self.summary['platform']} "
            f"kind={self.summary['kind']} count={self.summary['count']} "
            f"jax={jax.__version__}")
        for line in self.card:
            say("device", f"card {line}")

    # ------------------------------------------------------------ golden
    def golden(self):
        import jax
        import jax.numpy as jnp

        from cvsim_tpu.models import yiq, yuv422

        fno = jnp.array([4, 5], jnp.int32)
        par = jnp.array([0, 1], jnp.int32)
        key = jax.random.PRNGKey(0)
        cfgs = golden_configs()
        for job in golden_jobs():
            engine, name, w = job
            planes = [jnp.asarray(p, jnp.int32)
                      for p in golden_inputs(engine, w)]
            t0 = time.perf_counter()
            if engine == "gen2":
                got = [yiq.composite_layer_rgb(*planes, fno, par, key,
                                               cfg=cfgs[name])]
            else:
                got = yuv422.composite_video_process_jit(
                    *planes, fno, par, key, cfg=cfgs[name])
            got = [np.asarray(g) for g in got]
            dev_s = time.perf_counter() - t0
            want = self.golden_refs.pop(job).result()
            want = [want] if engine == "gen2" else want
            worst = max(check_within(f"golden {engine} w={w} {name}", g, wt,
                                     GOLDEN_LSB, GOLDEN_FRAC)
                        for g, wt in zip(got, want))
            say("golden", f"{engine} {GOLDEN_LINES}x{w} {name}: max "
                f"{worst[0]} LSB, {worst[1]:.4%} differ (compile+run "
                f"{dev_s:.2f}s)")

    # ------------------------------------------------------------ timing
    def _ep_cfg(self):
        from cvsim_tpu.config import CompositeConfig, VHSSpeed

        return CompositeConfig(
            emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP,
            vhs_head_switching=True, video_noise=6, video_chroma_noise=22,
            video_chroma_phase_noise=6, video_chroma_loss=8)

    def _time_gen2(self, tag, b, l, w):
        import jax
        import jax.numpy as jnp

        from cvsim_tpu.models import yiq

        cfg = self._ep_cfg()
        rgb = jnp.asarray(np.random.default_rng(b).integers(
            0, 256, (b, l, w, 3), dtype=np.uint8))
        fno = jnp.arange(b, dtype=jnp.int32)

        def fn(rgb, fno):
            return yiq.composite_layer_rgb(rgb, fno, fno & 1,
                                           jax.random.PRNGKey(7), cfg=cfg)

        compiled, c_s, step_s = compile_and_time(fn, rgb, fno)
        out = np.asarray(compiled(rgb, fno))
        if out.shape != (b, l, w, 3):
            raise SmokeFailure(f"{tag}: output shape {out.shape}")
        say(tag, f"gen2 vhs-ep B={b} {l}x{w}: compile {c_s:.2f}s, device "
            f"{step_s * 1e6 / b:.1f} us/field ({step_s * 1e3:.2f} ms/batch)")
        return compiled

    def sd(self):
        import jax
        import jax.numpy as jnp

        from cvsim_tpu.models import yuv422

        b, l, w = SD_SHAPE
        self._time_gen2("sd", b, l, w)
        cfg = self._ep_cfg()
        rng = np.random.default_rng(3)
        y = jnp.asarray(rng.integers(16, 236, (b, l, w)), jnp.int32)
        u = jnp.asarray(rng.integers(16, 241, (b, l, w // 2)), jnp.int32)
        v = jnp.asarray(rng.integers(16, 241, (b, l, w // 2)), jnp.int32)
        fno = jnp.arange(b, dtype=jnp.int32)

        def fn(y, u, v, fno):
            return yuv422.composite_video_process(
                y, u, v, cfg=cfg, fieldno=fno, field_parity=fno & 1,
                key=jax.random.PRNGKey(7))

        _, c_s, step_s = compile_and_time(fn, y, u, v, fno)
        say("sd", f"gen1 vhs-ep B={b} {l}x{w}: compile {c_s:.2f}s, device "
            f"{step_s * 1e6 / b:.1f} us/field ({step_s * 1e3:.2f} ms/batch)")

    def hd(self):
        b, l, w = HD_SHAPE
        compiled = self._time_gen2("hd", b, l, w)
        ma = compiled.memory_analysis()
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
        say("hd", "memory_analysis " + " ".join(
            f"{k.replace('_size_in_bytes', '')}={getattr(ma, k, None)}"
            for k in fields))

    # ------------------------------------------------------------ CLIs
    def _inputs(self):
        if getattr(self, "_clip", None):
            return
        self._clip = self.path("clip.y4m")
        self._clip_gop = self.path("clip_gop.y4m")
        self._wav = self.path("clip.wav")
        write_clip(self._clip, CLIP_FRAMES)
        write_clip(self._clip_gop, GOP // 2)   # the first GOP's frames
        write_wav(self._wav, CLIP_FRAMES * 1001 / 30000)

    def _argv(self, tool, clip, out, audio_out=None):
        argv = [tool, "-i", clip, "-o", out, "-vhs", "-vhs-speed", "ep",
                "-seed", "3"]
        if audio_out:
            argv += ["-vhs-hifi", "0", "-audio-in", self._wav,
                     "-audio-out", audio_out]
        return argv

    def start_cpu_children(self):
        """CPU references for the golden, CLI and raw28 phases, started
        early so they run while this process works on the GPU."""
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=4, mp_context=multiprocessing.get_context("spawn"))
        self.golden_refs = {job: self.pool.submit(golden_scalar, *job)
                            for job in golden_jobs()}
        self._inputs()
        for tag, tool in (("cli-gen1", "to-composite"), ("cli-gen2", "ntsc")):
            self.children[tag] = cpu_child(
                self._argv(tool, self._clip_gop, self.path(f"{tag}.cpu.y4m"),
                           self.path(f"{tag}.cpu.wav")), tag, self.dir)
        self._raw = self.path("capture.raw")
        write_raw28(self._raw)
        self.children["raw28"] = cpu_child(
            ["raw28ntsc", "-i", self._raw, "-o", self.path("raw28.cpu.y4m")],
            "raw28", self.dir)

    def _run_cli(self, argv):
        from cvsim_tpu.cli.main import main

        t0 = time.perf_counter()
        rc = main(argv)
        if rc != 0:
            raise SmokeFailure(f"cvsim {' '.join(argv)}: rc={rc}")
        return time.perf_counter() - t0

    def _cli(self, tag, tool):
        self._inputs()
        out, wav = self.path(f"{tag}.y4m"), self.path(f"{tag}.wav")
        wall = self._run_cli(self._argv(tool, self._clip, out, wav))
        hdr, frames = read_y4m(out)
        fields = 2 * CLIP_FRAMES
        if len(frames) != fields or (hdr.width, hdr.height) != (CLIP_W,
                                                                 CLIP_H):
            raise SmokeFailure(f"{tag}: {len(frames)} frames of "
                               f"{hdr.width}x{hdr.height}, want {fields} of "
                               f"{CLIP_W}x{CLIP_H}")
        audio = read_wav(wav)
        cpu_s = wait_child(self.children.pop(tag), tag)
        _, cpu_frames = read_y4m(self.path(f"{tag}.cpu.y4m"))
        if len(cpu_frames) != GOP:
            raise SmokeFailure(f"{tag}: CPU child wrote {len(cpu_frames)} "
                               f"frames, want {GOP}")
        vmx, vfrac = check_within(f"{tag} first GOP vs CPU", frames[:GOP],
                                  cpu_frames, CROSS_BACKEND_LSB)
        cpu_audio = read_wav(self.path(f"{tag}.cpu.wav"))
        amx, afrac = check_within(f"{tag} audio vs CPU", audio, cpu_audio,
                                  CROSS_BACKEND_LSB)
        say(tag, f"{len(frames)} frames {CLIP_W}x{CLIP_H} + "
            f"{len(audio)} audio samples in {wall:.2f}s wall "
            f"({fields / wall:.1f} fields/s incl. compile); first GOP vs CPU "
            f"max {vmx} LSB, {vfrac:.4%} bytes differ; audio vs CPU max "
            f"{amx} LSB, {afrac:.4%} differ (CPU child {cpu_s:.1f}s)")

    def cli_gen1(self):
        self._cli("cli-gen1", "to-composite")

    def cli_gen2(self):
        self._cli("cli-gen2", "ntsc")

    # ------------------------------------------------------------ daemon
    def daemon(self):
        from cvsim_tpu.cli.serve import run_serve

        self._inputs()
        sock = self.path("cvsim.sock")
        rcs = []
        srv = threading.Thread(
            target=lambda: rcs.append(run_serve(["-socket", sock])),
            name="smoke-serve", daemon=True)
        srv.start()
        for _ in range(600):
            if os.path.exists(sock) or not srv.is_alive():
                break
            time.sleep(0.05)
        if not os.path.exists(sock):
            raise SmokeFailure(f"daemon: no socket (server rc {rcs})")
        outs = {}
        for tag, tool, rep in (("gen1", "to-composite", 0),
                               ("gen2", "ntsc", 0),
                               ("gen1", "to-composite", 1)):
            out = self.path(f"daemon-{tag}-{rep}.y4m")
            wav = self.path(f"daemon-{tag}-{rep}.wav")
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-S", "-m", "cvsim_tpu", "-via", sock]
                + self._argv(tool, self._clip, out, wav),
                cwd=REPO, capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            if r.returncode != 0:
                raise SmokeFailure(f"daemon {tag}: rc={r.returncode}\n"
                                   f"{r.stderr[-3000:]}")
            with open(out, "rb") as f:
                outs[(tag, rep)] = f.read()
            _, frames = read_y4m(out)
            _, one_shot = read_y4m(self.path(f"cli-{tag}.y4m"))
            mx, frac = check_within(f"daemon {tag} vs one-shot", frames,
                                    one_shot, CROSS_BACKEND_LSB)
            say("daemon", f"{tag} request {rep}: {len(frames)} frames in "
                f"{wall:.2f}s ({2 * CLIP_FRAMES / wall:.1f} fields/s); vs "
                f"one-shot max {mx} LSB, {frac:.4%} bytes differ")
        if outs[("gen1", 0)] != outs[("gen1", 1)]:
            raise SmokeFailure("daemon: repeated gen1 request not "
                               "byte-identical")
        say("daemon", "repeated request byte-identical")

    # ------------------------------------------------------------ audio
    def audio(self):
        import jax
        import jax.numpy as jnp

        import golden.ref_scalar as ref
        from cvsim_tpu.audio import (buzz_pulse_counts,
                                     composite_audio_process,
                                     init_audio_state)
        from cvsim_tpu.audio.cassette import (CassetteConfig,
                                              cassette_audio_process,
                                              init_cassette_state)
        from cvsim_tpu.config import AudioConfig

        n = int(AUDIO_SECONDS * 44100)
        rng = np.random.default_rng(2)
        t = np.arange(n)[:, None]
        x = np.clip(8000 * np.sin(2 * np.pi * 440 * t / 44100)
                    + 4000 * np.sin(2 * np.pi * 3000 * t / 44100
                                    + np.arange(2))
                    + rng.normal(0, 800, (n, 2)),
                    -32768, 32767).astype(np.int64)
        xd = jnp.asarray(x, jnp.int32)
        key = jax.random.PRNGKey(0)

        cfg = AudioConfig(hiss_db=-1000.0, vhs_hifi=False,
                          vhs_linear_audio=True, preemphasis_cut_hz=8000.0)
        pulses = jnp.asarray(buzz_pulse_counts(cfg, 0, n))

        def vhs(x, pulses):
            return composite_audio_process(
                x, init_audio_state(cfg), key, cfg=cfg, pulses=pulses)[0]

        c, c_s, step_s = compile_and_time(vhs, xd, pulses)
        got = np.asarray(c(xd, pulses))
        want = ref.audio_chain_scalar(
            x, cfg.rate, 2, cfg.lowpass_hz, cfg.highpass_hz,
            preemph=cfg.emulating_preemphasis,
            deemph=cfg.emulating_deemphasis, pre_cut=cfg.preemphasis_cut_hz,
            vhs_hifi=False, buzz_db=cfg.linear_buzz_db,
            high_boost=cfg.linear_high_boost, ntsc=cfg.ntsc)
        mx, frac = check_within("audio vhs-linear", got, want, AUDIO_LSB)
        say("audio", f"vhs linear {n} samples x2: max {mx} LSB, {frac:.4%} "
            f"differ; compile {c_s:.2f}s, device {step_s * 1e3:.2f} ms "
            f"({n / 44100 / step_s:.0f}x realtime)")

        cc = CassetteConfig(hiss_db=-1000.0)

        def cassette(x):
            return cassette_audio_process(
                x, init_cassette_state(cc), key, cfg=cc)[0]

        c, c_s, step_s = compile_and_time(cassette, xd)
        got = np.asarray(c(xd))
        want = ref.cassette_chain_scalar(
            x, cc.rate, 2, cc.lowpass_hz, cc.highpass_hz,
            head_tilt=cc.head_tilt, head_tilt_waver=cc.head_tilt_waver,
            pre_cut=cc.preemphasis_cut_hz)
        mx, frac = check_within("audio cassette", got, want, AUDIO_LSB)
        say("audio", f"cassette {n} samples x2: max {mx} LSB, {frac:.4%} "
            f"differ; compile {c_s:.2f}s, device {step_s * 1e3:.2f} ms "
            f"({n / 44100 / step_s:.0f}x realtime)")

    # ------------------------------------------------------------ raw28
    def raw28(self):
        out = self.path("raw28.y4m")
        wall = self._run_cli(["raw28ntsc", "-i", self._raw, "-o", out])
        hdr, frames = read_y4m(out)
        cpu_s = wait_child(self.children.pop("raw28"), "raw28")
        _, cpu_frames = read_y4m(self.path("raw28.cpu.y4m"))
        if not frames or len(frames) != len(cpu_frames):
            raise SmokeFailure(f"raw28: {len(frames)} fields decoded, CPU "
                               f"child {len(cpu_frames)}")
        mx, frac = check_within("raw28 vs CPU", frames, cpu_frames,
                                CROSS_BACKEND_LSB)
        say("raw28", f"{len(frames)} fields {hdr.width}x{hdr.height} in "
            f"{wall:.2f}s; vs CPU max {mx} LSB, {frac:.4%} bytes differ "
            f"(CPU child {cpu_s:.1f}s)")

    # ------------------------------------------------------------ four
    def four(self):
        import jax
        import jax.numpy as jnp

        from cvsim_tpu.models import yiq
        from cvsim_tpu.parallel.mesh import make_mesh, run_sharded_chain

        self._inputs()
        for tool in ("to-composite", "ntsc"):
            outs = {}
            for n in (1, 4):
                out = self.path(f"four-{tool}-{n}.y4m")
                argv = self._argv(tool, self._clip, out)
                if n == 4:
                    argv += ["-devices", "4"]
                wall = self._run_cli(argv)
                _, outs[n] = read_y4m(out)
                say("four", f"{tool} -devices {n}: {len(outs[n])} frames in "
                    f"{wall:.2f}s ({2 * CLIP_FRAMES / wall:.1f} fields/s "
                    "incl. compile)")
            mx, frac = check_within(f"four {tool} 4 vs 1 device", outs[4],
                                    outs[1], GOLDEN_LSB, GOLDEN_FRAC)
            say("four", f"{tool} -devices 4 vs 1: max {mx} LSB, {frac:.4%} "
                "bytes differ")

        b, l, w = 2, HD_SHAPE[1], HD_SHAPE[2]
        cfg = self._ep_cfg()
        rgb = np.random.default_rng(5).integers(0, 256, (b, l, w, 3),
                                                dtype=np.uint8)
        fno = np.arange(b, dtype=np.int32)
        key = jax.random.PRNGKey(7)
        mesh = make_mesh(4, dp=1)
        t0 = time.perf_counter()
        sharded = np.asarray(run_sharded_chain(mesh, cfg, rgb, fno, fno & 1,
                                               key))
        t_sh = time.perf_counter() - t0
        t0 = time.perf_counter()
        single = np.asarray(yiq.composite_layer_rgb(
            jnp.asarray(rgb), jnp.asarray(fno), jnp.asarray(fno & 1), key,
            cfg=cfg))
        t_one = time.perf_counter() - t0
        mx, frac = check_within("four run_sharded_chain 4 vs 1 device",
                                sharded, single, GOLDEN_LSB, GOLDEN_FRAC)
        say("four", f"run_sharded_chain 1080i frame (2x{l}x{w}) lines over "
            f"4 devices vs 1: max {mx} LSB, {frac:.4%} bytes differ "
            f"(compile+run {t_sh:.2f}s sharded, {t_one:.2f}s single)")


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    from cvsim_tpu.cli.main import enable_compile_cache

    enable_compile_cache()
    with tempfile.TemporaryDirectory(prefix="cvsim_smoke_") as workdir:
        smoke = Smoke(args, workdir)
        try:
            for name in phase_names(args):
                if name == "golden":
                    smoke.start_cpu_children()
                t0 = time.perf_counter()
                getattr(smoke, name.replace("-", "_"))()
                say(name, f"passed in {time.perf_counter() - t0:.2f}s")
        finally:
            for proc, log, _ in smoke.children.values():
                proc.kill()
                proc.wait()
                log.close()
            if smoke.pool is not None:
                smoke.pool.shutdown(cancel_futures=True)
    for line in smoke.card:
        print(line)
    print(json.dumps({"ok": True, "device": smoke.summary}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
