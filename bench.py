#!/usr/bin/env python
"""Benchmark rows for cvsim on one GPU.

Device rows: the gen-2 VHS-EP chain at 480i (headline), gen-1, the
composite-only / broadcast / EP 2-generation-dub configs, gen-2 at the
1080i field raster, and the VHS audio chain. End-to-end rows: the
`to-composite` CLI one-shot and through a warm `serve` daemon, posterize,
and the restore tools against the reference binaries where those build.

Prints one JSON line at the end. Every result names the device it ran on
(platform, device_kind, count) and, on NVIDIA cards, the card's name and
power limit. A row or section that fails raises: the run exits non-zero
and prints no result. The device rows run in a child (`--device-inner`)
so the e2e rows' CLI processes and daemon, which open the GPU themselves,
never share it with a live JAX process. `--device` / `--e2e` select one
section.

vs_baseline = device fields/s over the single-thread scalar C++ baseline
(cvsim_tpu/native/scalar_baseline.cpp, the reference's per-field cost
class) on this host.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

W, LINES = 704, 240          # 480i field
BATCH = 256                  # fields per device call (~4.3s of video)
REPS = 5


def _rep_stats(vals) -> dict:
    """{median, min, max, reps} for a list of per-rep measurements: every
    row reports the median with the spread next to it."""
    s = sorted(float(v) for v in vals)
    n = len(s)
    med = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    return {"median": round(med, 2), "min": round(s[0], 2),
            "max": round(s[-1], 2), "reps": n}


def _put(result: dict, key: str, stats: dict) -> None:
    result[key] = stats["median"]
    result[key + "_stats"] = stats


def _scan_rate(tag: str, chain_scalar, datas, n_fields_iter: int,
               keys_for_rep, *, n_vary: int = 1, K: int = 32,
               reps: int = REPS) -> dict:
    """Device throughput of one chain iteration: K iterations run inside
    ONE program via lax.scan, so per-dispatch cost is paid once per rep.
      * the first n_vary pixel inputs are XORed with the iteration index
        inside the scan body, so XLA cannot hoist the input prep out of
        the loop (the XOR pass itself stays in the measured time);
      * keys change per iteration and per rep;
      * the output reduces to one f32 scalar, fetched to end the timing.
    chain_scalar(*datas, key) must reduce its output to a f32 scalar."""
    import jax
    import jax.numpy as jnp

    def prog(*args):
        ds, ks, js = args[:-2], args[-2], args[-1]

        def body(carry, kj):
            k, j = kj
            varied = tuple(d ^ j if i < n_vary else d
                           for i, d in enumerate(ds))
            return carry + chain_scalar(*varied, k), 0

        s, _ = jax.lax.scan(body, jnp.float32(0), (ks, js))
        return s

    js = jnp.arange(K, dtype=jnp.int32)
    ks0 = keys_for_rep(0)
    t0 = time.time()
    c = jax.jit(prog).lower(*datas, ks0, js).compile()
    compile_s = time.time() - t0
    t0 = time.time()
    float(c(*datas, ks0, js))
    first_s = time.time() - t0
    print(f"[bench] {tag}: compile {compile_s:.1f}s, "
          f"first run+fetch {first_s:.1f}s", file=sys.stderr)
    vals = []
    for r in range(reps):
        ks = keys_for_rep(r)
        t0 = time.time()
        float(c(*datas, ks, js))
        dt = time.time() - t0
        vals.append(K * n_fields_iter / dt)
        print(f"[bench] {tag} rep {r}: {dt*1e3:.1f}ms for "
              f"{K}x{n_fields_iter} fields -> {vals[-1]:.1f} fields/s",
              file=sys.stderr)
    st = _rep_stats(vals)
    st["k_iters"] = K
    st["compile_s"] = round(compile_s, 1)
    st["first_run_s"] = round(first_s, 1)
    print(f"[bench] {tag}: {st['median']:.1f} fields/s median "
          f"[{st['min']:.1f}..{st['max']:.1f}] over {len(vals)} reps",
          file=sys.stderr)
    return st


def baseline_fields_per_sec(config: str = "ep") -> float:
    """Single-thread scalar C++ cost class for a BASELINE.json golden config:
    ep (3), composite (1), broadcast (2), dub2 (4)."""
    from cvsim_tpu.native import ensure_built

    exe = ensure_built(
        os.path.join(REPO, ".bench_scalar_baseline"),
        [os.path.join(REPO, "cvsim_tpu", "native", "scalar_baseline.cpp")],
        ["-O2"])
    # BEST of 3 runs: a loaded host deflates the scalar baseline, which
    # would inflate vs_baseline. Give the reference cost class its best
    # shot; our own device rows stay medians.
    runs = []
    for _ in range(3):
        out = subprocess.run([exe, "60", str(W), str(LINES), config],
                             capture_output=True, text=True, check=True)
        runs.append(float(json.loads(out.stdout.strip())["fields_per_sec"]))
    fps = max(runs)
    print(f"[bench] scalar C++ baseline [{config}]: {fps:.1f} fields/s "
          f"({fps/59.94:.2f}x realtime; runs {[round(r,1) for r in runs]})",
          file=sys.stderr)
    return fps


def hd1080i_fields_per_sec() -> dict:
    """Gen-2 chain at the 1080i stretch raster (1888x540 fields), B=64."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from cvsim_tpu.config import CompositeConfig
    from cvsim_tpu.models import yiq

    W_HD, L_HD, B_HD = 1888, 540, 64
    cfg = CompositeConfig(emulating_vhs=True, vhs_head_switching=True,
                          video_noise=4, video_chroma_noise=16,
                          video_chroma_phase_noise=4, video_chroma_loss=4)
    rng = np.random.default_rng(0)
    rgb = jnp.asarray(rng.integers(0, 255, (B_HD, L_HD, W_HD, 3),
                                   dtype=np.uint8), jnp.int32)
    fieldno = jnp.arange(B_HD, dtype=jnp.int32)
    par = fieldno & 1
    key = jax.random.PRNGKey(7)

    def chain(rgb, fno, par, k):
        out = yiq.composite_layer_rgb(rgb, fno, par, k, cfg=cfg)
        return out.astype(jnp.float32).sum()

    st = _scan_rate(
        "1080i gen-2", chain, (rgb, fieldno, par), B_HD,
        lambda r: jax.random.split(jax.random.PRNGKey(100 + r), 16),
        n_vary=1, K=16)
    print(f"[bench] 1080i: {1e9/st['median']/(L_HD*W_HD):.2f} ns/px",
          file=sys.stderr)
    return st


def _gen2_config_row(tag: str, cfg, seed: int, reps: int = 5,
                     dub2: bool = False) -> dict:
    """Shared measurement for a gen-2 480i config row.
    dub2 applies the chain TWICE in one program (generation 2 re-records
    generation 1's output — the re-encode pass of BASELINE.json config 4;
    yc-recomb cost class ffmpeg_to_composite.cpp:943-946)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from cvsim_tpu.models import yiq

    rng = np.random.default_rng(seed)
    rgb = jnp.asarray(rng.integers(0, 256, size=(BATCH, LINES, W, 3)),
                      jnp.int32)
    fieldno = jnp.arange(BATCH, dtype=jnp.int32)
    par = fieldno & 1

    def chain(rgb, fno, par, k):
        out = yiq.composite_layer_rgb(rgb, fno, par, k, cfg=cfg)
        if dub2:
            k2 = jax.random.fold_in(k, 1)
            out = yiq.composite_layer_rgb(
                out.astype(jnp.int32), fno, par, k2, cfg=cfg)
        return out.astype(jnp.float32).sum()

    return _scan_rate(
        f"{tag} 480i", chain, (rgb, fieldno, par), BATCH,
        lambda r: jax.random.split(jax.random.PRNGKey(seed + 50 + r), 32),
        n_vary=1, K=32, reps=reps)


def composite_fields_per_sec() -> dict:
    """Golden config 1 (BASELINE.json): plain composite emulation (QAM
    encode/decode + in/out chroma lowpass, no VHS, no noise) at 480i,
    gen-2 chain, B=256."""
    from cvsim_tpu.config import CompositeConfig

    return _gen2_config_row("composite-only", CompositeConfig(), 5)


def broadcast_fields_per_sec() -> dict:
    """Golden config 2: composite + luma noise + chroma AM
    noise + chroma phase noise (the "broadcast look"), no VHS. Same
    magnitudes as native/scalar_baseline.cpp process_field_broadcast so
    vs_baseline_broadcast compares identical stage sets."""
    from cvsim_tpu.config import CompositeConfig

    cfg = CompositeConfig(video_noise=6, video_chroma_noise=22,
                          video_chroma_phase_noise=6)
    return _gen2_config_row("broadcast", cfg, 11)


def dub2_fields_per_sec() -> dict:
    """Golden config 4: 2-generation VHS EP dub — the full EP
    chain applied twice in one device program (the re-encode pass)."""
    from cvsim_tpu.config import CompositeConfig, VHSSpeed

    cfg = CompositeConfig(
        emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP,
        vhs_head_switching=True, video_noise=6, video_chroma_noise=22,
        video_chroma_phase_noise=6, video_chroma_loss=8)
    return _gen2_config_row("vhs-ep-dub2", cfg, 13, dub2=True)


def gen1_fields_per_sec() -> dict:
    """Gen-1 (ffmpeg_to_composite, the flagship tool) full VHS-EP chain at
    480i on device: 4:2:2 Y/U/V planes through composite_video_process,
    B=256."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from cvsim_tpu.config import CompositeConfig, VHSSpeed
    from cvsim_tpu.models import yuv422

    cfg = CompositeConfig(
        emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP,
        vhs_head_switching=True, video_noise=6, video_chroma_noise=22,
        video_chroma_phase_noise=6, video_chroma_loss=8)
    rng = np.random.default_rng(3)
    y = jnp.asarray(rng.integers(16, 236, (BATCH, LINES, W)), jnp.int32)
    u = jnp.asarray(rng.integers(16, 241, (BATCH, LINES, W // 2)), jnp.int32)
    v = jnp.asarray(rng.integers(16, 241, (BATCH, LINES, W // 2)), jnp.int32)
    fieldno = jnp.arange(BATCH, dtype=jnp.int32)
    par = fieldno & 1

    def chain(y, u, v, fno, par, k):
        yo, uo, vo = yuv422.composite_video_process(
            y, u, v, cfg=cfg, fieldno=fno, field_parity=par, key=k)
        return (yo.astype(jnp.float32).sum() + uo.astype(jnp.float32).sum()
                + vo.astype(jnp.float32).sum())

    return _scan_rate(
        "gen-1 480i", chain, (y, u, v, fieldno, par), BATCH,
        lambda r: jax.random.split(jax.random.PRNGKey(200 + r), 32),
        n_vary=3, K=32)


def gen2_fields_per_sec() -> dict:
    """Headline row: gen-2 full VHS-EP chain at 480i, B=256."""
    from cvsim_tpu.config import CompositeConfig, VHSSpeed

    cfg = CompositeConfig(
        emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP,
        vhs_head_switching=True, video_noise=6, video_chroma_noise=22,
        video_chroma_phase_noise=6, video_chroma_loss=8)
    return _gen2_config_row("gen-2 vhs-ep headline", cfg, 0)


def audio_realtime_x() -> dict:
    """VHS linear-audio chain (6+6-pass bandpass bank, preemphasis, 16x
    sync buzz, hiss, high boost, deemphasis — the reference's full per-
    sample audio cost, ffmpeg_to_composite.cpp:558-627) at 44.1kHz stereo
    on device. Chunked exactly like CompositePipeline.run_audio (1M
    samples per dispatch, serialized by the carried AudioState). Returns
    the realtime multiple (processed samples/s / 44100)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from cvsim_tpu.audio.chains import (
        buzz_pulse_counts, composite_audio_process, init_audio_state)
    from cvsim_tpu.config import AudioConfig

    acfg = AudioConfig(vhs_hifi=False, vhs_linear_audio=True,
                       preemphasis_cut_hz=8000.0)
    chunk = 1 << 20
    key = jax.random.PRNGKey(1)
    state0 = init_audio_state(acfg)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.integers(-20000, 20000, size=(chunk, 2)), jnp.int32)

    @jax.jit
    def step(x, state, pulses, key):
        out, st = composite_audio_process(
            x, state, key, cfg=acfg, pulses=pulses)
        return out.sum(), st

    pulses = jnp.asarray(buzz_pulse_counts(acfg, 0, chunk))
    compiled = step.lower(x, state0, pulses, key).compile()
    s, st = compiled(x, state0, pulses, key)
    int(s)   # first execution off the clock

    vals = []
    for r in range(5):
        t0 = time.time()
        s, st = compiled(x, st, pulses, key)
        int(s)
        dt = time.time() - t0
        vals.append(chunk / dt / acfg.rate)
        print(f"[bench] audio rep {r}: {dt*1e3:.1f}ms for {chunk} samples "
              f"-> {chunk/dt/acfg.rate:.0f}x realtime", file=sys.stderr)
    return _rep_stats(vals)


def _write_clip(path: str, frames: int) -> None:
    import numpy as np
    from fractions import Fraction

    from cvsim_tpu.host import y4m

    rng = np.random.default_rng(7)
    h = LINES * 2
    with open(path, "wb") as f:
        wr = y4m.Y4MWriter(f, y4m.Y4MHeader(
            width=W, height=h, fps=Fraction(30000, 1001)))
        yp = rng.integers(16, 236, size=(h, W)).astype(np.uint8)
        up = rng.integers(16, 241, size=(h // 2, W // 2)).astype(np.uint8)
        vp = rng.integers(16, 241, size=(h // 2, W // 2)).astype(np.uint8)
        for i in range(frames):
            wr.write(np.roll(yp, i, axis=1), np.roll(up, i // 2, axis=1),
                     np.roll(vp, i // 2, axis=1))


def _parse_phases(stderr_text: str) -> dict:
    """Parse CVSIM_PHASES=1 lines: {name: {"t":..., "proc_age":..., ...}}."""
    out = {}
    for line in stderr_text.splitlines():
        # the CLI's progress printer emits "Output field N " with no
        # newline, so a phase line can land mid-line — find, not startswith
        at = line.find("[phase] ")
        if at < 0:
            continue
        parts = line[at:].split()
        name = parts[1]
        kv = {}
        for p in parts[2:]:
            k, _, v = p.partition("=")
            kv[k] = float(v)
        out[name] = kv
    return out


def e2e_fields_per_sec() -> dict:
    """Wall-clock + per-phase cost of the real CLI tool on a 300-frame clip,
    3 reps. Phases come from inside the process (CVSIM_PHASES=1 stamps):
      startup_s     exec -> run_video entry (interpreter + jax + compile)
      first_fetch_s first dispatch -> first GOP bytes on host
      steady_fields_per_sec  after the first fetch, the streaming rate
    """
    import shutil
    import tempfile

    env = dict(os.environ, CVSIM_PHASES="1")
    tmp = tempfile.mkdtemp(prefix="cvsim_bench_")
    try:
        clip = os.path.join(tmp, "in300.y4m")
        out = os.path.join(tmp, "out300.y4m")
        _write_clip(clip, 300)
        cmd = [sys.executable, "-m", "cvsim_tpu", "to-composite",
               "-i", clip, "-o", out, "-vhs", "-vhs-speed", "ep"]
        runs = {"overall": [], "startup_s": [], "first_fetch_s": [],
                "steady": [], "startup_interp_s": [],
                "startup_jax_import_s": []}
        for rep in range(3):
            t0 = time.time()
            r = subprocess.run(cmd, check=True, cwd=REPO, env=env,
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.PIPE, text=True,
                               timeout=900)
            wall = time.time() - t0
            ph = _parse_phases(r.stderr)
            fields = int(ph["run_video_done"]["fields"])
            first_gop = int(ph["first_fetch_done"]["fields"])
            steady_dt = (ph["run_video_done"]["t"]
                         - ph["first_fetch_done"]["t"])
            runs["overall"].append(fields / wall)
            runs["startup_s"].append(ph["run_video_start"]["proc_age"])
            runs["startup_interp_s"].append(ph["cli_entry"]["proc_age"])
            runs["startup_jax_import_s"].append(
                ph["jax_imported"]["proc_age"])
            runs["first_fetch_s"].append(ph["first_fetch_done"]["t"]
                                         - ph["first_dispatch"]["t"])
            runs["steady"].append((fields - first_gop) / steady_dt
                                  if steady_dt > 0.05 else fields / wall)
            print(f"[bench] e2e CLI rep {rep} ({fields} fields): "
                  f"{wall:.1f}s wall (startup {runs['startup_s'][-1]:.1f}s, "
                  f"first-fetch {runs['first_fetch_s'][-1]:.1f}s, then "
                  f"{runs['steady'][-1]:.1f} fields/s steady)",
                  file=sys.stderr)
        return {k: _rep_stats(v) for k, v in runs.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def posterize_fields_per_sec() -> dict:
    """Sibling-tool e2e: the real `cvsim posterize` CLI on a 120-frame 480i
    clip, wall-clock. Host-numpy cost class — never touches the device
    (reference ffmpeg_posterize.cpp:789-813 runs at decode speed)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="cvsim_bench_post_")
    try:
        clip = os.path.join(tmp, "in120.y4m")
        out = os.path.join(tmp, "out120.y4m")
        _write_clip(clip, 120)
        cmd = [sys.executable, "-m", "cvsim_tpu", "posterize",
               "-i", clip, "-o", out, "-threshhold", "3"]
        vals = []
        for _ in range(3):
            t0 = time.time()
            subprocess.run(cmd, check=True, cwd=REPO,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, timeout=300)
            vals.append(240 / (time.time() - t0))
        st = _rep_stats(vals)
        print(f"[bench] posterize e2e: {st['median']:.1f} fields/s median "
              f"[{st['min']:.1f}..{st['max']:.1f}] (120 frames/run)",
              file=sys.stderr)
        return st
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def ref_binary_rows(result: dict) -> None:
    """Actual-reference-binary baseline anchors: the three modern-API
    reference tools build unmodified against the host's FFmpeg 5.x
    (golden/ref_extract.binary_exe) where the reference tree and the
    FFmpeg dev libraries are present; time each on a 120-frame 480i y4m
    clip next to its cvsim twin, wall-clock one-shot. Host-only (the cvsim
    twins are jax-free native/numpy paths).

    Rates are OUTPUT frames per wall second — frames actually produced and
    encoded, counted by decoding each side's container once. For the 1:1
    tools (vhsled, filmac) that equals input frames; for frameblend the
    two sides do DIFFERENT amounts of work on the same clip: the reference
    drops its ~30-output-frame EOF lookahead tail under FFmpeg 5.x (the
    decoder flush clears pts to NOPTS, tripping the `< -1000` break before
    the buffered tail renders — frameblend.cpp:928-931; pinned in
    tests/test_ref_binary_e2e.py), while cvsim renders the full duration. Normalizing by output
    frames charges each side for the frames it actually encoded;
    {tool}_*_out_frames records the counts so the artifact shows the
    divergence. Keys: {tool}_ref_binary_frames_per_sec /
    {tool}_e2e_frames_per_sec (+ _out_frames each)."""
    import tempfile
    import shutil as _sh

    from golden import ref_extract
    from cvsim_tpu.host import ffmpeg_pipe

    if not (ref_extract.available() and ref_extract.ffmpeg_libs_available()
            and ffmpeg_pipe.have_backend()):
        print("[bench] ref-binary rows skipped (no reference tree / FFmpeg "
              "dev libs / backend)", file=sys.stderr)
        return

    def count_frames(path):
        r, proc = ffmpeg_pipe.open_video_reader(path)
        n = sum(1 for _ in r)
        proc.stdout.close()
        proc.wait()
        return n

    tmp = tempfile.mkdtemp(prefix="cvsim_bench_ref_")
    try:
        clip = os.path.join(tmp, "in120.y4m")
        _write_clip(clip, 120)
        for tool, cvs_args in (
                ("ffmpeg_vhsled", ["vhsled"]),
                ("frameblend", ["frameblend", "-or", "24"]),
                ("filmac", ["filmac"])):
            exe = ref_extract.binary_exe(tool)
            short = tool.replace("ffmpeg_", "")
            ref_walls, cv_walls = [], []
            ref_out = os.path.join(tmp, "ref_out.mkv")
            cv_out = os.path.join(tmp, "cv_out.mkv")
            # -S + explicit sys.path: these tools are jax-free host
            # processes (pinned by tests/test_cli.py); skipping site keeps
            # any site-wide start-up hooks out of the A/B.
            import numpy as _np_mod
            site_dir = os.path.dirname(os.path.dirname(_np_mod.__file__))
            boot = (f"import sys; sys.path[:0] = [{site_dir!r}, {REPO!r}]; "
                    "from cvsim_tpu.cli.main import main; "
                    "sys.exit(main(sys.argv[1:]))")
            # interleave the two sides so machine-load drift hits both
            # equally
            for _ in range(5):
                t0 = time.time()
                subprocess.run(
                    [exe, "-i", clip, "-o", ref_out] + cvs_args[1:],
                    check=True, capture_output=True, timeout=300)
                ref_walls.append(time.time() - t0)
                t0 = time.time()
                subprocess.run(
                    [sys.executable, "-S", "-c", boot] + cvs_args
                    + ["-i", clip, "-o", cv_out],
                    check=True, cwd=REPO, capture_output=True, timeout=300)
                cv_walls.append(time.time() - t0)
            ref_n, cv_n = count_frames(ref_out), count_frames(cv_out)
            rst = _rep_stats([ref_n / w for w in ref_walls])
            cst = _rep_stats([cv_n / w for w in cv_walls])
            _put(result, f"{short}_ref_binary_frames_per_sec", rst)
            _put(result, f"{short}_e2e_frames_per_sec", cst)
            result[f"{short}_ref_binary_out_frames"] = ref_n
            result[f"{short}_e2e_out_frames"] = cv_n
            print(f"[bench] {short}: reference binary "
                  f"{rst['median']:.1f} out-frames/s ({ref_n} frames), "
                  f"cvsim {cst['median']:.1f} ({cv_n} frames) "
                  f"({cst['median']/rst['median']:.2f}x)", file=sys.stderr)
    finally:
        _sh.rmtree(tmp, ignore_errors=True)


def e2e_daemon_fields_per_sec() -> float:
    """Throughput of the 300-frame clip through a WARM `cvsim serve`
    daemon: the resident process pays start-up and compile once. Measures
    the second -via run (the first eats the residual warm-up)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="cvsim_bench_srv_")
    sock = os.path.join(tmp, "cvsim.sock")
    srv = None
    try:
        clip = os.path.join(tmp, "in300.y4m")
        _write_clip(clip, 300)
        srv = subprocess.Popen(
            [sys.executable, "-m", "cvsim_tpu", "serve", "-socket", sock,
             "-prime"],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for _ in range(600):
            if os.path.exists(sock) or srv.poll() is not None:
                break
            time.sleep(0.1)
        if not os.path.exists(sock):
            raise RuntimeError(f"daemon did not start (rc {srv.poll()})")
        rate = 0.0
        for rep in range(2):
            out = os.path.join(tmp, f"out{rep}.y4m")
            t0 = time.time()
            # -S: the -via client is stdlib-only (dispatched in
            # __main__.py before any heavy import), so the row measures
            # the daemon, not the client's interpreter start-up
            subprocess.run(
                [sys.executable, "-S", "-m", "cvsim_tpu", "-via", sock,
                 "to-composite", "-i", clip, "-o", out,
                 "-vhs", "-vhs-speed", "ep"],
                check=True, cwd=REPO, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL, timeout=900)
            dt = time.time() - t0
            rate = 600 / dt
            print(f"[bench] e2e daemon rep {rep}: {dt:.1f}s "
                  f"({rate:.1f} fields/s)", file=sys.stderr)
        return rate
    finally:
        import shutil
        if srv is not None:
            srv.terminate()
            try:
                srv.wait(timeout=10)
            except subprocess.TimeoutExpired:
                srv.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def device_rows() -> dict:
    """Every device row, in this process (the --device-inner child)."""
    from cvsim_tpu.cli.main import enable_compile_cache

    enable_compile_cache()
    return {"device": _device(),
            "gen2_fps": gen2_fields_per_sec(),
            "hd_fps": hd1080i_fields_per_sec(),
            "audio_rt": audio_realtime_x(),
            "gen1_fps": gen1_fields_per_sec(),
            "composite_fps": composite_fields_per_sec(),
            "broadcast_fps": broadcast_fields_per_sec(),
            "dub2_fps": dub2_fields_per_sec()}


def _device() -> dict:
    """The device the rows ran on: JAX's view plus the card's name and
    power limit. Anything but a GPU is an error, not a fallback."""
    from cvsim_tpu.utils import devinfo

    summary = devinfo.require_platform("gpu")
    summary["card"] = devinfo.gpu_card_info()
    return summary


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "both"
    if mode == "--device-inner":
        print(json.dumps(device_rows()), flush=True)
        return
    if mode not in ("both", "--device", "--e2e"):
        raise SystemExit(f"usage: {sys.argv[0]} [--device | --e2e]")
    result = {"metric": "480i_fields_per_sec_full_vhs_ep_chain_1gpu",
              "unit": "fields/s"}
    base_fps = baseline_fields_per_sec()
    if mode in ("both", "--device"):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--device-inner"], cwd=REPO, check=True,
                           stdout=subprocess.PIPE, text=True, timeout=3600)
        dev = json.loads(r.stdout.strip().splitlines()[-1])
        result["device"] = dev["device"]
        fps = dev["gen2_fps"]["median"]
        print(f"[bench] gen-2 480i: {fps:.1f} fields/s median = "
              f"{fps / 59.94:.1f}x realtime; {fps / base_fps:.1f}x the "
              "scalar baseline", file=sys.stderr)
        result["value"] = fps
        result["value_stats"] = dev["gen2_fps"]
        result["vs_baseline"] = round(fps / base_fps, 2)
        for src_key, out_key in (
                ("hd_fps", "hd1080i_fields_per_sec"),
                ("audio_rt", "audio_realtime_x"),
                ("gen1_fps", "gen1_480i_fields_per_sec"),
                ("composite_fps", "composite_480i_fields_per_sec"),
                ("broadcast_fps", "broadcast_480i_fields_per_sec"),
                ("dub2_fps", "vhs_ep_dub2_fields_per_sec")):
            _put(result, out_key, dev[src_key])
        # per-config vs_baseline: each golden config's device median over
        # the scalar C++ baseline running the SAME stage set
        for cfg_name, out_key in (
                ("composite", "composite_480i_fields_per_sec"),
                ("broadcast", "broadcast_480i_fields_per_sec"),
                ("dub2", "vhs_ep_dub2_fields_per_sec")):
            result[f"vs_baseline_{cfg_name}"] = round(
                result[out_key] / baseline_fields_per_sec(cfg_name), 1)
    if mode in ("both", "--e2e"):
        _put(result, "posterize_e2e_fields_per_sec",
             posterize_fields_per_sec())
        ref_binary_rows(result)
        result["e2e_daemon_fields_per_sec"] = round(
            e2e_daemon_fields_per_sec(), 2)
        e2e = e2e_fields_per_sec()
        for k in ("startup_s", "startup_interp_s", "startup_jax_import_s",
                  "first_fetch_s"):
            _put(result, f"e2e_{k}", e2e[k])
        _put(result, "e2e_fields_per_sec", e2e["overall"])
        _put(result, "e2e_steady_fields_per_sec", e2e["steady"])
        if "value" not in result:
            result["metric"] = "480i_e2e_cli_fields_per_sec_full_vhs_ep_1gpu"
            result["value"] = result["e2e_fields_per_sec"]
            result["vs_baseline"] = round(result["value"] / base_fps, 2)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
