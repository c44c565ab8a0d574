"""Streaming pipeline driver: demux -> field clock -> batched device chain ->
pack -> mux (reference L2-L4 orchestration, ffmpeg_to_composite.cpp main
:1957-2340).

Execution model (one dispatch per GOP, three overlapped stages):

- **reader thread**: Y4M demux + PTS/field-clock targeting + GOP batch
  assembly (host/batching.py). Raw uint8 frames plus precomputed row-gather
  indices — no device calls.
- **main thread**: ONE jit dispatch per GOP that does horizontal scale,
  field render (the render_field index math as device gathers), black-key
  feedback scan, the composite chain, and uint8 packing on device; output
  copies start immediately via copy_to_host_async.
- **writer thread**: blocks on D2H, packs bob/interlaced frames with pure
  numpy row gathers, writes Y4M.

The black-key feedback frame (:974-999) is the one genuinely
frame-sequential piece — it runs as a lax.scan over the batch axis with the
filter planes carried across batches on the host side of the jit boundary.
"""

from __future__ import annotations

import io
import queue
import sys
import threading
from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp

import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from cvsim_tpu.config import RunConfig
from cvsim_tpu.host import fieldops, progcache, timing, wavio, y4m
from cvsim_tpu.host.batching import (
    FieldBatcher,
    hscale_consts,
    render_index_tables,
)
from cvsim_tpu.models import yuv422
from cvsim_tpu.audio import (
    buzz_pulse_counts,
    composite_audio_process,
    init_audio_state,
)


def _bkey_scan(y, u, v, fy, fu, fv, level: int, valid):
    """Sequential black-key feedback over the batch axis inside jit.

    `valid` [B] freezes the carried filter planes on padded batch slots —
    padding repeats the last real field, and letting duplicates advance the
    frame-sequential feedback would corrupt every later field (and the
    checkpointed carry) whenever a batch is padded or early-flushed."""
    def step(carry, planes):
        cfy, cfu, cfv = carry
        py, pu, pv, vld = planes
        (oy, ou, ov), (nfy, nfu, nfv) = yuv422.black_key_feedback(
            py, pu, pv, cfy, cfu, cfv, level)
        keep = vld != 0
        nxt = (jnp.where(keep, nfy, cfy), jnp.where(keep, nfu, cfu),
               jnp.where(keep, nfv, cfv))
        return nxt, (oy, ou, ov)

    (fy, fu, fv), (oy, ou, ov) = jax.lax.scan(
        step, (fy, fu, fv), (y, u, v, valid))
    return (oy, ou, ov), (fy, fu, fv)


def _interleave_np(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    out = np.empty((top.shape[0] * 2, top.shape[1]), top.dtype)
    out[0::2] = top
    out[1::2] = bottom
    return out


class CompositePipeline:
    """Gen-1 flagship pipeline (ffmpeg_to_composite equivalent)."""

    def __init__(self, cfg: RunConfig, gop: int = 64, dtype=jnp.float32,
                 progress: bool = True, die=None, mesh=None):
        self.cfg = cfg
        self.gop = gop
        self.mesh = mesh
        if mesh is not None and gop % mesh.devices.size:
            raise ValueError(
                f"mesh size {mesh.devices.size} must divide the GOP batch "
                f"{gop}")
        self.die = die or {"die": 0}
        self.dtype = dtype
        self.progress = progress
        self.key = jax.random.PRNGKey(cfg.seed)
        out = cfg.output
        self._field_rate = Fraction(out.field_rate_num, out.field_rate_den)
        l = out.height // 2
        w2 = out.width // 2
        self._filter_planes = (
            jnp.full((l, out.width), 16, jnp.int32),
            jnp.full((l, w2), 128, jnp.int32),
            jnp.full((l, w2), 128, jnp.int32),
        )
        self._programs = {}
        self._bob_map_cache = {}

    # ----------------------------------------------------------- device step

    def _build_gop_program(self, src_h: int, src_w: int, chroma_h: int,
                           chroma_w: int, src_interlaced: bool,
                           src_tff: bool):
        """One jit program per source geometry: flat-buffer unpack + hscale +
        field render + black-key + chain + uint8 pack, all in a single
        dispatch. Inputs are exactly two wire arrays (pix uint8, meta int32)
        plus carried device state, so each GOP costs two host-to-device
        copies and one launch."""
        cache_key = (src_h, src_w, chroma_h, chroma_w, src_interlaced,
                     src_tff)
        prog = self._programs.get(cache_key)
        if prog is not None:
            return prog
        # process-wide second level: a resident daemon constructs a fresh
        # pipeline per command; identical (cfg, geometry) must reuse the
        # compiled program, not re-compile
        mesh_key = (None if self.mesh is None
                    else tuple(d.id for d in self.mesh.devices.flat))
        prog = progcache.get_or_build(
            ("gen1", self.cfg, self.gop, str(self.dtype), mesh_key)
            + cache_key,
            lambda: self._build_gop_program_uncached(
                src_h, src_w, chroma_h, chroma_w, src_interlaced, src_tff))
        self._programs[cache_key] = prog
        return prog

    def _build_gop_program_uncached(self, src_h: int, src_w: int,
                                    chroma_h: int, chroma_w: int,
                                    src_interlaced: bool, src_tff: bool):
        cfg = self.cfg
        out = cfg.output
        ccfg = cfg.composite
        bkey = cfg.black_key_level_feedback
        dtype = self.dtype
        gop = self.gop
        mesh = self.mesh
        max_frames = gop // 2 + 2
        luma_consts = hscale_consts(src_w, out.width)
        chroma_consts = hscale_consts(chroma_w, out.width // 2)
        # [4, L] row/frac tables for every (parity, interlace-flip) code
        yt1, yt2, ytf, ct1, ct2, ctf = render_index_tables(
            out.height, src_h, chroma_h, src_interlaced, src_tff)
        ny = max_frames * src_h * src_w
        nu = max_frames * chroma_h * chroma_w

        def hscale(p, consts):
            # bit-identical to colorconv.hscale_bilinear (same constants,
            # same f32 lerp + round)
            p = p.astype(jnp.int32)
            if consts is None:
                return p
            x0, x1, f = consts
            pf = p.astype(jnp.float32)
            s0 = pf[..., x0]
            s1 = pf[..., x1]
            return jnp.round(s0 + (s1 - s0) * jnp.asarray(f)).astype(jnp.int32)

        @jax.jit
        def gop_step(pix, meta, key, filter_planes):
            fy = jax.lax.slice(pix, (0,), (ny,)).reshape(
                max_frames, src_h, src_w)
            fu = jax.lax.slice(pix, (ny,), (ny + nu,)).reshape(
                max_frames, chroma_h, chroma_w)
            fv = jax.lax.slice(pix, (ny + nu,), (ny + 2 * nu,)).reshape(
                max_frames, chroma_h, chroma_w)
            src_idx = jax.lax.slice(meta, (0,), (gop,))
            code = jax.lax.slice(meta, (gop,), (2 * gop,))
            fieldno = jax.lax.slice(meta, (2 * gop,), (3 * gop,))
            parity = jax.lax.slice(meta, (3 * gop,), (4 * gop,))
            valid = jax.lax.slice(meta, (4 * gop,), (5 * gop,))

            sy = hscale(fy, luma_consts)
            su = hscale(fu, chroma_consts)
            sv = hscale(fv, chroma_consts)

            def render(p, t1, t2, tf):
                # d = s1 + ((s2 - s1) * frac >> 8), render_field's 8-bit
                # interpolation (ffmpeg_to_composite.cpp:1098-1099)
                i1 = jnp.asarray(t1)[code]        # [B, L]
                i2 = jnp.asarray(t2)[code]
                fr = jnp.asarray(tf)[code]
                s1 = p[src_idx[:, None], i1]
                s2 = p[src_idx[:, None], i2]
                return s1 + (((s2 - s1) * fr[..., None]) >> 8)

            y = render(sy, yt1, yt2, ytf)
            u = render(su, ct1, ct2, ctf)
            v = render(sv, ct1, ct2, ctf)
            if bkey >= 0:
                (y, u, v), filter_planes = _bkey_scan(
                    y, u, v, *filter_planes, bkey, valid)
            if cfg.enable_composite_emulation:
                def chain(y_, u_, v_, fn_, pa_, k_):
                    return yuv422.composite_video_process(
                        y_, u_, v_, cfg=ccfg, fieldno=fn_, field_parity=pa_,
                        key=k_, dtype=dtype)

                if mesh is not None:
                    # -devices: the composite chain (the FLOPs) shards the
                    # field batch over every device via shard_map (the
                    # parallel/mesh.run_field_sharded_chain layout). The
                    # render/black-key prolog stays a plain jit region
                    # (black-key carries sequential per-field state). Noise
                    # is content-addressed on (seed, fieldno, stage), so
                    # shard outputs are bit-identical to the single-device
                    # batch.
                    from jax.sharding import PartitionSpec as P
                    flat = P(("dp", "sp"))
                    chain = jax.shard_map(
                        chain, mesh=mesh,
                        in_specs=(flat, flat, flat, flat, flat, P()),
                        out_specs=(flat, flat, flat))
                y, u, v = chain(y, u, v, fieldno, parity, key)
            # one wire buffer out, split in halves so the two D2H copies
            # overlap each other and the host-side emit
            packed = jnp.concatenate(
                [y.astype(jnp.uint8), u.astype(jnp.uint8),
                 v.astype(jnp.uint8)], axis=2)
            return packed[: gop // 2], packed[gop // 2:], filter_planes

        # Every shape is static, so compile here, at build time, rather than
        # on the first GOP; JAX's persistent compilation cache (set up by
        # cli/main.enable_compile_cache) serves a warm start.
        sds = jax.ShapeDtypeStruct
        npix = ny + 2 * nu
        l = out.height // 2
        w2 = out.width // 2
        return gop_step.lower(
            sds((npix,), jnp.uint8), sds((5 * gop,), jnp.int32), self.key,
            (sds((l, out.width), jnp.int32),
             sds((l, w2), jnp.int32), sds((l, w2), jnp.int32))).compile()

    def _dummy_batch(self, src_h: int, src_w: int, chroma_h: int,
                     chroma_w: int):
        """One all-zeros GOP with the real wire layout (for priming)."""
        b = FieldBatcher(gop=self.gop, src_height=src_h,
                         chroma_height=chroma_h, luma_w=src_w,
                         chroma_w=chroma_w)
        z = np.zeros((src_h, src_w), np.uint8)
        zc = np.zeros((chroma_h, chroma_w), np.uint8)
        fld, batch = 0, None
        while batch is None:
            b.add_frame(z, zc, zc)
            for _ in range(2):
                r = b.add_field(fld, (fld & 1) ^ 1, 0)
                if r is not None:
                    batch = r
                fld += 1
        return batch

    def _prime_program(self, gop_step, src_h, src_w, chroma_h, chroma_w):
        """Execute gop_step once on a dummy GOP and fetch one output half,
        so the first real batch finds the program loaded and the device
        buffers allocated. Best-effort."""
        try:
            batch = self._dummy_batch(src_h, src_w, chroma_h, chroma_w)
            ha, _hb, _pl = gop_step(
                jax.device_put(batch.pix), jax.device_put(batch.meta),
                self.key, self._filter_planes)
            np.asarray(ha)
        except Exception:
            pass   # priming must never take down the run

    # ------------------------------------------------------------- emit side

    def _bob_maps(self, parity: int):
        """Field-line gather maps for bob packing: output row j of the bob
        frame reads field line map[j] (output_frame, :1178-1235)."""
        maps = self._bob_map_cache.get(parity)
        if maps is None:
            h = self.cfg.output.height
            rows = fieldops.bob_rows(h, parity)
            luma = ((rows - parity) >> 1).astype(np.int64)
            chroma = ((rows[0::2] - parity) >> 1).astype(np.int64)
            maps = (luma, chroma)
            self._bob_map_cache[parity] = maps
        return maps

    def _emit_field(self, y, u, v, fieldno, parity, writer, pending):
        """Pack one processed uint8 field into the output stream — numpy row
        gathers only (device work ended at the uint8 pack)."""
        out = self.cfg.output
        if out.interlaced_output:
            pending[parity] = (y, u, v)
            if parity == 0 and 1 in pending and 0 in pending:
                # field pair complete: bottom field first (parity of field k
                # is (k & 1) ^ 1, so even field counters are bottom lines)
                top, bottom = pending[0], pending[1]
                fy = _interleave_np(top[0], bottom[0])
                fu = _interleave_np(top[1], bottom[1])
                fv = _interleave_np(top[2], bottom[2])
                self._write_frame(writer, fy, fu, fv)
                pending.clear()
        else:
            luma_map, chroma_map = self._bob_maps(parity)
            if out.use_422_colorspace:
                writer.write(y[luma_map], u[luma_map], v[luma_map])
            else:
                writer.write(y[luma_map], u[chroma_map], v[chroma_map])
        if self.progress:
            print(f"\x0dOutput field {fieldno} ", end="", file=sys.stderr)

    def _write_frame(self, writer, y, u, v):
        if self.cfg.output.use_422_colorspace:
            writer.write(y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8))
        elif self.cfg.output.interlaced_output:
            # interlaced 4:2:0 chroma interleaves the two fields' chroma rows
            # (output_frame, ffmpeg_to_composite.cpp:1215-1224)
            h = y.shape[0]
            sel = np.arange(h)[(np.arange(h) & 2) == 0]
            cy = (sel & 1) + ((sel & ~3) >> 1)
            cu = np.zeros((h // 2, u.shape[1]), u.dtype)
            cv = np.zeros((h // 2, v.shape[1]), v.dtype)
            cu[cy] = u[sel]
            cv[cy] = v[sel]
            writer.write(y.astype(np.uint8), cu.astype(np.uint8), cv.astype(np.uint8))
        else:
            writer.write(y.astype(np.uint8),
                         u[0::2].astype(np.uint8), v[0::2].astype(np.uint8))

    # ------------------------------------------------------------ video side

    def run_video(self, reader: y4m.Y4MReader, out_stream,
                  ckpt_path: str | None = None, ckpt_every: int = 4,
                  frame_log=None, frame_log_rate: int = 90000,
                  _fail_after_gops: int | None = None):
        """Drive video frames from a Y4M reader through the chain with
        reader-prep / device-compute / D2H-encode overlapped in threads.

        ckpt_path enables checkpoint/resume (host/checkpoint.py): the writer
        thread saves a resumable cursor + the black-key carry every
        `ckpt_every` GOPs, and a matching existing checkpoint resumes the
        run (output truncated to the recorded frame boundary, reader seeked
        past consumed source frames). _fail_after_gops is a test hook that
        injects a crash after N GOPs are written.
        """
        from cvsim_tpu.host import checkpoint

        cfg = self.cfg
        out = cfg.output
        hdr = reader.header
        fps = hdr.fps
        src_interlaced = hdr.interlacing in ("t", "b")
        src_tff = hdr.interlacing != "b"

        clock = timing.FrameClock(fps, self._field_rate,
                                  log=frame_log or None,
                                  log_rate=frame_log_rate)
        # Streaming VFR: cvsim-av decode -ts stamps each FRAME marker with
        # the container's real (pts, duration) at 90 kHz ("Xt=p:d",
        # y4m.Y4MReader.frame_params) — the duration map arrives WITH the
        # frame, so VFR/telecine sources get per-frame field targeting on
        # direct container ingest, no sidecar log needed (the reference's
        # reordered_opaque duration carry, ffmpeg_to_composite.cpp:
        # 1641-1647).  Disabled under checkpointing: a resumed run cannot
        # recover the skipped frames' timestamps, and cadence must match
        # the original run.
        use_inband_ts = frame_log is None and ckpt_path is None

        def push_inband_ts(params):
            xt = params.get("Xt")
            if xt is None:
                return
            p, _, d = xt.partition(":")
            dur = max(1, int(d))
            if clock.log is None:
                clock.log = []
            if p in ("n", "-1"):  # no container pts: extend by cadence
                # ("n" from cvsim-av; "-1" accepted for older binaries —
                # real negative pts pass through, they are legitimate for
                # streams with nonzero start offsets)
                pts = (clock.log[-1][0] + clock.log[-1][1]
                       if clock.log else 0)
            else:
                pts = int(p)
            clock.log.append((pts, dur))

        out_fps = (self._field_rate / 2 if out.interlaced_output
                   else self._field_rate)
        whdr = y4m.Y4MHeader(
            width=out.width, height=out.height, fps=out_fps,
            # bottom field first: field k's parity is (k & 1) ^ 1, and the
            # reference sets top_field_first = 0 on interlaced output
            # (output_frame emits at field=1)
            interlacing=("b" if out.interlaced_output else "p"),
            aspect="4:3",
            colorspace="422" if out.use_422_colorspace else "420jpeg")

        run_hash = checkpoint.config_hash(
            cfg, hdr, self.gop,
            (frame_log, frame_log_rate) if frame_log else None)
        resume_field = 0
        frames_written = 0
        ckpt_base_idx = None
        if ckpt_path:
            loaded = checkpoint.load(ckpt_path)
            if loaded and loaded[0].get("hash") == run_hash:
                meta, arrs = loaded
                resume_field = int(meta["next_field"])
                frames_written = int(meta["frames_written"])
                ckpt_base_idx = meta["base_idx"]
                self._filter_planes = tuple(
                    jnp.asarray(arrs[k]) for k in ("fy", "fu", "fv"))
                if self.progress:
                    print(f"Resuming at field {resume_field} "
                          f"({frames_written} frames already written)",
                          file=sys.stderr)
            elif loaded:
                print("Checkpoint exists but flags/input changed; "
                      "starting over", file=sys.stderr)

        if resume_field:
            hdr_line = whdr.header_line()
            out_stream.seek(0)
            if out_stream.read(len(hdr_line)) != hdr_line:
                raise ValueError(
                    "resume: existing output header does not match")
            fsize = 6 + whdr.frame_bytes()   # b"FRAME\n" + payload
            out_stream.seek(len(hdr_line) + frames_written * fsize)
            out_stream.truncate()
            writer = y4m.Y4MWriter(out_stream, whdr, write_header=False)
            writer.frames_written = frames_written
            # skip source frames that only feed fields < resume_field:
            # frame rel produces fields [video_field, tgt(rel+1)), so the
            # first needed frame is the smallest rel with
            # tgt(rel+1) > resume_field (plus the window prefix base_idx)
            base0 = ckpt_base_idx or 0
            rel0 = 0
            while clock.fields(base0 + rel0, base0)[1] <= resume_field:
                rel0 += 1
            skip_n = base0 + rel0
            checkpoint.skip_y4m_frames(reader, skip_n)
        else:
            try:
                # a reused output stream (resume attempted, hash mismatch)
                # must restart from zero bytes; pipes reject this harmlessly
                out_stream.seek(0)
                out_stream.truncate()
            except (OSError, io.UnsupportedOperation, AttributeError):
                pass
            writer = y4m.Y4MWriter(out_stream, whdr)
            skip_n = 0

        ch, cw = hdr.chroma_shape
        chroma_h = ch or hdr.height
        chroma_w = cw or hdr.width // 2
        gop_step = self._build_gop_program(
            hdr.height, hdr.width, chroma_h, chroma_w,
            src_interlaced, src_tff)
        batcher = FieldBatcher(
            gop=self.gop, src_height=hdr.height, chroma_height=chroma_h,
            luma_w=hdr.width, chroma_w=chroma_w)

        q_in: queue.Queue = queue.Queue(maxsize=2)
        q_out: queue.Queue = queue.Queue(maxsize=2)
        errors: list[BaseException] = []
        fields_done = {"n": 0}

        def put_batch(b):
            # H2D from the reader thread: the copy overlaps the previous
            # GOP's D2H and the device compute
            b.pix = jax.device_put(b.pix)
            b.meta = jax.device_put(b.meta)
            q_in.put(b)

        def read_loop():
            video_field = resume_field
            base_idx = ckpt_base_idx if resume_field else None
                              # first accepted frame rebases the clock to
                              # zero (the reference's adj_time, :2264-2265)
            try:
                for local_idx, (ysrc, usrc, vsrc) in enumerate(reader):
                    if self.die["die"]:
                        # soft stop: finish queued batches, write the
                        # trailer (reference soft-SIGINT, :62-66,2120-2124)
                        break
                    if use_inband_ts:
                        push_inband_ts(reader.frame_params)
                    frame_idx = local_idx + skip_n
                    t = clock.seconds(frame_idx)
                    if cfg.transcode_end >= 0 and t >= cfg.transcode_end:
                        break
                    if t < cfg.transcode_start:
                        continue
                    if base_idx is None:
                        base_idx = frame_idx
                        base_idx_box["v"] = base_idx
                    frame_pts, tgt = clock.fields(frame_idx, base_idx)
                    tgt = timing.video_target_field(tgt, video_field)
                    batcher.add_frame(ysrc, usrc, vsrc)
                    while video_field < tgt:
                        parity = (video_field & 1) ^ 1  # bottom first :1784
                        b = batcher.add_field(
                            video_field, parity,
                            max(0, video_field - frame_pts))
                        if b is not None:
                            put_batch(b)
                        video_field += 1
                b = batcher.finish()
                if b is not None:
                    put_batch(b)
                fields_done["n"] = video_field
            except BaseException as e:  # propagate to main thread
                errors.append(e)
            finally:
                q_in.put(None)

        pending: dict = {}
        w = out.width
        wc = w // 2
        fetch_pool = ThreadPoolExecutor(2, thread_name_prefix="cvsim-d2h")
        trace = os.environ.get("CVSIM_TIMING") == "1"
        # Machine-readable phase lines (CVSIM_PHASES=1): bench.py reads
        # these to report startup/first-fetch/steady separately instead of
        # differencing two subprocess walls.
        from cvsim_tpu.utils.log import phase

        phase("run_video_start")

        wrote = {"frames": frames_written, "gops": 0}
        base_idx_box = {"v": ckpt_base_idx}

        def write_loop():
            first_fetch = True
            try:
                while True:
                    item = q_out.get()
                    if item is None:
                        return
                    half_a, half_b, fieldnos, parities, n_real, planes = item
                    t0 = time.perf_counter()
                    # concurrent D2H of the two halves (blocks until done)
                    buf_a, buf_b = fetch_pool.map(np.asarray,
                                                  (half_a, half_b))
                    t1 = time.perf_counter()
                    if first_fetch:
                        first_fetch = False
                        phase("first_fetch_done", fields=n_real)
                    na = buf_a.shape[0]
                    for k in range(n_real):
                        row = buf_a[k] if k < na else buf_b[k - na]
                        self._emit_field(
                            row[:, :w], row[:, w:w + wc], row[:, w + wc:],
                            int(fieldnos[k]), int(parities[k]),
                            writer, pending)
                    wrote["frames"] = writer.frames_written
                    wrote["gops"] += 1
                    if (ckpt_path and not pending
                            and wrote["gops"] % ckpt_every == 0):
                        out_stream.flush()
                        fy, fu, fv = planes
                        checkpoint.save(
                            ckpt_path,
                            {"hash": run_hash,
                             "cfg_hash": checkpoint.config_hash(cfg),
                             "next_field": int(fieldnos[n_real - 1]) + 1,
                             "frames_written": wrote["frames"],
                             "base_idx": base_idx_box["v"]},
                            {"fy": np.asarray(fy), "fu": np.asarray(fu),
                             "fv": np.asarray(fv)})
                    if (_fail_after_gops is not None
                            and wrote["gops"] >= _fail_after_gops):
                        raise RuntimeError("injected checkpoint-test crash")
                    if trace:
                        mb = (buf_a.nbytes + buf_b.nbytes) / 1e6
                        t2 = time.perf_counter()
                        print(f"[timing] D2H {t1-t0:6.3f}s "
                              f"({mb/max(t1-t0,1e-9):5.1f} MB/s)  "
                              f"emit {t2-t1:6.3f}s", file=sys.stderr)
            except BaseException as e:
                errors.append(e)
                while q_out.get() is not None:   # drain; main never blocks
                    pass

        rt = threading.Thread(target=read_loop, name="cvsim-read", daemon=True)
        wt = threading.Thread(target=write_loop, name="cvsim-write", daemon=True)
        rt.start()
        wt.start()
        first_dispatch = True
        try:
            while True:
                b = q_in.get()
                if b is None:
                    break
                if first_dispatch:
                    first_dispatch = False
                    phase("first_dispatch")
                # noise is content-addressed per (seed, fieldno, stage): the
                # base key passes straight through so output is GOP- and
                # restart-invariant
                t0 = time.perf_counter()
                half_a, half_b, self._filter_planes = gop_step(
                    b.pix, b.meta, self.key, self._filter_planes)
                half_a.copy_to_host_async()
                half_b.copy_to_host_async()
                if trace:
                    print(f"[timing] dispatch {time.perf_counter()-t0:6.3f}s "
                          f"(batch of {b.n_real})", file=sys.stderr)
                q_out.put((half_a, half_b, b.fieldno, b.parity, b.n_real,
                           self._filter_planes))
        finally:
            # always unwind the threads, also when gop_step raised: the
            # writer needs its sentinel, and the reader may be blocked on a
            # full q_in — drain until it exits so no thread outlives us
            # holding file handles and device buffers
            q_out.put(None)
            while rt.is_alive():
                try:
                    while True:
                        q_in.get_nowait()
                except queue.Empty:
                    pass
                rt.join(timeout=0.1)
            wt.join()
            fetch_pool.shutdown(wait=False)
        if errors:
            raise errors[0]
        if ckpt_path:
            checkpoint.clear(ckpt_path)
        phase("run_video_done", fields=fields_done["n"])
        if self.progress:
            print("", file=sys.stderr)
        return fields_done["n"]

    # ----------------------------------------------------------- audio side

    def run_audio(self, in_path: str, out_path: str, chunk: int = 1 << 20,
                  pts_packets=None):
        # chunk: the whole stream is decoded up front (the reference also
        # reads ahead of the video loop), so the chunk size only sets the
        # device dispatch granularity. The chunks are serialized by the
        # carried AudioState, so each costs one launch and one round trip:
        # few large chunks beat many small ones. Chunked-state ==
        # whole-stream is pinned by tests/test_audio.py.
        cfg = self.cfg
        acfg = cfg.audio
        from cvsim_tpu.host import ffmpeg_pipe

        # Container ingest without a user-supplied packet log: capture the
        # demuxer's own audio packet timestamps (cvsim-av decode-audio
        # -audio-pkt-log) so PTS gaps get silence-filled on the A/V master
        # clock automatically — the reference's in-loop gap fill
        # (ffmpeg_to_composite.cpp:1892-1915) from real container ingest.
        auto_log = None
        if (pts_packets is None and not in_path.endswith(".wav")
                and ffmpeg_pipe.av_tool() is not None):
            fd, auto_log = tempfile.mkstemp(prefix="cvsim_apts_",
                                            suffix=".log")
            os.close(fd)
        try:
            samples, rate = ffmpeg_pipe.resolve_audio_input(
                in_path, acfg.rate, acfg.channels, pkt_log=auto_log)
            if auto_log is not None:
                log_rate, pkts = timing.read_audio_pts_log(auto_log)
                if pkts:
                    # rebase to the stream's own start: containers often
                    # begin at a nonzero pts, and the video side rebases
                    # to its first frame too — keep intra-stream GAPS (the
                    # feature) without manufacturing leading silence equal
                    # to the container's start offset
                    base = next((p for p, _ in pkts if p is not None), 0)
                    if base:
                        pkts = [(None if p is None else p - base, n)
                                for p, n in pkts]
                    pts_packets = (log_rate, pkts)
        finally:
            if auto_log is not None:
                os.unlink(auto_log)
        if pts_packets:
            log_rate, pkts = pts_packets
            samples = _audio_pad_fill(samples, pkts, rate,
                                      log_rate=log_rate)
        if rate != acfg.rate:
            samples = _resample_sinc(samples, rate, acfg.rate)
        if samples.shape[1] != acfg.channels:
            samples = _remix(samples, acfg.channels)
        if cfg.transcode_start > 0 or cfg.transcode_end >= 0:
            s0 = int(cfg.transcode_start * acfg.rate)
            s1 = (int(cfg.transcode_end * acfg.rate)
                  if cfg.transcode_end >= 0 else len(samples))
            samples = samples[s0:s1]
        if not cfg.enable_audio_emulation:
            # the sinc resampler's Gibbs overshoot can exceed full scale;
            # clip (like the emulation path's clips16) instead of letting
            # astype wrap to the opposite rail
            wavio.write_wav(out_path,
                            np.clip(samples, -32768, 32767).astype(np.int16),
                            acfg.rate)
            return len(samples)

        state = init_audio_state(acfg, self.dtype)
        outs = []
        key = jax.random.PRNGKey(cfg.seed + 1)
        pos = 0
        while pos < len(samples):
            part = samples[pos:pos + chunk]
            pulses = (buzz_pulse_counts(acfg, pos, len(part))
                      if not acfg.vhs_hifi else None)
            out, state = composite_audio_process(
                jnp.asarray(part, jnp.int32), state, key, cfg=acfg,
                pulses=pulses, dtype=self.dtype)
            outs.append(np.asarray(out))
            pos += chunk
        result = np.concatenate(outs) if outs else np.zeros((0, acfg.channels))
        wavio.write_wav(out_path, result.astype(np.int16), acfg.rate)
        return len(result)


def _audio_pad_fill(samples: np.ndarray, packets, rate: int,
                    log_rate: int | None = None) -> np.ndarray:
    """Close audio PTS gaps with silence so audio stays on the video master
    clock (ffmpeg_to_composite.cpp:1892-1915: when a packet's target sample
    runs ahead of the running counter, silence is written first; small
    backward jitter is held via the rate/30 slack of audio_target_sample).

    packets: [(pts_in_samples, n_samples), ...] in stream order, pts in
    samples at the rate the log was authored against — by default the rate
    of the DELIVERED stream (`rate`; the ffmpeg ingest path delivers the
    output rate, not the container's). A log authored at the container's
    native rate declares it with a `rate <hz>` first line and both pts and
    n are rescaled here. Samples beyond the log's coverage pass through
    unchanged."""
    if log_rate and log_rate != rate:
        packets = [(None if p is None else round(p * rate / log_rate),
                    round(n * rate / log_rate)) for p, n in packets]
    if len(samples) and packets and not any(n for _, n in packets):
        # a log with no usable durations at all (container carries none and
        # the logger couldn't attribute decoded samples): consuming 0 per
        # packet would push the WHOLE stream behind pts-worth of silence —
        # skip gap fill rather than corrupt
        print("audio packet log carries no durations; skipping PTS gap fill",
              file=sys.stderr)
        return samples
    out = []
    cur = 0          # master-clock sample counter (output position)
    pos = 0          # consumed source samples
    width = samples.shape[1:]
    for pts, n in packets:
        tgt = timing.audio_target_sample(pts, cur, rate)
        if tgt > cur:
            out.append(np.zeros((tgt - cur,) + width, samples.dtype))
            cur = tgt
        part = samples[pos:pos + n]
        out.append(part)
        pos += len(part)
        cur += len(part)
    if pos < len(samples):
        out.append(samples[pos:])
    return np.concatenate(out) if out else samples


def _resample_linear(samples: np.ndarray, src_rate: int, dst_rate: int):
    """Host-side linear resampler (kept for tiny inputs and as a reference
    point; _resample_sinc is the production path for the swr role,
    ffmpeg_to_composite.cpp:1839-1866)."""
    n = samples.shape[0]
    m = int(round(n * dst_rate / src_rate))
    xs = np.arange(m) * (n - 1) / max(1, m - 1)
    x0 = np.floor(xs).astype(np.int64)
    x1 = np.minimum(x0 + 1, n - 1)
    f = (xs - x0)[:, None]
    out = samples[x0] * (1 - f) + samples[x1] * f
    return np.round(out).astype(np.int64)


def _resample_sinc(samples: np.ndarray, src_rate: int, dst_rate: int,
                   taps: int = 32, beta: float = 8.6):
    """Windowed-sinc (Kaiser) resampler — the quality tier of the swr role
    (ffmpeg_to_composite.cpp:1839-1866). Direct per-output-sample evaluation,
    vectorized in blocks: out[j] = sum_k x[k] * w(k - t_j) with
    w = sinc(fc u) * kaiser(beta), fc = min(1, dst/src) for anti-aliased
    downsampling; weights are renormalized per output sample so DC is exact
    even at the edges. ~80 dB stopband at taps=32, beta=8.6."""
    if src_rate == dst_rate:
        return samples.astype(np.int64)
    n = samples.shape[0]
    m = int(round(n * dst_rate / src_rate))
    if n < 2 * taps or m < 2:
        return _resample_linear(samples, src_rate, dst_rate)
    fc = min(1.0, dst_rate / src_rate)
    half = taps // 2
    x = samples.astype(np.float64)
    i0 = np.i0(beta)
    out = np.empty((m,) + samples.shape[1:], np.float64)
    block = 1 << 16
    ks = np.arange(-half + 1, half + 1, dtype=np.float64)   # [taps]
    for j0 in range(0, m, block):
        j1 = min(j0 + block, m)
        t = np.arange(j0, j1, dtype=np.float64) * (src_rate / dst_rate)
        base = np.floor(t).astype(np.int64)
        frac = t - base
        u = ks[None, :] - frac[:, None]                     # [J, taps]
        w = np.sinc(fc * u) * fc
        arg = 1.0 - (u / half) ** 2
        w *= np.where(arg > 0, np.i0(beta * np.sqrt(np.maximum(arg, 0.0))), 0.0) / i0
        w /= w.sum(axis=1, keepdims=True)
        idx = np.clip(base[:, None] + ks.astype(np.int64)[None, :], 0, n - 1)
        out[j0:j1] = np.einsum("jt,jt...->j...", w, x[idx])
    return np.round(out).astype(np.int64)


def _remix(samples: np.ndarray, channels: int):
    if channels == 1:
        return np.round(samples.mean(axis=1)).astype(np.int64)[:, None]
    if samples.shape[1] >= channels:
        return samples[:, :channels]
    # upmix by cycling source channels (stereo -> quad duplicates pairs)
    idx = np.arange(channels) % samples.shape[1]
    return samples[:, idx]
