"""Gen-2 (ffmpeg_ntsc) pipeline: RGB frames -> YIQ chain per field -> bobbed
progressive output (master loop, ffmpeg_ntsc.cpp:2146-2283).

Notes on fidelity vs the reference's structure:
- The reference keeps a ring of `-d` BGRA canvases, but its per-field
  composite_layer fully overwrites the processed field lines from the source
  frame and the field-deinterlace step (:2233-2257) then duplicates those
  lines across the other parity, so ring contents never reach the output in
  ffmpeg_ntsc itself (the ring is load-bearing in the colorkey/average_delay
  siblings, which share the scaffold). We therefore batch fields onto the
  device and bob each processed field into a frame.
- Multi-input layering: each layer's composite_layer overwrites the canvas's
  field lines, so the last input with a current frame wins; we composite that
  one.
"""

from __future__ import annotations

import sys
from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp

from cvsim_tpu.config import RunConfig
from cvsim_tpu.host import progcache, timing, y4m
from cvsim_tpu.host.colorconv import (
    hscale_bilinear_np,
    rgb_to_yuv601_np,
    yuv_to_rgb601_np,
)
from cvsim_tpu.models import yiq

# per-frame host scaling dispatches to the native kernel (bit-exact twin of
# colorconv.scale_frame_to_np; numpy fallback inside hostpix)
from cvsim_tpu.native.hostpix import scale_frame_to as _scale_frame_to


class YIQPipeline:
    def __init__(self, cfg: RunConfig, frame_delay: int = 1, gop: int = 64,
                 die=None, dtype=jnp.float32, progress: bool = True,
                 mesh=None):
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
        self.frame_delay = frame_delay
        out = cfg.output
        self._field_rate = Fraction(out.field_rate_num, out.field_rate_den)

        ccfg = cfg.composite

        mesh = self.mesh

        def build():
            @jax.jit
            def process_batch(rgb_fields, fieldno, parity, key):
                # wire format is uint8 (1/4 the H2D bytes of int32); widen
                # on device
                rgb_fields = rgb_fields.astype(jnp.int32)
                if cfg.enable_composite_emulation:
                    def chain(r, fn_, pa, k):
                        return yiq.composite_layer_rgb(
                            r, fn_, pa, k, cfg=ccfg, dtype=dtype)

                    if mesh is not None:
                        # -devices: fields shard over every device via
                        # shard_map (the parallel/mesh.run_field_sharded_chain
                        # layout); content-addressed noise keys on fieldno,
                        # so shard outputs are bit-identical to the
                        # single-device batch (tests/test_parallel.py)
                        from jax.sharding import PartitionSpec as P
                        flat = P(("dp", "sp"))
                        chain = jax.shard_map(
                            chain, mesh=mesh,
                            in_specs=(P(("dp", "sp")), flat, flat, P()),
                            out_specs=P(("dp", "sp")))
                    return chain(rgb_fields, fieldno, parity, key)
                return rgb_fields.astype(jnp.uint8)

            # every shape is static: compile at build time, not on the
            # first batch (the persistent compilation cache serves a warm
            # start)
            l, w = out.height // 2, out.width
            sds = jax.ShapeDtypeStruct
            return process_batch.lower(
                sds((gop, l, w, 3), jnp.uint8), sds((gop,), jnp.int32),
                sds((gop,), jnp.int32), self.key).compile()

        # process-wide cache: a resident daemon builds a fresh pipeline per
        # command; identical (cfg, gop, dtype) must reuse the compiled
        # program instead of compiling again for each invocation
        mesh_key = (None if mesh is None
                    else tuple(d.id for d in mesh.devices.flat))
        self._process_batch = progcache.get_or_build(
            ("gen2", cfg, gop, str(dtype), mesh_key), build)
        self._inflight = None
        self._ckpt_save = None   # set per run_video when -checkpoint is on

    def _flush(self, batch, writer, final=False, snapshot=None):
        """Double-buffered like CompositePipeline's streaming loop: batch k
        is dispatched before batch k-1's output is fetched and emitted.

        `snapshot` is the resume cursor captured when `batch` was FORMED
        (host/checkpoint.py): it is saved only after that batch's fields
        are durably written, so a crash resumes exactly at the batch
        boundary the output file actually reached."""
        prev = self._inflight
        if batch:
            # pad short (final) batches to one stable compile shape
            padded = batch + [batch[-1]] * (self.gop - len(batch))
            rgbs = jnp.asarray(
                np.stack([b[0] for b in padded]).astype(np.uint8))
            fieldnos = jnp.asarray([b[1] for b in padded], jnp.int32)
            parities = jnp.asarray([b[2] for b in padded], jnp.int32)
            # content-addressed noise: base key passes straight through
            inflight = (self._process_batch(rgbs, fieldnos, parities,
                                            self.key),
                        [int(b[1]) for b in batch], snapshot)
        else:
            inflight = None
        self._inflight = inflight
        for item in ((prev,) if not final else (prev, inflight)):
            if item is not None:
                self._emit_inflight(item, writer)
        if final:
            self._inflight = None

    def _emit_inflight(self, item, writer):
        out, metas, snapshot = item
        out = np.asarray(out)
        for k, fieldno in enumerate(metas):
            self._emit(out[k], fieldno, writer)
        if snapshot is not None and self._ckpt_save is not None:
            self._ckpt_save(snapshot, writer)

    def _emit(self, rgb_field, fieldno, writer):
        out = self.cfg.output
        # bob the field to a full progressive frame, then RGB -> YUV
        # (numpy: per-field host work, no eager device dispatches)
        h, w = out.height, out.width
        frame = np.repeat(rgb_field, 2, axis=0)[:h]
        y, u, v = rgb_to_yuv601_np(frame[..., 0].astype(np.int32),
                                   frame[..., 1].astype(np.int32),
                                   frame[..., 2].astype(np.int32))
        y = y.astype(np.uint8)
        u = u.astype(np.uint8)
        v = v.astype(np.uint8)
        if out.use_422_colorspace:
            writer.write(y, u[:, 0::2], v[:, 0::2])
        else:
            writer.write(y, u[0::2, 0::2], v[0::2, 0::2])
        if self.progress:
            print(f"\x0dOutput field {fieldno} ", end="", file=sys.stderr)

    def run_video(self, readers: list, out_stream,
                  ckpt_path: str | None = None, ckpt_every: int = 4,
                  frame_log=None, frame_log_rate: int = 90000,
                  _fail_after_gops: int | None = None):
        """Drive the multi-input field loop through the batched chain.

        ckpt_path enables checkpoint/resume (host/checkpoint.py, same
        contract as CompositePipeline.run_video): a resume cursor
        {next_field, frames_written, per-reader consumed/eof/next_at} is
        saved every `ckpt_every` GOPs after the GOP's fields are durably
        written — the gen-2 chain carries no cross-field device state (the
        reference's delay ring never reaches ffmpeg_ntsc's own output, see
        module docstring), so the cursor alone makes resume byte-identical
        (content-addressed noise + pure-function field clock).

        frame_log/frame_log_rate (-video-pts-in) drive a timing.FrameClock
        for the FIRST input: VFR/telecine sources render each frame for its
        own duration (3:2 pulldown cadence etc.); additional inputs keep
        their container CFR cadence. _fail_after_gops is a test hook that
        injects a crash after N GOPs are written."""
        from cvsim_tpu.host import checkpoint

        cfg = self.cfg
        out = cfg.output
        whdr = y4m.Y4MHeader(
            width=out.width, height=out.height, fps=self._field_rate,
            interlacing="p", aspect="4:3",
            colorspace="422" if out.use_422_colorspace else "420jpeg")

        iters = [iter(r) for r in readers]
        fps = [r.header.fps for r in readers]
        frames = [None] * len(readers)      # current scaled RGB frame
        next_at = [0] * len(readers)        # field index when next frame due
        frame_idx = [0] * len(readers)
        eof = [False] * len(readers)
        clock = timing.FrameClock(fps[0], self._field_rate,
                                  log=frame_log or None,
                                  log_rate=frame_log_rate)

        def due_field(k: int) -> int:
            # field index at which reader k's NEXT frame (frame_idx[k])
            # becomes current; input 0 rides the FrameClock (CFR mode is
            # identical to frame_pts_to_field by construction)
            if k == 0:
                return clock.fields(frame_idx[0], 0)[0]
            return timing.frame_pts_to_field(frame_idx[k], fps[k],
                                             self._field_rate)

        run_hash = checkpoint.config_hash(
            cfg, [r.header for r in readers], self.gop, self.frame_delay,
            (frame_log, frame_log_rate) if frame_log else None)
        resume_field = 0
        frames_written = 0
        if ckpt_path:
            loaded = checkpoint.load(ckpt_path)
            if loaded and loaded[0].get("hash") == run_hash:
                meta, _ = loaded
                resume_field = int(meta["next_field"])
                frames_written = int(meta["frames_written"])
                frame_idx = [int(n) for n in meta["consumed"]]
                next_at = [int(n) for n in meta["next_at"]]
                eof = [bool(e) for e in meta["eof"]]
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
            # re-materialize each reader's CURRENT frame: skip the consumed
            # prefix, read+scale the last consumed frame
            for k in range(len(readers)):
                if frame_idx[k] <= 0:
                    continue
                checkpoint.skip_y4m_frames(readers[k], frame_idx[k] - 1)
                try:
                    yf, uf, vf = next(iters[k])
                except StopIteration:
                    raise EOFError("resume: input shorter than checkpoint")
                if uf is None:
                    uf = np.full((yf.shape[0], yf.shape[1]), 128, np.uint8)
                    vf = uf
                frames[k] = _scale_frame_to(yf, uf, vf, out.width,
                                            out.height)
        else:
            try:
                # a reused output stream (resume attempted, hash mismatch)
                # must restart from zero bytes; pipes reject this harmlessly
                out_stream.seek(0)
                out_stream.truncate()
            except (OSError, AttributeError, ValueError):
                pass
            writer = y4m.Y4MWriter(out_stream, whdr)

        wrote = {"gops": 0}

        def ckpt_save(snapshot, wr):
            wrote["gops"] += 1
            if wrote["gops"] % ckpt_every == 0:
                try:
                    out_stream.flush()
                except (OSError, AttributeError, ValueError):
                    pass
                checkpoint.save(ckpt_path, dict(
                    snapshot, hash=run_hash,
                    cfg_hash=checkpoint.config_hash(cfg),
                    frames_written=wr.frames_written), {})
            if (_fail_after_gops is not None
                    and wrote["gops"] >= _fail_after_gops):
                raise RuntimeError("injected checkpoint-test crash")

        self._ckpt_save = ckpt_save if ckpt_path else None

        # -ss/-se/-t extension (the gen-2 reference has no transcode window;
        # gen-1 semantics, pipeline.py read_loop: skip until start, rebase
        # the field clock to zero at the first accepted field, stop at end).
        # The audio side shares cfg.transcode_* (CompositePipeline.run_audio)
        # so A/V stay on the same window.
        rate = float(self._field_rate)
        start_f = (int(np.ceil(cfg.transcode_start * rate))
                   if cfg.transcode_start > 0 else 0)
        end_f = (int(np.ceil(cfg.transcode_end * rate))
                 if cfg.transcode_end >= 0 else None)

        def snapshot():
            return {"next_field": current, "consumed": list(frame_idx),
                    "next_at": list(next_at), "eof": list(eof)}

        current = resume_field
        batch = []
        while True:
            if self.die["die"]:
                break
            if end_f is not None and current >= end_f:
                break
            # advance inputs whose next frame is due
            for k in range(len(readers)):
                while not eof[k] and next_at[k] <= current:
                    try:
                        yf, uf, vf = next(iters[k])
                    except StopIteration:
                        eof[k] = True
                        break
                    if uf is None:
                        uf = np.full((yf.shape[0], yf.shape[1]), 128, np.uint8)
                        vf = uf
                    frames[k] = _scale_frame_to(yf, uf, vf, out.width, out.height)
                    frame_idx[k] += 1
                    next_at[k] = due_field(k)
            if all(eof) and all(next_at[k] <= current for k in range(len(readers))):
                break
            # last input with a frame wins (see module docstring)
            src = None
            for k in reversed(range(len(readers))):
                if frames[k] is not None:
                    src = frames[k]
                    break
            if src is None or current < start_f:
                current += 1
                continue
            vf = current - start_f     # rebased output field counter
            parity = (vf & 1) ^ 1
            field_rgb = src[parity::2]
            batch.append((field_rgb, vf, parity))
            current += 1
            if len(batch) >= self.gop:
                snap = snapshot()
                self._flush(batch, writer, snapshot=snap)
                batch = []
            if all(eof):
                # drain remaining scheduled fields up to the last frame's due
                if current >= max(next_at):
                    break
        self._flush(batch, writer, final=True,
                    snapshot=snapshot() if batch else None)
        self._ckpt_save = None
        if ckpt_path and not self.die["die"]:
            checkpoint.clear(ckpt_path)
        if self.progress:
            print("", file=sys.stderr)
        return max(0, current - start_f)
