"""Host-side GOP batch packing for one-dispatch-per-GOP device execution.

Tiny per-frame device calls (hscale x3 + render_field x3 per field) would
each pay a launch and a transfer. This module assembles fixed-shape batches
of RAW uint8 source frames so the device program can do horizontal scale +
field render + composite chain + uint8 pack in ONE dispatch per GOP (the
reference's per-field inner loop, ffmpeg_to_composite.cpp:2245-2333, lifted
to a batch).

Wire-format notes:

- all pixel planes ride ONE flat uint8 buffer per batch (every extra array
  per dispatch is one more host-to-device copy);
- per-field metadata is ONE small int32 vector: frame slot, render-index
  code, fieldno, parity. The render_field row/fraction tables depend only on
  (parity, interlace-flip) for fixed source heights, so the device program
  holds all four variants as [4, L] closure constants and selects by code —
  nothing per-field crosses the wire but 16 bytes.

Shapes are static per run: B = `gop` field slots, F = `max_frames` source
frame slots. Batches are padded (last field repeated) and `n_real` marks
how many fields to emit.
If a batch would reference more than F distinct frames (field rate below
frame rate), it is flushed early — smaller effective batches, same output.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cvsim_tpu.host.fieldops import render_field_indices


@dataclasses.dataclass
class GopBatch:
    """One fixed-shape device dispatch worth of work."""

    pix: np.ndarray        # flat uint8: frames_y | frames_u | frames_v
    meta: np.ndarray       # int32 [5*B]: src_idx | code | fieldno | parity | valid
    fieldno: np.ndarray    # [B] int32 (host copy for the emit side)
    parity: np.ndarray     # [B] int32
    n_real: int            # fields to emit (rest is padding)


class FieldBatcher:
    """Accumulates (frame, fields-rendered-from-it) pairs into GopBatches.

    Drive it with `add_frame(y, u, v)` per decoded frame then
    `add_field(video_field, parity, pts_delta)` per output field the frame
    must produce (the reference's field catch-up loop,
    ffmpeg_to_composite.cpp:1783-1800). Both may return a completed GopBatch.
    Call `finish()` at EOF for the final partial batch.
    """

    def __init__(self, *, gop: int, src_height: int, chroma_height: int,
                 luma_w: int, chroma_w: int, ticks_per_frame: int = 2,
                 max_frames: int | None = None):
        self.gop = gop
        self.src_h = src_height
        self.chroma_h = chroma_height
        self.luma_w = luma_w
        self.chroma_w = chroma_w
        self.ticks = ticks_per_frame
        self.max_frames = max_frames or (gop // 2 + 2)
        self._ybytes = src_height * luma_w
        self._cbytes = chroma_height * chroma_w
        self._frames: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._fields: list[tuple[int, int, int, int]] = []
        self._cur_frame = None
        self._cur_slot = None

    # ------------------------------------------------------------- feeding

    def add_frame(self, y: np.ndarray, u, v) -> None:
        if u is None:
            # mono source: neutral chroma at 4:2:2 siting (round-1 behavior)
            u = np.full((y.shape[0], y.shape[1] // 2), 128, np.uint8)
            v = u
        self._cur_frame = (np.ascontiguousarray(y, np.uint8),
                           np.ascontiguousarray(u, np.uint8),
                           np.ascontiguousarray(v, np.uint8))
        self._cur_slot = None

    def add_field(self, video_field: int, parity: int,
                  pts_delta: int) -> GopBatch | None:
        assert self._cur_frame is not None, "add_frame before add_field"
        done = None
        if self._cur_slot is None:
            if len(self._frames) >= self.max_frames:
                done = self._finish()      # early flush: frame slots full
            self._frames.append(self._cur_frame)
            self._cur_slot = len(self._frames) - 1
        # only the >= ticks/2 comparison of pts_delta matters (:1033-1036)
        code = parity * 2 + int(pts_delta >= self.ticks // 2)
        self._fields.append((self._cur_slot, code, video_field, parity))
        if len(self._fields) >= self.gop:
            assert done is None            # gop > 0 implies not both at once
            done = self._finish()
        return done

    def finish(self) -> GopBatch | None:
        """Flush the final partial batch (EOF)."""
        return self._finish()

    # ------------------------------------------------------------ internals

    def _finish(self) -> GopBatch | None:
        if not self._fields:
            self._frames = []
            self._cur_slot = None
            return None
        n_real = len(self._fields)
        fields = self._fields + [self._fields[-1]] * (self.gop - n_real)
        frames = self._frames

        pix = np.empty(
            self.max_frames * (self._ybytes + 2 * self._cbytes), np.uint8)
        fy = pix[: self.max_frames * self._ybytes]
        fu = pix[fy.size: fy.size + self.max_frames * self._cbytes]
        fv = pix[fy.size + fu.size:]
        for k in range(self.max_frames):
            y, u, v = frames[min(k, len(frames) - 1)]
            fy[k * self._ybytes:(k + 1) * self._ybytes] = y.ravel()
            fu[k * self._cbytes:(k + 1) * self._cbytes] = u.ravel()
            fv[k * self._cbytes:(k + 1) * self._cbytes] = v.ravel()

        # valid marks real fields: padding duplicates must not advance
        # stateful carries (the black-key feedback frame) on device
        meta = np.asarray(
            [f[0] for f in fields] + [f[1] for f in fields]
            + [f[2] for f in fields] + [f[3] for f in fields]
            + [1] * n_real + [0] * (self.gop - n_real), np.int32)
        batch = GopBatch(
            pix=pix, meta=meta,
            fieldno=np.asarray([f[2] for f in fields], np.int32),
            parity=np.asarray([f[3] for f in fields], np.int32),
            n_real=n_real)

        self._frames = []
        self._fields = []
        # the current frame may still owe fields to the next batch
        self._cur_slot = None
        return batch


def render_index_tables(dst_height: int, src_h: int, chroma_h: int,
                        src_interlaced: bool, src_tff: bool,
                        ticks_per_frame: int = 2):
    """[4, L] row/fraction tables for all (parity, flip) codes, in the order
    (yi1, yi2, yfr, ci1, ci2, cfr). code = parity*2 + flip."""
    per_code = []
    for parity in (0, 1):
        for flip in (0, 1):
            per_code.append(render_field_indices(
                dst_height, src_h, chroma_h, parity,
                src_interlaced=src_interlaced, src_top_field_first=src_tff,
                pts_delta=flip * (ticks_per_frame // 2),
                ticks_per_frame=ticks_per_frame))
    return tuple(
        np.stack([per_code[c][j] for c in range(4)]).astype(np.int32)
        for j in range(6))


def hscale_consts(src_w: int, dst_w: int):
    """Index/weight constants of colorconv.hscale_bilinear (same math, so
    device-batched scaling is bit-identical to the round-1 per-frame op).
    None when no scaling is needed."""
    if src_w == dst_w:
        return None
    xs = (np.arange(dst_w) + 0.5) * src_w / dst_w - 0.5
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, src_w - 1)
    x1 = np.minimum(x0 + 1, src_w - 1)
    f = (xs - x0).astype(np.float32)
    return x0, x1, f
