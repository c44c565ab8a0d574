"""Gen-2 composite engine: true signed-int planar YIQ (ffmpeg_ntsc.cpp).

The unit of work is a *batch of fields* — int32 arrays of
shape [B, L, W] (B fields, L active lines per field, W samples per line) plus
per-field metadata (fieldno, field parity). Every reference per-scanline loop
becomes either a vectorized elementwise op, an FIR, or a parallel scan over
the W axis; nothing is sequential over pixels.

Reference semantics are preserved exactly at the integer quantization points
(C truncation-toward-zero, arithmetic shifts); the float IIR interiors match
the sequential reference up to reassociation (bit-exact in float64, ~1e-6
relative in float32).

Reference functions and where each is reimplemented here:
- RGB_to_YIQ / YIQ_to_RGB          ffmpeg_ntsc.cpp:1375-1396 -> rgb_to_yiq/yiq_to_rgb
- composite_lowpass                ffmpeg_ntsc.cpp:1429-1458 -> composite_lowpass
- composite_lowpass_tv             ffmpeg_ntsc.cpp:1399-1427 -> composite_lowpass_tv
- chroma_into_luma                 ffmpeg_ntsc.cpp:1460-1495 -> chroma_into_luma
- chroma_from_luma                 ffmpeg_ntsc.cpp:1497-1567 -> chroma_from_luma
- composite_layer (orchestrator)   ffmpeg_ntsc.cpp:1570-1921 -> composite_layer
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from cvsim_tpu.config import CompositeConfig, NTSC_RATE, iir_alpha
from cvsim_tpu.ops.cmath import c_div, c_int
from cvsim_tpu.ops.iir import (
    cascade_emph,
    cascade_unsharp,
    delay_writeback,
    iir_lowpass_cascade,
)
from cvsim_tpu.ops.noise import (
    field_stage_keys,
    chroma_noise_walk_rows,
    randint_per_field,
    random_walk_per_field,
    smoothed_noise_walk_rows,
    uniform_pm1_per_field,
)
from cvsim_tpu.ops.phase import scanline_phase_xi
from cvsim_tpu.ops.roll import roll_rows, select_by_phase

_UMULT_NP = np.array([1, 0, -1, 0], np.int32)
_VMULT_NP = np.array([0, 1, 0, -1], np.int32)


@functools.lru_cache(maxsize=16)
def _qam_mult_tables(w: int):
    """Static [4, W] subcarrier multiplier rows: row k is the per-sample
    U/V multiplier pattern for scanline phase xi=k (Umult[(xi+x)&3])."""
    x = np.arange(w)
    um = np.stack([_UMULT_NP[(k + x) & 3] for k in range(4)]).astype(np.int32)
    vm = np.stack([_VMULT_NP[(k + x) & 3] for k in range(4)]).astype(np.int32)
    return um, vm  # numpy: safe to cache across jit traces


@functools.lru_cache(maxsize=16)
def _flip_table(w: int, guard_x3: bool):
    """Static [4, W] sign-flip mask rows for the Y/C decode: the reference
    flips chroma[x+2], chroma[x+3] for x from ((4-xi)&3) step 4
    (ffmpeg_ntsc.cpp:1539-1542). guard_x3 selects the gen-2 loop bound
    (x+3 < w) vs gen-1's (x < w, in-range flips only)."""
    rows = []
    p = np.arange(w)
    for k in range(4):
        x0 = (4 - k) & 3
        r = (p - x0) & 3
        base = p - r
        mask = (r >= 2) & (base >= x0)
        if guard_x3:
            mask &= (base + 3) < w
        rows.append(mask)
    return np.stack(rows).astype(np.int32)  # numpy: safe to cache across traces


@functools.lru_cache(maxsize=16)
def _demux_valid_table(w: int):
    """Static [4, W] validity of the even-sample demux read
    ((x + xi + 1) < w)."""
    x = np.arange(w)
    rows = [((x + k + 1) < w) for k in range(4)]
    return np.stack(rows).astype(np.int32)  # numpy: safe to cache across traces


# ---------------------------------------------------------------- colorspace

def rgb_to_yiq(r, g, b, dtype=jnp.float32):
    """ffmpeg_ntsc.cpp:1375-1383. Returns int32 Y,I,Q scaled by 256."""
    r = jnp.asarray(r, dtype)
    g = jnp.asarray(g, dtype)
    b = jnp.asarray(b, dtype)
    dy = 0.30 * r + 0.59 * g + 0.11 * b
    y = c_int(256.0 * dy)
    i = c_int(256.0 * ((-0.27 * (b - dy)) + (0.74 * (r - dy))))
    q = c_int(256.0 * ((0.41 * (b - dy)) + (0.48 * (r - dy))))
    return y.astype(jnp.int32), i.astype(jnp.int32), q.astype(jnp.int32)


def yiq_to_rgb(y, i, q, dtype=jnp.float32):
    """ffmpeg_ntsc.cpp:1385-1396. int32 YIQ -> uint8-range int32 RGB."""
    y = jnp.asarray(y, dtype)
    i = jnp.asarray(i, dtype)
    q = jnp.asarray(q, dtype)
    r = c_int((1.000 * y + 0.956 * i + 0.621 * q) / 256.0)
    g = c_int((1.000 * y - 0.272 * i - 0.647 * q) / 256.0)
    b = c_int((1.000 * y - 1.106 * i + 1.703 * q) / 256.0)
    clip = lambda v: jnp.clip(v, 0, 255).astype(jnp.int32)
    return clip(r), clip(g), clip(b)


# ------------------------------------------------------------- chroma filter

def _lowpass_plane(p, cutoff, delay, passes, dtype):
    """3-pass lowpass + delayed writeback on an int32 [B,L,W] plane
    (composite_lowpass inner loop, ffmpeg_ntsc.cpp:1445-1454)."""
    alpha = iir_alpha(NTSC_RATE, cutoff)
    s = iir_lowpass_cascade(p.astype(dtype), alpha, 0.0, passes)
    return delay_writeback(p, c_int(s).astype(jnp.int32), delay)


def composite_lowpass(i, q, *, ntsc: bool = True, dtype=jnp.float32):
    """NTSC chroma bandwidth: I 1.3MHz (delay 2), Q 0.6MHz (delay 4)
    (ffmpeg_ntsc.cpp:1429-1458). PAL in gen-2 uses the same constants."""
    i = _lowpass_plane(i, 1300000.0, 2, 3, dtype)
    q = _lowpass_plane(q, 600000.0, 4, 3, dtype)
    return i, q


def composite_lowpass_tv(i, q, dtype=jnp.float32):
    """Lighter CRT-style 2.6MHz/delay-1 filter (ffmpeg_ntsc.cpp:1399-1427)."""
    i = _lowpass_plane(i, 2600000.0, 1, 3, dtype)
    q = _lowpass_plane(q, 2600000.0, 1, 3, dtype)
    return i, q


# ----------------------------------------------------------------- QAM stage

def chroma_into_luma(y, i, q, xi, subcarrier_amplitude: int):
    """QAM-encode chroma onto luma (ffmpeg_ntsc.cpp:1460-1495).

    y,i,q: int32 [B,L,W]; xi: int32 [B,L]. Returns (y', 0, 0).
    The phase-dependent multiplier pattern is selected from a static [4,W]
    table via one-hot contraction (no gather).
    """
    w = y.shape[-1]
    um_t, vm_t = _qam_mult_tables(w)
    um = select_by_phase(xi, um_t)
    vm = select_by_phase(xi, vm_t)
    chroma = i * subcarrier_amplitude * um + q * subcarrier_amplitude * vm
    y = y + c_div(chroma, 50)
    zeros = jnp.zeros_like(i)
    return y, zeros, zeros


def _yc_separate(y):
    """4-tap sliding box blur with 2-pixel precharge (ffmpeg_ntsc.cpp:1506-1525).

    new_y[x] = trunc((y[x-1] + y[x] + y[x+1] + y[x+2]) / 4), zero-padded,
    chroma[x] = y_pad[x+2] - new_y[x].
    """
    pad = [(0, 0)] * (y.ndim - 1) + [(1, 2)]
    yp = jnp.pad(y, pad)  # index x+1 in yp == x in y
    w = y.shape[-1]
    sl = lambda o: jax.lax.dynamic_slice_in_dim(yp, o, w, axis=-1)
    total = sl(0) + sl(1) + sl(2) + sl(3)
    new_y = c_div(total, 4)
    chroma = sl(3) - new_y
    return new_y, chroma


def chroma_from_luma(y, i, q, xi, subcarrier_amplitude_back: int):
    """Y/C separation + QAM decode (ffmpeg_ntsc.cpp:1497-1567).

    Phase-dependent addressing is done with static [4,W] table selects and a
    barrel-shift rotation instead of per-sample gathers.
    """
    del i, q  # overwritten by decode
    b, l, w = y.shape

    new_y, chroma = _yc_separate(y)

    # Sign flip on the negative half-cycles (static mask per xi).
    flip = select_by_phase(xi, _flip_table(w, guard_x3=True)) != 0
    chroma = jnp.where(flip, -chroma, chroma)

    # Rescale back (integer division, trunc): chroma * 50 / amp_back.
    chroma = c_div(chroma * 50, subcarrier_amplitude_back)

    # Demux even samples into I,Q: I[x] = -chroma[x+xi], Q[x] = -chroma[x+xi+1]
    # for even x while x+xi+1 < w; later even samples are zero. chroma[x+xi]
    # = roll_rows(chroma, xi)[x]; wrapped values are masked off by `valid`.
    xe = jnp.arange(w, dtype=jnp.int32)
    is_even = (xe & 1) == 0
    r0 = roll_rows(chroma, xi, max_shift=3)
    gi = -r0
    gq = -jnp.roll(r0, -1, axis=-1)
    valid = select_by_phase(xi, _demux_valid_table(w)) != 0
    i_even = jnp.where(is_even & valid, gi, 0)
    q_even = jnp.where(is_even & valid, gq, 0)

    # Interpolate odd samples: I[x+1] = (I[x] + I[x+2]) >> 1 for even x while
    # x+2 < w; then the trailing samples from the first even x with x+2 >= w
    # are zeroed (ffmpeg_ntsc.cpp:1557-1564).
    def interp(p):
        left = p                                   # value at x-1 (even) when x odd
        right = jnp.roll(p, -2, axis=-1)           # value at x+1 (even)
        odd_val = (jnp.roll(left, 1, axis=-1) + jnp.roll(right, 1, axis=-1)) >> 1
        out = jnp.where(is_even, p, odd_val)
        # zero tail: loop C ends at first even x with x+2 >= w; loop D zeroes
        # from there to w-1.
        tail_start = w - 2 if w % 2 == 0 else w - 1
        out = jnp.where(xe >= tail_start, 0, out)
        return out

    return new_y, interp(i_even), interp(q_even)


# --------------------------------------------------------------- distortions

def composite_preemphasis_stage(y, pre_scale: float, pre_cut: float, dtype=jnp.float32):
    """Per-scanline 1-pole highpass emphasis (ffmpeg_ntsc.cpp:1613-1629)."""
    alpha = iir_alpha(NTSC_RATE, pre_cut)
    s = cascade_emph(y.astype(dtype), alpha, 16.0, 0, pre_scale)
    return c_int(s).astype(jnp.int32)


def video_noise_stage(y, keys, mag: int, dtype=jnp.float32):
    """Smoothed random-walk luma noise (ffmpeg_ntsc.cpp:1631-1644); the walk
    resets per scanline (statistical-parity deviation from the reference's
    field-continuous walk — see ops/noise.smoothed_noise_walk_rows). keys:
    [B] per-field keys
    (field_stage_keys) so noise is batch-invariant."""
    b, l, w = y.shape
    walk = smoothed_noise_walk_rows(keys, l, w, mag, dtype=dtype)
    return y + c_int(walk).astype(jnp.int32)


def chroma_noise_stage(i, q, keys, mag: int, dtype=jnp.float32):
    """ffmpeg_ntsc.cpp:1718-1735 — independent per-scanline walks on I and
    Q; keys: [B] per-field keys."""
    b, l, w = i.shape
    wk = c_int(chroma_noise_walk_rows(keys, l, w, mag,
                                      dtype=dtype)).astype(jnp.int32)
    return i + wk[:, 0], q + wk[:, 1]


def chroma_phase_noise_stage(i, q, keys, mag: int, gen1_bug: bool = False, dtype=jnp.float32):
    """Per-scanline random-walk phase rotation (ffmpeg_ntsc.cpp:1736-1764).

    gen1_bug reproduces ffmpeg_to_composite.cpp:772's rotation-matrix typo
    (u' = u*cos - u*sin; v' = v*cos + v*sin). keys: [B] per-field keys.
    """
    b, l, w = i.shape
    walk = random_walk_per_field(keys, l, mag, dtype=dtype)  # post-update
    pi_ang = c_int(walk) * jnp.asarray(jnp.pi / 100.0, dtype)
    s = jnp.sin(pi_ang)[..., None]
    c = jnp.cos(pi_ang)[..., None]
    u = i.astype(dtype)
    v = q.astype(dtype)
    if gen1_bug:
        u_ = u * c - u * s
        v_ = v * c + v * s
    else:
        u_ = u * c - v * s
        v_ = u * s + v * c
    return c_int(u_).astype(jnp.int32), c_int(v_).astype(jnp.int32)


def _head_switch_shift_schedule(ishif, l_start, num_lines, max_pre: int = 64):
    """Integer shift decay (ffmpeg_ntsc.cpp:1683-1712).

    Iteration k counts scanline steps from the switch line (which may sit
    above the visible area, so k at visible line l is l - l_start with
    l_start possibly negative). The C loop applies shif *before* updating it:
    applied(0)=0, applied(1)=ishif, applied(k)=trunc(applied(k-1)*7/8).
    """

    def step(carry, k):
        nxt = jnp.where(k == 0, ishif, c_div(carry * 7, 8).astype(jnp.int32))
        return nxt, carry

    ks = jnp.arange(num_lines + max_pre, dtype=jnp.int32)
    # carry init derives from ishif so its varying-axes type matches the
    # body output under shard_map (ishif is shard-local there)
    _, applied = jax.lax.scan(step, jnp.zeros_like(ishif), ks)
    idx = jnp.arange(num_lines, dtype=jnp.int32) - l_start
    safe = jnp.clip(idx, 0, num_lines + max_pre - 1)
    return jnp.where(idx >= 0, applied[safe], 0)


def head_switching_stage(
    y, field_parity, keys, *,
    point: float, phase: float, phase_noise: float,
    ntsc: bool = True, fill: int = 0, dtype=jnp.float32,
):
    """VHS head-switching bar (ffmpeg_ntsc.cpp:1646-1713).

    Rotates scanlines below the switch point within a virtual raster of width
    twidth = W + W/10, with per-line decaying shift. `fill` is the padding
    value beyond the active width (0 for gen-2 int YIQ, 16 for gen-1 luma u8).
    """
    b, l, w = y.shape
    twidth = w + w // 10
    # C semantics of the fmod/unsigned-cast geometry (sign-preserving fmod,
    # truncate-toward-zero then wrap mod 2^32 — ffmpeg_ntsc.cpp:1666-1670)
    # live in _head_switch_geometry.
    ishif, l_start = _head_switch_geometry(
        field_parity, keys, point=point, phase=phase,
        phase_noise=phase_noise, twidth=twidth, ntsc=ntsc, dtype=dtype)

    shifts = jax.vmap(lambda s, l0: _head_switch_shift_schedule(s, l0, l))(ishif, l_start)  # [B, L]

    # Only lines [l_start+1, l_start+~45] can have a nonzero shift (the 7/8
    # integer decay reaches 0 in <45 steps), so rotate just a WIN-line window
    # around the switch point instead of barrel-shifting the whole field.
    win = min(64, l)
    w0 = jnp.clip(l_start + 1, 0, l - win)  # [B]

    def one_field(yf, sf, start):
        zero = jnp.zeros((), start.dtype)
        ywin = jax.lax.dynamic_slice(yf, (start, zero), (win, w))
        swin = jax.lax.dynamic_slice(sf, (start,), (win,))
        padded = jnp.pad(ywin, [(0, 0), (0, twidth - w)], constant_values=fill)
        rotated = roll_rows(padded, swin)[..., :w]
        rotated = jnp.where(swin[:, None] != 0, rotated, ywin)
        return jax.lax.dynamic_update_slice(yf, rotated, (start, zero))

    return jax.vmap(one_field)(y, shifts, w0)


def _head_switch_geometry(field_parity, keys, *, point, phase, phase_noise,
                          twidth, ntsc, dtype):
    """(ishif, l_start) per field — the C fmod/unsigned-cast geometry of
    head_switching_stage."""
    tlines = 262.5 if ntsc else 312.5
    t = twidth * tlines
    b = field_parity.shape[0]
    if phase_noise != 0:
        noise = (uniform_pm1_per_field(keys, dtype)
                 * jnp.asarray(phase_noise, dtype))
    else:
        noise = jnp.zeros((b,), dtype)

    def c_wrap_u32(v):
        f = v - jnp.trunc(v)
        return jnp.trunc(f * t).astype(jnp.int32).astype(jnp.uint32)

    p_y = c_wrap_u32(point + noise)
    p_x = c_wrap_u32(phase + noise)
    vis_off = (262 - 240) * 2 if ntsc else (312 - 288) * 2
    y_start = ((p_y // np.uint32(twidth)).astype(jnp.int32) * 2
               + field_parity.astype(jnp.int32) - vis_off)
    x_pos = (p_x % np.uint32(twidth)).astype(jnp.int32)
    ishif = jnp.where(x_pos >= twidth // 2, x_pos - twidth, x_pos)
    l_start = (y_start - field_parity.astype(jnp.int32)) // 2
    return ishif, l_start


def chroma_dropout_stage(i, q, keys, loss: int):
    """Per-scanline chroma wipe: rand()%100000 < loss (ffmpeg_ntsc.cpp:1891-1901).
    keys: [B] per-field keys."""
    b, l, _ = i.shape
    r = randint_per_field(keys, (l,), 0, 100000)
    mask = (r < loss)[..., None]
    return jnp.where(mask, 0, i), jnp.where(mask, 0, q)


# ------------------------------------------------------------------ VHS block

def vhs_luma_lowpass(y, luma_cut: float, dtype=jnp.float32):
    """3-pass lowpass + same-cutoff highpass emphasis x1.6
    (ffmpeg_ntsc.cpp:1793-1812)."""
    alpha = iir_alpha(NTSC_RATE, luma_cut)
    s = cascade_emph(y.astype(dtype), alpha, 16.0, 3, 1.6)
    return c_int(s).astype(jnp.int32)


def vhs_chroma_lowpass(i, q, chroma_cut: float, chroma_delay: int, dtype=jnp.float32):
    """ffmpeg_ntsc.cpp:1814-1836 — gen-2 runs chroma at the full luma rate."""
    alpha = iir_alpha(NTSC_RATE, chroma_cut)
    si = iir_lowpass_cascade(i.astype(dtype), alpha, 0.0, 3)
    sq = iir_lowpass_cascade(q.astype(dtype), alpha, 0.0, 3)
    i = delay_writeback(i, c_int(si).astype(jnp.int32), chroma_delay)
    q = delay_writeback(q, c_int(sq).astype(jnp.int32), chroma_delay)
    return i, q


def vhs_chroma_vert_blend(i, q):
    """2-line chroma average over field lines (ffmpeg_ntsc.cpp:1838-1863).

    The reference's delay line starts at 0 and its loop begins on the *second*
    field line, so line 0 is untouched, line 1 blends with 0 (not with line 0
    — quirk preserved), and line l>=2 blends with the original line l-1:
    out[l] = (orig[l-1] + orig[l] + 1) >> 1.
    """
    def blend(p):
        first = jnp.zeros_like(p[:, :1])
        prev = jnp.concatenate([first, p[:, 1:-1]], axis=1)  # prev for lines 1..L-1
        blended = (prev + p[:, 1:] + 1) >> 1
        return jnp.concatenate([p[:, :1], blended], axis=1)
    return blend(i), blend(q)


def vhs_sharpen(y, luma_cut: float, sharpen: float, *, cut_mult: float = 4.0,
                gain: float = 2.0, y0: float = 0.0, dtype=jnp.float32):
    """Unsharp mask via 3-pass lowpass (ffmpeg_ntsc.cpp:1865-1883).

    Gen-2: cutoff x4, gain x2, reset 0. (Gen-1 uses x2/x1/reset 16 and also
    sharpens chroma — see yuv422.py.)
    """
    alpha = iir_alpha(NTSC_RATE, luma_cut * cut_mult)
    out = cascade_unsharp(y.astype(dtype), alpha, y0, 3, sharpen * gain)
    return c_int(out).astype(jnp.int32)


# ---------------------------------------------------------------- full chain

def composite_layer(
    y, i, q, *,
    cfg: CompositeConfig,
    fieldno,          # int32 [B]
    field_parity,     # int32 [B]
    key,
    dtype=jnp.float32,
):
    """Full gen-2 emulation chain on a batch of fields
    (ffmpeg_ntsc.cpp:1570-1921, stage order preserved).

    y,i,q: int32 [B, L, W] YIQ planes (Y scaled by 256).
    """
    b, l, w = y.shape
    xi = scanline_phase_xi(
        fieldno, field_parity, l,
        cfg.video_scanline_phase_shift, cfg.video_scanline_phase_shift_offset,
        cfg.ntsc, gen1=False,
    )
    # content-addressed noise: per (field, stage) keys -> output is
    # independent of batching (GOP size, restarts)
    keys = [field_stage_keys(key, fieldno, sid) for sid in range(5)]

    if cfg.composite_in_chroma_lowpass:
        i, q = composite_lowpass(i, q, ntsc=cfg.ntsc, dtype=dtype)

    y, i, q = chroma_into_luma(y, i, q, xi, cfg.subcarrier_amplitude)

    if cfg.composite_preemphasis != 0 and cfg.composite_preemphasis_cut > 0:
        y = composite_preemphasis_stage(
            y, cfg.composite_preemphasis, cfg.composite_preemphasis_cut, dtype)

    if cfg.video_noise != 0:
        y = video_noise_stage(y, keys[0], cfg.video_noise, dtype)

    if cfg.vhs_head_switching:
        y = head_switching_stage(
            y, field_parity, keys[1],
            point=cfg.vhs_head_switching_point,
            phase=cfg.vhs_head_switching_phase,
            phase_noise=cfg.vhs_head_switching_phase_noise,
            ntsc=cfg.ntsc, fill=0, dtype=dtype)

    if not cfg.nocolor_subcarrier:
        y, i, q = chroma_from_luma(y, i, q, xi, cfg.subcarrier_amplitude_back)

    if cfg.video_chroma_noise != 0:
        i, q = chroma_noise_stage(i, q, keys[2], cfg.video_chroma_noise, dtype)

    if cfg.video_chroma_phase_noise != 0:
        i, q = chroma_phase_noise_stage(
            i, q, keys[3], cfg.video_chroma_phase_noise,
            gen1_bug=cfg.chroma_phase_noise_gen1_bug, dtype=dtype)

    if cfg.emulating_vhs:
        speed = cfg.vhs_tape_speed
        y = vhs_luma_lowpass(y, speed.luma_cut, dtype)
        i, q = vhs_chroma_lowpass(i, q, speed.chroma_cut, speed.chroma_delay_gen2, dtype)
        if cfg.vhs_chroma_vert_blend and cfg.ntsc:
            i, q = vhs_chroma_vert_blend(i, q)
        y = vhs_sharpen(y, speed.luma_cut, cfg.vhs_out_sharpen, dtype=dtype)
        if not cfg.vhs_svideo_out:
            y, i, q = chroma_into_luma(y, i, q, xi, cfg.subcarrier_amplitude)
            y, i, q = chroma_from_luma(y, i, q, xi, cfg.subcarrier_amplitude)

    if cfg.video_chroma_loss != 0:
        i, q = chroma_dropout_stage(i, q, keys[4], cfg.video_chroma_loss)

    for _ in range(cfg.video_yc_recombine):
        y, i, q = chroma_into_luma(y, i, q, xi, cfg.subcarrier_amplitude)
        y, i, q = chroma_from_luma(y, i, q, xi, cfg.subcarrier_amplitude)

    if cfg.composite_out_chroma_lowpass:
        if cfg.composite_out_chroma_lowpass_lite:
            i, q = composite_lowpass_tv(i, q, dtype)
        else:
            i, q = composite_lowpass(i, q, ntsc=cfg.ntsc, dtype=dtype)

    return y, i, q


@functools.partial(jax.jit, static_argnames=("cfg", "dtype"))
def composite_layer_rgb(
    rgb,              # int32/uint8 [B, L, W, 3] field lines
    fieldno, field_parity, key, *,
    cfg: CompositeConfig,
    dtype=jnp.float32,
):
    """RGB field batch in, RGB field batch out (full chain), jitted."""
    rgb = jnp.asarray(rgb, jnp.int32)
    y, i, q = rgb_to_yiq(rgb[..., 0], rgb[..., 1], rgb[..., 2], dtype)
    y, i, q = composite_layer(
        y, i, q, cfg=cfg, fieldno=fieldno, field_parity=field_parity,
        key=key, dtype=dtype)
    r, g, b = yiq_to_rgb(y, i, q, dtype)
    return jnp.stack([r, g, b], axis=-1).astype(jnp.uint8)

