"""Gen-1 composite engine: 8-bit YUV 4:2:2 "fake YIQ" (ffmpeg_to_composite.cpp).

Works on batches of fields: int32 arrays y [B, L, W] and u, v [B, L, W//2]
holding uint8-range values. Every stage re-quantizes through clampu8 exactly
where the reference writes back to its u8 planes, so golden tests can demand
<=1 LSB agreement (float64) / tight tolerance (float32).

Reference functions reimplemented here:
- composite_video_chroma_lowpass[_lite]  ffmpeg_to_composite.cpp:353-431
- composite_video_yuv_to_ntsc            ffmpeg_to_composite.cpp:434-477
- composite_ntsc_to_yuv                  ffmpeg_to_composite.cpp:480-553
- composite_video_process (orchestrator) ffmpeg_to_composite.cpp:629-952
- black_key_feedback                     ffmpeg_to_composite.cpp:954-999
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cvsim_tpu.config import CompositeConfig, NTSC_RATE, NTSC_RATE_422, iir_alpha
from cvsim_tpu.ops.cmath import c_div, c_int, clampu8
from cvsim_tpu.ops.iir import (
    cascade_emph,
    cascade_unsharp,
    delay_writeback,
    iir_lowpass_cascade,
    iir_highpass,
)
from cvsim_tpu.ops.noise import (
    field_stage_keys,
    chroma_noise_walk_rows,
    randint_per_field,
    random_walk_per_field,
    smoothed_noise_walk_rows,
)
from cvsim_tpu.ops.phase import scanline_phase_xi
from cvsim_tpu.models.yiq import (
    head_switching_stage,
    _qam_mult_tables,
    _flip_table,
)
from cvsim_tpu.ops.roll import select_by_phase

_U8 = lambda s: clampu8(s).astype(jnp.int32)


# ------------------------------------------------------------ chroma lowpass

def chroma_lowpass(u, v, *, ntsc: bool = True, dtype=jnp.float32):
    """composite_video_chroma_lowpass (ffmpeg_to_composite.cpp:353-393):
    per chroma plane, a half-cutoff highpass "ringing" stage (s += hp(s))
    followed by 3 cascaded lowpasses, with delayed clampu8 writeback."""

    def one(p, cutoff, delay):
        alpha_hp = iir_alpha(NTSC_RATE_422, cutoff / 2)
        alpha_lp = iir_alpha(NTSC_RATE_422, cutoff)
        s = p.astype(dtype)
        s = s + iir_highpass(s, alpha_hp, 128.0)
        s = iir_lowpass_cascade(s, alpha_lp, 128.0, 3)
        return delay_writeback(p, _U8(s), delay)

    if ntsc:
        u = one(u, 1300000.0, 2)
        v = one(v, 600000.0, 4)
    else:
        u = one(u, 1300000.0, 2)
        v = one(v, 1300000.0, 2)
    return u, v


def chroma_lowpass_lite(u, v, dtype=jnp.float32):
    """_lite variant (ffmpeg_to_composite.cpp:395-431): 3 lowpasses at
    rate/4 cutoff, delay 1, no highpass stage."""

    def one(p):
        alpha = iir_alpha(NTSC_RATE_422, NTSC_RATE_422 / 4)
        s = iir_lowpass_cascade(p.astype(dtype), alpha, 128.0, 3)
        return delay_writeback(p, _U8(s), 1)

    return one(u), one(v)


# ----------------------------------------------------------------- QAM stage

def yuv_to_ntsc(y, u, v, xi, subcarrier_amplitude: int, nocolor_subcarrier: bool = False):
    """QAM-encode 4:2:2 chroma into luma (ffmpeg_to_composite.cpp:434-477)."""
    w = y.shape[-1]
    um_t, vm_t = _qam_mult_tables(w)
    um = select_by_phase(xi, um_t)
    vm = select_by_phase(xi, vm_t)
    u2 = jnp.repeat(u, 2, axis=-1) - 128
    v2 = jnp.repeat(v, 2, axis=-1) - 128
    chroma = u2 * subcarrier_amplitude * um + v2 * subcarrier_amplitude * vm
    y = _U8(y + c_div(chroma, 50))
    if nocolor_subcarrier:
        u = jnp.full_like(u, 128)
        v = jnp.full_like(v, 128)
    return y, u, v


def ntsc_to_yuv(y, u, v, xi, subcarrier_amplitude_back: int,
                nocolor_subcarrier_after_yc_sep: bool = False):
    """Y/C separation + QAM decode (ffmpeg_to_composite.cpp:480-553).

    Box blur with 16-precharge: new_y[x] = (y[x-1]+y[x]+y[x+1]+y[x+2])/4
    (u8 sums, floor), pad value 16; chroma[x] = clampu8(y_pad[x+2]+128-new_y[x]).
    """
    b, l, w = y.shape
    pad = [(0, 0)] * (y.ndim - 1) + [(1, 2)]
    yp = jnp.pad(y, pad, constant_values=16)
    sl = lambda o: jax.lax.dynamic_slice_in_dim(yp, o, w, axis=-1)
    new_y = (sl(0) + sl(1) + sl(2) + sl(3)) // 4   # all positive: floor==trunc
    chroma = _U8(sl(3) + 128 - new_y)

    if nocolor_subcarrier_after_yc_sep:
        # debug tap: show separated chroma as luma (:504-509)
        return chroma, jnp.full_like(u, 128), jnp.full_like(v, 128)

    # sign flip (255 - c) on the negative half-cycles (:529-532); loop guard is
    # x < w (positions x+2, x+3 may exceed w in C — we flip in-range only).
    flip = select_by_phase(xi, _flip_table(w, guard_x3=False)) != 0
    chroma = jnp.where(flip, 255 - chroma, chroma)

    # rescale by 50/amp_back around the 128 bias (:534-536)
    chroma = _U8(c_div((chroma - 128) * 50, subcarrier_amplitude_back) + 128)

    # demux alternate samples into U,V with phase-dependent swap (:539-550)
    ce = chroma[..., 0::2]
    co = chroma[..., 1::2]
    odd_phase = (xi[..., None] & 1) == 1
    new_u = jnp.where(odd_phase, 255 - co, 255 - ce)
    new_v = jnp.where(odd_phase, 255 - ce, 255 - co)
    return new_y, new_u, new_v


# --------------------------------------------------------------- distortions

def composite_preemphasis_stage(y, pre_scale: float, pre_cut: float, dtype=jnp.float32):
    """ffmpeg_to_composite.cpp:636-650."""
    alpha = iir_alpha(NTSC_RATE, pre_cut)
    s = cascade_emph(y.astype(dtype), alpha, 16.0, 0, pre_scale)
    return _U8(s)


def video_noise_stage(y, keys, mag: int, dtype=jnp.float32):
    """ffmpeg_to_composite.cpp:653-665 (clampu8 at every sample); the walk
    resets per scanline (see ops/noise.smoothed_noise_walk_rows). keys: [B]
    per-field keys."""
    b, l, w = y.shape
    walk = smoothed_noise_walk_rows(keys, l, w, mag, dtype=dtype)
    return _U8(y + c_int(walk).astype(jnp.int32))


def chroma_noise_stage(u, v, keys, mag: int, dtype=jnp.float32):
    """ffmpeg_to_composite.cpp:738-754 (independent per-scanline walks for
    the two planes); keys: [B] per-field keys."""
    b, l, w2 = u.shape
    wk = c_int(chroma_noise_walk_rows(keys, l, w2, mag,
                                      dtype=dtype)).astype(jnp.int32)
    return _U8(u + wk[:, 0]), _U8(v + wk[:, 1])


def chroma_phase_noise_stage(u, v, keys, mag: int, dtype=jnp.float32):
    """ffmpeg_to_composite.cpp:755-780 — keeps the reference's rotation-matrix
    bug (u' = u*cos - u*sin, v' = v*cos + v*sin). keys: [B] per-field."""
    b, l, _ = u.shape
    walk = random_walk_per_field(keys, l, mag, dtype=dtype)
    ang = c_int(walk) * jnp.asarray(jnp.pi / 100.0, dtype)
    s = jnp.sin(ang)[..., None]
    c = jnp.cos(ang)[..., None]
    uu = (u - 128).astype(dtype)
    vv = (v - 128).astype(dtype)
    u_ = uu * c - uu * s
    v_ = vv * c + vv * s
    return _U8(u_ + 128), _U8(v_ + 128)


def chroma_dropout_stage(u, v, keys, loss: int):
    """ffmpeg_to_composite.cpp:931-941 — wiped lines go to neutral 128.
    keys: [B] per-field keys."""
    b, l, _ = u.shape
    r = randint_per_field(keys, (l,), 0, 100000)
    mask = (r < loss)[..., None]
    return jnp.where(mask, 128, u), jnp.where(mask, 128, v)


# ------------------------------------------------------------------ VHS block

def vhs_luma_lowpass(y, luma_cut: float, dtype=jnp.float32):
    """ffmpeg_to_composite.cpp:809-828."""
    alpha = iir_alpha(NTSC_RATE, luma_cut)
    s = cascade_emph(y.astype(dtype), alpha, 16.0, 3, 1.6)
    return _U8(s)


def vhs_chroma_lowpass(u, v, chroma_cut: float, chroma_delay: int, dtype=jnp.float32):
    """ffmpeg_to_composite.cpp:830-852 (4:2:2 rate, 128 reset)."""
    alpha = iir_alpha(NTSC_RATE_422, chroma_cut)

    def one(p):
        s = iir_lowpass_cascade(p.astype(dtype), alpha, 128.0, 3)
        return delay_writeback(p, _U8(s), chroma_delay)

    return one(u), one(v)


def vhs_chroma_vert_blend(u, v, init: int = 128):
    """2-line average over field lines (ffmpeg_to_composite.cpp:859-879).

    The reference's delay line starts at `init` and the loop begins at the
    *second* field line, so line 0 is untouched, line 1 blends with `init`
    (not with line 0 — quirk preserved), and line l>=2 blends with the
    original line l-1.
    """

    def blend(p):
        first = jnp.full_like(p[:, :1], init)
        prev = jnp.concatenate([first, p[:, 1:-1]], axis=1)  # prev for lines 1..L-1
        blended = (prev + p[:, 1:] + 1) >> 1
        return jnp.concatenate([p[:, :1], blended], axis=1)

    return blend(u), blend(v)


def vhs_sharpen_luma(y, luma_cut: float, sharpen: float, dtype=jnp.float32):
    """ffmpeg_to_composite.cpp:882-898: unsharp vs 3-pass lowpass at 2x cut."""
    alpha = iir_alpha(NTSC_RATE, luma_cut * 2)
    return _U8(cascade_unsharp(y.astype(dtype), alpha, 16.0, 3, sharpen))


def vhs_sharpen_chroma(u, v, chroma_cut: float, sharpen: float, dtype=jnp.float32):
    """ffmpeg_to_composite.cpp:900-923."""
    alpha = iir_alpha(NTSC_RATE_422, chroma_cut * 2)

    def one(p):
        return _U8(cascade_unsharp(p.astype(dtype), alpha, 128.0, 3, sharpen))

    return one(u), one(v)


# ---------------------------------------------------------------- full chain

def composite_video_process(
    y, u, v, *,
    cfg: CompositeConfig,
    fieldno,          # int32 [B]
    field_parity,     # int32 [B]
    key,
    dtype=jnp.float32,
):
    """Full gen-1 chain on a batch of fields
    (composite_video_process, ffmpeg_to_composite.cpp:629-952)."""
    b, l, w = y.shape
    xi = scanline_phase_xi(
        fieldno, field_parity, l,
        cfg.video_scanline_phase_shift, cfg.video_scanline_phase_shift_offset,
        cfg.ntsc, gen1=True,
    )
    keys = [field_stage_keys(key, fieldno, sid) for sid in range(5)]

    if cfg.composite_in_chroma_lowpass:
        u, v = chroma_lowpass(u, v, ntsc=cfg.ntsc, dtype=dtype)

    y, u, v = yuv_to_ntsc(y, u, v, xi, cfg.subcarrier_amplitude, cfg.nocolor_subcarrier)

    if cfg.composite_preemphasis != 0 and cfg.composite_preemphasis_cut > 0:
        y = composite_preemphasis_stage(
            y, cfg.composite_preemphasis, cfg.composite_preemphasis_cut, dtype)

    if cfg.video_noise != 0:
        y = video_noise_stage(y, keys[0], cfg.video_noise, dtype)

    if cfg.vhs_head_switching:
        # gen-1 derives both x and y of the switch point from one phase
        # (ffmpeg_to_composite.cpp:687-689); luma pad is black (16).
        y = head_switching_stage(
            y, field_parity, keys[1],
            point=cfg.vhs_head_switching_point,
            phase=cfg.vhs_head_switching_point,
            phase_noise=cfg.vhs_head_switching_phase_noise,
            ntsc=cfg.ntsc, fill=16, dtype=dtype)

    if not cfg.nocolor_subcarrier:
        y, u, v = ntsc_to_yuv(y, u, v, xi, cfg.subcarrier_amplitude_back,
                              cfg.nocolor_subcarrier_after_yc_sep)

    if cfg.video_chroma_noise != 0:
        u, v = chroma_noise_stage(u, v, keys[2], cfg.video_chroma_noise, dtype)

    if cfg.video_chroma_phase_noise != 0:
        u, v = chroma_phase_noise_stage(u, v, keys[3], cfg.video_chroma_phase_noise, dtype)

    if cfg.emulating_vhs:
        speed = cfg.vhs_tape_speed
        y = vhs_luma_lowpass(y, speed.luma_cut, dtype)
        u, v = vhs_chroma_lowpass(u, v, speed.chroma_cut, speed.chroma_delay_gen1, dtype)
        if cfg.vhs_chroma_vert_blend and cfg.ntsc:
            u, v = vhs_chroma_vert_blend(u, v)
        y = vhs_sharpen_luma(y, speed.luma_cut, cfg.vhs_out_sharpen, dtype)
        u, v = vhs_sharpen_chroma(u, v, speed.chroma_cut, cfg.vhs_out_sharpen_chroma, dtype)
        if not cfg.vhs_svideo_out:
            y, u, v = yuv_to_ntsc(y, u, v, xi, cfg.subcarrier_amplitude)
            y, u, v = ntsc_to_yuv(y, u, v, xi, cfg.subcarrier_amplitude)

    if cfg.video_chroma_loss != 0:
        u, v = chroma_dropout_stage(u, v, keys[4], cfg.video_chroma_loss)

    for _ in range(cfg.video_yc_recombine):
        y, u, v = yuv_to_ntsc(y, u, v, xi, cfg.subcarrier_amplitude)
        y, u, v = ntsc_to_yuv(y, u, v, xi, cfg.subcarrier_amplitude)

    if cfg.composite_out_chroma_lowpass:
        u, v = chroma_lowpass(u, v, ntsc=cfg.ntsc, dtype=dtype)
    elif cfg.composite_out_chroma_lowpass_lite:
        u, v = chroma_lowpass_lite(u, v, dtype)

    return y, u, v


composite_video_process_jit = functools.partial(
    jax.jit, static_argnames=("cfg", "dtype"))(
        lambda y, u, v, fieldno, field_parity, key, cfg, dtype=jnp.float32:
            composite_video_process(
                y, u, v, cfg=cfg, fieldno=fieldno, field_parity=field_parity,
                key=key, dtype=dtype))



# ---------------------------------------------------------- black key stage

def black_key_feedback(y, u, v, fy, fu, fv, level: int):
    """Hall-of-mirrors keying vs a persistent filter frame
    (ffmpeg_to_composite.cpp:954-999). Keys where
    (Y - 16 - level) + (|U+V-256| - level) <= 0. The even sample of each
    4:2:2 pair is keyed against the pair's original chroma and, when keyed,
    REPLACES that chroma with the filter frame's (black_key wchroma=true,
    :959-964); the odd sample's decision then reads the possibly-replaced
    chroma (the in-place sequential order at :989-990). Returns
    (out planes, new filter planes)."""
    y_even = y[..., 0::2]
    y_odd = y[..., 1::2]
    keyed_even = ((y_even - (16 + level))
                  + (jnp.abs(u + v - 256) - level)) <= 0
    out_u = jnp.where(keyed_even, fu, u)
    out_v = jnp.where(keyed_even, fv, v)
    keyed_odd = ((y_odd - (16 + level))
                 + (jnp.abs(out_u + out_v - 256) - level)) <= 0
    out_even = jnp.where(keyed_even, fy[..., 0::2], y_even)
    out_odd = jnp.where(keyed_odd, fy[..., 1::2], y_odd)
    out_y = jnp.stack([out_even, out_odd], axis=-1).reshape(y.shape)
    return (out_y, out_u, out_v), (out_y, out_u, out_v)
