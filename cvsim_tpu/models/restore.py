"""Restoration/conversion tools: frameblend, filmac, vhsled.

- frameblend   frame-rate conversion by weighted temporal cross-blend
               (frameblend.cpp:929-1081): per output frame, source frames
               overlapping the output interval contribute their overlap as a
               16.16 fixed-point weight; optional near-rate squelch and
               gamma-linear blending via the reference's 256->8192 LUTs.
- filmac       film auto-contrast/AGC (filmac.cpp:880-1010): per-frame
               128x128 block scan over the [15%,90%) x [0,100%) window for
               block-mean min-channel and global max-channel, asymmetric
               temporal IIR of the levels, linear rescale in 16.16.
- vhsled       VHS capture de-jitter (ffmpeg_vhsled.cpp:838-977): per line,
               find the first run of 9 consecutive "non-blackish" pixels
               (vs the line's first pixel), 9-line box smoothing of the
               measured margins, shift each line left by the rounded margin.
"""

from __future__ import annotations

import numpy as np

# jax imports live inside the device functions: the restore tools' CLI
# paths run on host-numpy twins (models/tools_np.py) and must not pay the
# jax import (these are one-shot host processes)


# ------------------------------------------------------------------ gamma LUTs

def gamma_tables(gamma: float):
    """The reference's 8-bit -> 13-bit linearization tables
    (frameblend.cpp:697-732)."""
    dec = (np.power(np.arange(256) / 255.0, gamma) * 8192).astype(np.int64)
    enc = (np.power(np.arange(8193) / 8192.0, 1.0 / gamma) * 255).astype(np.int64)
    return dec, enc


# ------------------------------------------------------------------ frameblend

def frameblend_weights(frame_t, current: float, framealt: int = 1,
                       fullframealt: bool = False, squelch: bool = False):
    """Weight list for output interval [current, current+1) —
    frameblend.cpp:929-1023. Host-side (tiny)."""
    weights = []
    cutoff = 0
    n = len(frame_t)
    span = framealt if fullframealt else 1
    if n > 1:
        if framealt > 1:
            i = int(current % framealt)
            while (i + framealt) < n:
                bt, et = frame_t[i], frame_t[i + framealt]
                if i != 0 and (et + 2.0) < current:
                    cutoff = i - (i % framealt)
                bt = min(max(bt, current), current + span)
                et = min(max(et, current), current + span)
                if bt < et:
                    weights.append((i, (et - bt) / span))
                i += framealt
        else:
            for i in range(n - 1):
                bt, et = frame_t[i], frame_t[i + 1]
                if i != 0 and (et + 2.0) < current:
                    cutoff = i
                bt = min(max(bt, current), current + 1)
                et = min(max(et, current), current + 1)
                if bt < et:
                    weights.append((i, et - bt))
    if not weights and n > cutoff:
        weights.append((cutoff, 1.0))

    if squelch and len(weights) in (2, 3):
        bt = frame_t[weights[0][0]]
        et = frame_t[weights[1][0]]
        sq = abs((et - bt) - 1.0) / 0.01
        if sq < 1.0:
            sq = sq ** 2
            w0 = weights[0][1]
            if sq > 0.01:
                w0 = min(w0, sq) / sq
                weights[0] = (weights[0][0], w0)
                weights[1] = (weights[1][0], 1.0 - w0)
            else:
                weights[0] = (weights[0][0], 1.0)
                weights[1] = (weights[1][0], 0.0)
            if len(weights) > 2:
                weights[2] = (weights[2][0], 0.0)
    w16 = [(i, int(np.floor(w * 0x10000 + 0.5))) for i, w in weights]
    return w16, cutoff


def frameblend_mix(frames, w16, gamma_dec=None, gamma_enc=None):
    """Blend stacked RGB frames [K, H, W, 3] by 16.16 weights
    (frameblend.cpp:1032-1081)."""
    import jax.numpy as jnp

    fr = jnp.asarray(frames, jnp.int64)
    w = jnp.asarray([w for _, w in w16], jnp.int64)
    if gamma_dec is not None:
        fr = jnp.take(jnp.asarray(gamma_dec), fr, axis=0)
    acc = jnp.tensordot(w, fr, axes=(0, 0))  # [H, W, 3]
    acc = acc >> 16
    if gamma_enc is not None:
        acc = jnp.take(jnp.asarray(gamma_enc), jnp.clip(acc, 0, 8192), axis=0)
    return jnp.clip(acc, 0, 255).astype(jnp.int32)


# --------------------------------------------------------------------- filmac

class FilmacState:
    def __init__(self):
        self.init = False
        self.minv = 0
        self.maxv = 0


def filmac_measure(rgb, gamma_dec=None):
    """Block min/max levels of one frame in 16.16 (filmac.cpp:886-923).
    Returns (minv, maxv) python ints (host sync — tiny scalars)."""
    import jax.numpy as jnp

    f = jnp.asarray(rgb, jnp.int64)
    if gamma_dec is not None:
        f = jnp.take(jnp.asarray(gamma_dec), f, axis=0)
        scaleto = 0x10000 * 8192
    else:
        scaleto = 0x10000 * 256
    lf = f << 16
    h, w = lf.shape[:2]
    minx, maxx = (w * 15) // 100, (w * 90) // 100
    minv = scaleto * 6 // 10
    maxv = scaleto * 4 // 10

    pix_min = jnp.min(lf, axis=-1)
    pix_max = jnp.max(lf, axis=-1)
    blw = blh = 128
    # blocks start at minx + k*128 while < maxx and each spans to x0+128
    # clipped only by the frame width (filmac.cpp:904 guards x+sx against
    # output_width, not maxx) — BOTH the per-pixel max and the block mins
    # see pixels past maxx up to the last block's end
    xe = min(w, minx + (-(-(maxx - minx) // blw)) * blw)
    region_max = jnp.max(pix_max[:, minx:xe])
    maxv = max(maxv, int(region_max))

    # block means of per-pixel channel-min over 128x128 blocks
    block_mins = []
    for y0 in range(0, h, blh):
        for x0 in range(minx, maxx, blw):
            blk = pix_min[y0:min(y0 + blh, h), x0:min(x0 + blw, w)]
            grd = blk.size
            s = int(jnp.sum(blk))
            block_mins.append((s + grd // 2) // grd)
    if block_mins:
        minv = min(minv, min(block_mins))
    if minv == maxv:
        maxv += 1
    return minv, maxv, scaleto


def filmac_update_levels(state: FilmacState, minv: int, maxv: int):
    """Asymmetric temporal smoothing (filmac.cpp:927-942): max rises fast
    (avg/2) and falls slow (4:1); min falls fast and rises slow."""
    if not state.init:
        state.init = True
        state.minv, state.maxv = minv, maxv
    else:
        if state.maxv < maxv:
            state.maxv = (state.maxv + maxv) // 2
        else:
            state.maxv = (state.maxv * 4 + maxv) // 5
        if state.minv > minv:
            state.minv = (state.minv + minv) // 2
        else:
            state.minv = (state.minv * 4 + minv) // 5
    return state


def filmac_rescale(rgb, state: FilmacState, scaleto: int,
                   gamma_dec=None, gamma_enc=None):
    """Linear level rescale (filmac.cpp:946-954, output at :980-1009)."""
    import jax.numpy as jnp

    f = jnp.asarray(rgb, jnp.int64)
    if gamma_dec is not None:
        f = jnp.take(jnp.asarray(gamma_dec), f, axis=0)
    lf = f << 16
    span = max(1, state.maxv - state.minv)
    v = (lf - state.minv) * scaleto // span
    v = jnp.clip(v, -0x7FFFFFFF, 0x7FFFFFFF)
    v = jnp.maximum(v >> 16, 0)
    if gamma_enc is not None:
        v = jnp.take(jnp.asarray(gamma_enc), jnp.clip(v, 0, 8192), axis=0)
    return jnp.clip(v, 0, 255).astype(jnp.int32)


# --------------------------------------------------------------------- vhsled

def vhsled_dejitter(rgb):
    """Left-edge de-jitter of one RGB frame [H, W, 3]
    (ffmpeg_vhsled.cpp:866-928).

    blackish(p, ref) preserves the reference's quirk of comparing every
    channel of p against the *blue* channel of the line's first pixel
    (the `c >>= 8` typo at :686 shifts the diff, not ref).
    """
    import jax.numpy as jnp

    from cvsim_tpu.ops.roll import roll_rows

    f = jnp.asarray(rgb, jnp.int32)
    h, w = f.shape[:2]
    ref_blue = f[:, 0:1, 2]            # ARGB blue = lowest byte = our [...,2]
    # blackish: all three channels have (chan - ref_blue) < 16
    nb = jnp.any((f - ref_blue[..., None]) >= 16, axis=-1)  # non-blackish

    # first run of 9 consecutive non-blackish pixels per row
    runs = nb
    for k in range(1, 9):
        shifted = jnp.pad(nb[:, k:], ((0, 0), (0, k)))
        runs = runs & shifted
    any_run = jnp.any(runs, axis=1)
    start = jnp.argmax(runs, axis=1)
    adj = jnp.where(any_run, start, w) << 16      # adj[y] = x << 16

    # 9-line box smoothing for y in [4, h-4)
    adjf = adj
    window = sum(jnp.roll(adj, -k) for k in range(-4, 5))
    sm = (window + 5) // 9
    ys = jnp.arange(h)
    adj2 = jnp.where((ys >= 4) & (ys < h - 4), sm, adjf)

    x = (adj2 + 0x8000) >> 16
    x = jnp.clip(x, 0, None)
    shift = jnp.where(x >= w // 2, 0, x)

    # shift left by x: out[0..w-x) = in[x..w); tail keeps original
    rolled = roll_rows(jnp.moveaxis(f, -1, 0), shift[None, :])
    xs = jnp.arange(w)
    keep_tail = xs[None, :] >= (w - shift[:, None])
    out = jnp.where(keep_tail[None], jnp.moveaxis(f, -1, 0), rolled)
    return jnp.moveaxis(out, 0, -1)
