"""Device ops for the sibling pixel tools.

Each function is a pure, jittable transform over RGB frames [H, W, 3] (or a
batch [B, H, W, 3]); stateful tools (delay rings, feedback canvases) thread
their state explicitly.

Reference semantics:
- posterize       ffmpeg_posterize.cpp:789-813 (bitwise AND mask, not
                  levels+rescale — rationale comment :2-5)
- colormap        ffmpeg_colormap.cpp:785-822 (256-entry LUT from the middle
                  scanline of a map image, indexed by the green channel)
- colorkey        ffmpeg_colorkey.cpp:832-887 (|dR|+|dG|+|dB| threshold vs a
                  key color, -inv, -noise punch-through, -xd horizontal
                  subsampled decisions, -f fade for feedback trails)
- average_delay   ffmpeg_average_delay.cpp:801-838 (temporal blend with
                  ordered dither ((x^y)+efield)&3)
- scanimate       ffmpeg_scanimate.cpp:817-985 (CRT phosphor-dot re-render
                  with 4 cycling raster-warp effects)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cvsim_tpu.ops import noise
from cvsim_tpu.ops.cmath import c_div


# ------------------------------------------------------------------ posterize

def posterize(rgb, threshhold: int):
    """out = channel & ((0xFF << (8 - thr)) & 0xFF)."""
    shr = 8 - threshhold
    mask = (0xFF << shr) & 0xFF
    return jnp.asarray(rgb, jnp.int32) & mask


# ------------------------------------------------------------------- colormap

from cvsim_tpu.models.tools_np import take_colormap  # noqa: F401 (host numpy)


def colormap_apply(rgb, lut):
    """Map the green channel through the LUT (ffmpeg_colormap.cpp:802-822)."""
    g = jnp.asarray(rgb, jnp.int32)[..., 1]
    return jnp.take(jnp.asarray(lut, jnp.int32), g, axis=0)


# ------------------------------------------------------------------- colorkey

def colorkey_apply(dst, src, key, *, color: tuple, threshhold: int,
                   invert: bool = False, noisekey: int = 0, fade: int = 0,
                   xdivr: int = 1):
    """One layer of retro color keying over a persistent canvas.

    dst, src: int32 [H, W, 3]. Returns the new canvas (which is also the
    output frame — the delay ring lives in the caller).
    """
    dst = jnp.asarray(dst, jnp.int32)
    src = jnp.asarray(src, jnp.int32)
    kc = jnp.asarray(color, jnp.int32)
    d = jnp.abs(src - kc).sum(axis=-1)  # [H, W]

    if xdivr > 1:
        # decision made on every xdivr'th pixel and held ("older equipment")
        w = d.shape[-1]
        held = d[..., (np.arange(w) // xdivr) * xdivr]
        d = held

    if noisekey > 0:
        # content-addressed splitmix32 stream (same reasons as the engine
        # noise, ops/noise.py docstring): bit-identical between this jax
        # path and the host-numpy CLI path (tools_np.colorkey_apply)
        r = noise.randint_stream(key, d.shape, 0, 20001)
        hit = r < noisekey
        if xdivr > 1:
            # the reference's noise overrides the HELD decision variable d
            # (ffmpeg_colorkey.cpp:861-864 mutate d in place), so a hit
            # persists for the remaining pixels of its xdivr group —
            # punch-through streaks up to xdivr long, not 1-pixel specks:
            # prefix-OR within each group
            w = d.shape[-1]
            pad = -w % xdivr
            hp = (jnp.concatenate(
                [hit, jnp.zeros(hit.shape[:-1] + (pad,), bool)], axis=-1)
                if pad else hit)
            hp = hp.reshape(hit.shape[:-1] + (-1, xdivr)).astype(jnp.int32)
            hp = jax.lax.cummax(hp, axis=hp.ndim - 1)
            hit = (hp.reshape(hit.shape[:-1] + (w + pad,)) > 0)[..., :w]
        d = jnp.where(hit, 0xFFFF, d)

    if fade != 0:
        dst = (dst * (256 - fade)) >> 8

    if invert:
        keyed = d < threshhold
    else:
        keyed = d >= threshhold
    return jnp.where(keyed[..., None], src, dst)


# -------------------------------------------------------------- average_delay

def average_delay_blend(dst, src, field: int, *, newlevel: int, delay: int):
    """out = (src*n + dst*(256-n) + dither) >> 8 with ordered dither
    (((x^y)+efield)&3)*255/3 (ffmpeg_average_delay.cpp:817-838)."""
    dst = jnp.asarray(dst, jnp.int32)
    src = jnp.asarray(src, jnp.int32)
    h, w = dst.shape[:2]
    efield = field // delay
    xs = np.arange(w)[None, :]
    ys = np.arange(h)[:, None]
    dither = c_div((((jnp.asarray(xs ^ ys, jnp.int32) + efield) & 3) * 255), 3)
    acc = src * newlevel + dst * (256 - newlevel) + dither[..., None]
    return acc >> 8


# ----------------------------------------------------------------- scanimate

def _scanimate_warp(sx, sy, signal, fieldno, frame_t):
    """The 4 cycling built-in effects (scanimate_modify_raster,
    ffmpeg_scanimate.cpp:859-894). Vectorized over the dot arrays."""
    effect_idx = fieldno // (60 * 3)
    ef_field = fieldno - effect_idx * (60 * 3)
    effect = effect_idx % 4
    two_pi = 2.0 * jnp.pi

    def trapezoid(sx, sy, sig):
        ef_t = ef_field / (60.0 * 3.0)
        k = (((sy + 1.0) / 2.0) * (1.0 - ef_t)) + ef_t
        return sx * k, sy, sig * k

    def vrotate(sx, sy, sig):
        ef_t = ef_field / (60.0 * 3.0)
        return sx, sy * (1.0 - ef_t * 2.0), sig * jnp.abs(1.0 - ef_t * 2.0)

    def vstretch(sx, sy, sig):
        ef_t = ef_field / (60.0 * 3.0)
        return sx, sy * (1.0 + ef_t * 12.0), sig

    def diffuse(sx, sy, sig):
        ef_t = jnp.sin(ef_field * two_pi / 59.94)
        return (sx + jnp.sin(frame_t * two_pi * 6) * ef_t * 0.1,
                sy + jnp.cos(frame_t * two_pi * 6) * ef_t * 0.1, sig)

    return jax.lax.switch(effect.astype(jnp.int32),
                          [trapezoid, vrotate, vstretch, diffuse],
                          sx, sy, signal)


def scanimate_field(src_rgb, dst_h: int, dst_w: int, field: int, fieldno,
                    input_ntsc: bool = False, precision: int = 1):
    """Re-render a source frame as CRT phosphor dots at warped positions
    (composite_layer, ffmpeg_scanimate.cpp:894-985).

    Returns a grayscale int32 [dst_h, dst_w] raster (>>precision, clamped at
    255 by the caller's RGB packing).
    """
    src = jnp.asarray(src_rgb, jnp.int32)
    src_h, src_w = src.shape[:2]
    ystep = 2 if input_ntsc else 1
    y0 = field if input_ntsc else 0

    ys = np.arange(y0, src_h, ystep)
    xs = np.arange(src_w << precision)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    n = yy.size
    yy = yy.reshape(-1)
    xx = xx.reshape(-1)

    sx = (xx * 2.0) / (src_w << precision) - 1.0
    sy = (yy * 2.0) / src_h - 1.0
    sy = sy + ((xx * float(ystep)) / (src_w << precision)) / src_h  # CRT slant

    if input_ntsc:
        dot_radius = (dst_h * 2.05) / src_h
    else:
        dot_radius = (dst_h * 1.05) / src_h

    g = src[yy, xx >> precision, 1].astype(jnp.float32) / 255.0
    frame_t = (yy * src_w * (1 << precision) + xx).astype(np.float64) / (
        src_w * src_h * (1 << precision))

    sigscal = (dst_w / src_w) * (dst_h / src_h) * 0.9
    sxj = jnp.asarray(sx, jnp.float32)
    syj = jnp.asarray(sy, jnp.float32)
    sxj, syj, sig = _scanimate_warp(sxj, syj, g, jnp.asarray(fieldno),
                                    jnp.asarray(frame_t, jnp.float32))
    radius = jnp.maximum(jnp.float32(dot_radius), 1.2)
    sig = jnp.clip(sig * sigscal, 0.0, 32.0) / radius

    # screen coords
    px = (sxj + 1.0) * dst_w / 2.0
    py = (syj + 1.0) * dst_h / 2.0

    # splat each dot over a fixed stamp around its center (cone falloff,
    # additive). stamp size covers ceil(2*radius)+2.
    r_int = int(np.ceil(float(dot_radius if dot_radius > 1.2 else 1.2)))
    rows = len(ys)
    cols = src_w << precision
    # The scatter stamp spans offsets -r..r+1, but offset d contributes only
    # if |d - frac(center)| < radius for some frac in [0,1), i.e. d in
    # (-radius, radius+1) = integers -(ceil(r)-1)..ceil(r): the outer ring
    # the reference's loop visits is identically zero, so the matmul splat
    # uses the tight 2*ceil(r) stamp (bit-equal by construction).
    s = 2 * r_int
    # band height: stamp s plus the worst within-source-row screen-y spread:
    # vstretch scales sy by up to 13x; the within-row sy spread is the CRT
    # slant (ystep/src_h) times that, in output rows x dst_h/2; the diffuse
    # wobble's within-row variation is smaller (~0.94x the same unit).
    # Violations degrade gracefully (dots drop, exactly as the scatter
    # version drops out-of-bounds dots) — they cannot corrupt.
    spread = int(np.ceil(6.5 * ystep * dst_h / src_h)) + 2
    band = -(-(s + spread) // 8) * 8
    raster = _splat_matmul(
        px.reshape(rows, cols), py.reshape(rows, cols),
        sig.reshape(rows, cols), radius, r_int, dst_h, dst_w, band=band)
    return raster >> precision


def _splat_scatter(px, py, sig, radius, r_int: int, dst_h: int, dst_w: int):
    """Reference splat: S^2 unrolled scatter-adds over flat dot arrays.
    Kept as the equivalence oracle for _splat_matmul (which is bit-exact:
    the per-stamp values are truncated to int before any summation, and
    integer addition is order-free)."""
    offs = np.arange(-r_int, r_int + 2)
    raster = jnp.zeros((dst_h * dst_w,), jnp.int32)
    base_x = jnp.floor(px).astype(jnp.int32)
    base_y = jnp.floor(py).astype(jnp.int32)
    for dy in offs:
        for dx in offs:
            ix = base_x + dx
            iy = base_y + dy
            ddx = ix.astype(jnp.float32) - px
            ddy = iy.astype(jnp.float32) - py
            fv = sig * ((radius - jnp.sqrt(ddx * ddx + ddy * ddy)) / radius)
            val = (fv * 255.0).astype(jnp.int32)
            ok = (fv > 0) & (ix >= 0) & (ix < dst_w) & (iy >= 0) & (iy < dst_h)
            flat = jnp.where(ok, iy * dst_w + ix, 0)
            raster = raster.at[flat].add(jnp.where(ok, val, 0))
    return raster.reshape(dst_h, dst_w)


def _splat_matmul(px, py, sig, radius, r_int: int, dst_h: int, dst_w: int,
                  band: int = 48, row_chunk: int = 4):
    """Phosphor splat as one-hot selection matmuls instead of S^2
    serialized scatter passes (whose trace and runtime grew with the stamp
    area).

    Structure: dots come from source rows whose warped screen-y spread is
    small (the 4 scanimate warps scale/shift whole rows; only the CRT slant
    and the diffuse wobble vary within a row, < ~30 output rows at 12x
    stretch), so each source row rasterizes into a BAND-row strip:

      band[by, X] = sum_d sum_(sy,sx) V[d, sy, sx]
                        * [by == iy0_d - y_lo + sy] * [X == ix0_d + sx]

    The sy selection is a dense gather (BAND x S window), the sx/X
    selection is ONE [S*BAND, C] @ [C, W+S] matmul against a 0/1 column
    one-hot, and the strips are summed into the raster with a scan of
    dynamic-slice adds. Stamp values are truncated to integers BEFORE any
    accumulation and every sum stays < 2^24, so f32 matmul accumulation is
    exact and summation order is irrelevant; the only deviation from
    _splat_scatter is XLA fusing fv's multiply-adds differently between the
    two graphs, which can flip trunc(fv*255) by 1 when fv sits within an
    ULP of a multiple of 1/255 (observed <1e-4 of pixels, always +-1).
    """
    rows, cols = px.shape
    s = 2 * r_int        # tight stamp: offsets -(r_int-1)..r_int inclusive
    assert band >= 2 * s, "band must cover at least the stamp height"
    we = dst_w + s       # one-hot grid: leftmost stamp column + s
    wo = dst_w + 2 * s   # shifted-accumulation grid
    pad_y = band + s

    ix0 = jnp.floor(px).astype(jnp.int32) - (r_int - 1)  # leftmost stamp col
    iy0 = jnp.floor(py).astype(jnp.int32) - (r_int - 1)  # top stamp row
    y_lo = jnp.min(iy0, axis=1)                      # [R] band top
    oy = iy0 - y_lo[:, None]                         # [R, C]

    if rows % row_chunk:
        pad_r = row_chunk - rows % row_chunk
        tile = lambda a: jnp.concatenate(
            [a, jnp.zeros((pad_r,) + a.shape[1:], a.dtype)], axis=0)
        px, py = tile(px), tile(py)
        sig = tile(sig)                               # zero sig -> zero V
        ix0, iy0, oy = tile(ix0), tile(iy0), tile(oy)
        y_lo = jnp.concatenate(
            [y_lo, jnp.full((pad_r,), -pad_y, jnp.int32)])
    n_chunks = px.shape[0] // row_chunk

    sy_g = jnp.arange(s, dtype=jnp.float32)
    k_g = jnp.arange(we, dtype=jnp.int32)

    def chunk_bands(args):
        cpx, cpy, csig, cix0, ciy0, coy = args
        # dense stamps V[r, c, sy, sx], already integer-truncated
        ddy = (ciy0.astype(jnp.float32)[..., None, None]
               + sy_g[:, None]) - cpy[..., None, None]
        ddx = (cix0.astype(jnp.float32)[..., None, None]
               + sy_g[None, :]) - cpx[..., None, None]   # sx grid == sy grid
        fv = csig[..., None, None] * (
            (radius - jnp.sqrt(ddx * ddx + ddy * ddy)) / radius)
        v = jnp.where(fv > 0, (fv * 255.0).astype(jnp.int32), 0)

        # sy selection B[r, sx, by, c] = V[r, c, by - oy, sx] as dense
        # shifted one-hot multiplies — a gather here runs at ~1 element per
        # cycle on TPU and dominated the whole splat; this is plain
        # vectorized VPU math (the sy terms hit disjoint rows, so the f32
        # sum is exact)
        pe = (coy[..., None] + s
              == jnp.arange(band + s)).astype(jnp.float32)  # [r, c, band+s]
        vf = v.astype(jnp.float32)
        b = jnp.zeros((row_chunk, cols, band, s), jnp.float32)
        for sy in range(s):
            win = jax.lax.slice_in_dim(pe, s - sy, s - sy + band,
                                       axis=2)               # [r, c, band]
            b = b + vf[:, :, sy, None, :] * win[..., None]
        b = b.transpose(0, 3, 2, 1).reshape(
            row_chunk, s * band, cols).astype(jnp.int32)

        # column one-hot at the leftmost stamp column (grid offset +s)
        gx = cix0 + s
        e = (gx[..., None] == k_g).astype(jnp.bfloat16)      # [r, c, we]

        # split-byte bf16 matmuls: stamp values < 2^13 split into hi/lo
        # bytes, each exactly representable in bf16, accumulated in f32 —
        # exact integer math at the bf16 matmul rate instead of f32
        bhi = (b >> 8).astype(jnp.bfloat16)
        blo = (b & 255).astype(jnp.bfloat16)
        m = (jnp.einsum("rmc,rck->rmk", bhi, e,
                        preferred_element_type=jnp.float32) * 256.0
             + jnp.einsum("rmc,rck->rmk", blo, e,
                          preferred_element_type=jnp.float32))
        m = m.reshape(row_chunk, s, band, we)
        # shifted accumulation as one fused padded-stack sum (sequential
        # dynamic-update adds materialized the [band, wo] buffer s times)
        out = sum(
            jnp.pad(m[:, sx], ((0, 0), (0, 0), (sx, s - sx)))
            for sx in range(s))
        return out[:, :, s:s + dst_w].astype(jnp.int32)

    chunked = jax.lax.map(
        chunk_bands,
        tuple(a.reshape((n_chunks, row_chunk) + a.shape[1:])
              for a in (px, py, sig, ix0, iy0, oy)))
    bands = chunked.reshape(-1, band, dst_w)[: rows]

    hp = dst_h + 2 * pad_y
    starts = jnp.clip(y_lo[:rows], -pad_y, dst_h + s) + pad_y

    def place(racc, inp):
        start, bnd = inp
        zero = jnp.zeros((), start.dtype)
        cur = jax.lax.dynamic_slice(racc, (start, zero), (band, dst_w))
        return jax.lax.dynamic_update_slice(racc, cur + bnd,
                                            (start, zero)), None

    raster, _ = jax.lax.scan(
        place, jnp.zeros((hp, dst_w), jnp.int32), (starts, bands))
    return raster[pad_y:pad_y + dst_h]


def scanimate_pack(raster):
    """Clamp the accumulated raster and expand to gray RGB
    (ffmpeg_scanimate.cpp:966-973)."""
    v = jnp.clip(raster, 0, 255).astype(jnp.int32)
    return jnp.stack([v, v, v], axis=-1)
