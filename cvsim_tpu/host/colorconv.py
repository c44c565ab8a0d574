"""Color conversion + horizontal scaling device ops for the host shim.

The reference leans on libswscale for horizontal scaling and pixel-format
conversion (ffmpeg_to_composite.cpp:1742-1781, ffmpeg_ntsc.cpp:544); here
they are small JAX ops. BT.601 studio-range matrices (SMPTE 170M is the
colorspace the reference tags its frames with, :2187-2188).
"""

from __future__ import annotations

import numpy as np

# jax imports live inside the device functions: the host-numpy twins below
# serve the sibling tools' one-shot CLI processes, which must not pay the
# jax import


def hscale_bilinear(plane, dst_w: int):
    """Horizontal-only bilinear resize of [..., W] to [..., dst_w]
    (the sws SWS_BILINEAR role for width conversion). Index/weight
    constants are shared with the batched GOP program
    (batching.hscale_consts) so the two paths stay bit-identical by
    construction."""
    import jax.numpy as jnp

    from cvsim_tpu.host.batching import hscale_consts

    src_w = plane.shape[-1]
    consts = hscale_consts(src_w, dst_w)
    if consts is None:
        return jnp.asarray(plane)
    x0, x1, f = consts
    p = jnp.asarray(plane).astype(jnp.float32)
    s0 = p[..., x0]
    s1 = p[..., x1]
    out = s0 + (s1 - s0) * jnp.asarray(f)
    return jnp.round(out).astype(jnp.int32)


def yuv_to_rgb601(y, u, v):
    """Studio-range BT.601 YCbCr -> full-range RGB (uint8 domain int32 in/out).
    u, v are at the same spatial resolution as y (replicate before calling)."""
    import jax.numpy as jnp

    yf = (jnp.asarray(y, jnp.float32) - 16.0) * (255.0 / 219.0)
    uf = jnp.asarray(u, jnp.float32) - 128.0
    vf = jnp.asarray(v, jnp.float32) - 128.0
    r = yf + 1.402 * (255.0 / 224.0) * vf
    g = yf - 0.344136 * (255.0 / 224.0) * uf - 0.714136 * (255.0 / 224.0) * vf
    b = yf + 1.772 * (255.0 / 224.0) * uf
    clip = lambda x: jnp.clip(jnp.round(x), 0, 255).astype(jnp.int32)
    return clip(r), clip(g), clip(b)


def rgb_to_yuv601(r, g, b):
    """Full-range RGB -> studio-range BT.601 YCbCr (int32 uint8-domain)."""
    import jax.numpy as jnp

    rf = jnp.asarray(r, jnp.float32)
    gf = jnp.asarray(g, jnp.float32)
    bf = jnp.asarray(b, jnp.float32)
    yl = 0.299 * rf + 0.587 * gf + 0.114 * bf
    y = yl * (219.0 / 255.0) + 16.0
    u = (bf - yl) / 1.772 * (224.0 / 255.0) + 128.0
    v = (rf - yl) / 1.402 * (224.0 / 255.0) + 128.0
    clip = lambda x: jnp.clip(jnp.round(x), 0, 255).astype(jnp.int32)
    return clip(y), clip(u), clip(v)


# ---------------------------------------------------------------- numpy twins
# Host-thread versions for the streaming pipelines: per-frame prep must not
# make eager device dispatches (each costs a launch and a synchronizing
# round trip). Same formulas in numpy float32.

def yuv_to_rgb601_np(y, u, v):
    yf = (y.astype(np.float32) - 16.0) * np.float32(255.0 / 219.0)
    uf = u.astype(np.float32) - 128.0
    vf = v.astype(np.float32) - 128.0
    r = yf + np.float32(1.402 * (255.0 / 224.0)) * vf
    g = (yf - np.float32(0.344136 * (255.0 / 224.0)) * uf
         - np.float32(0.714136 * (255.0 / 224.0)) * vf)
    b = yf + np.float32(1.772 * (255.0 / 224.0)) * uf
    clip = lambda x: np.clip(np.round(x), 0, 255).astype(np.int32)
    return clip(r), clip(g), clip(b)


def rgb_to_yuv601_np(r, g, b):
    rf = r.astype(np.float32)
    gf = g.astype(np.float32)
    bf = b.astype(np.float32)
    yl = (np.float32(0.299) * rf + np.float32(0.587) * gf
          + np.float32(0.114) * bf)
    y = yl * np.float32(219.0 / 255.0) + 16.0
    u = (bf - yl) / np.float32(1.772) * np.float32(224.0 / 255.0) + 128.0
    v = (rf - yl) / np.float32(1.402) * np.float32(224.0 / 255.0) + 128.0
    clip = lambda x: np.clip(np.round(x), 0, 255).astype(np.int32)
    return clip(y), clip(u), clip(v)


def hscale_bilinear_np(plane, dst_w: int):
    """numpy twin of hscale_bilinear (same constants, same f32 lerp+round)."""
    from cvsim_tpu.host.batching import hscale_consts

    consts = hscale_consts(plane.shape[-1], dst_w)
    if consts is None:
        return np.asarray(plane)
    x0, x1, f = consts
    p = np.asarray(plane).astype(np.float32)
    s0 = p[..., x0]
    s1 = p[..., x1]
    return np.round(s0 + (s1 - s0) * f).astype(np.int32)


def chroma_up_bilinear_np(p, dst_h: int, dst_w: int):
    """Bilinear chroma upsample to luma resolution (width pass then height
    pass, int32 rounding after each — the hscale_bilinear constants, so the
    native kernel's float path is bit-identical). This is the InputFile
    restore tools' ingest semantics: the reference converts YUV420P->BGRA
    through an SWS_BILINEAR resampler (ffmpeg_vhsled.cpp:318-323,
    frameblend.cpp:328, filmac.cpp:323), which interpolates the chroma
    planes up — where the engines' frame_copy_scale path replicates."""
    p = hscale_bilinear_np(np.asarray(p, np.int32), dst_w)
    p = np.swapaxes(hscale_bilinear_np(np.swapaxes(p, 0, 1), dst_h), 0, 1)
    return p


def scale_frame_to_np(y, u, v, width: int, height: int,
                      chroma: str = "repeat"):
    """Scale a Y4M frame (possibly 4:2:0) to a full-res RGB [H, W, 3] frame
    (the frame_copy_scale role, ffmpeg_ntsc.cpp:544-607). Pure numpy: this
    runs per decoded frame on the host thread, where an eager device call
    per frame would cost a launch and a synchronizing round trip.

    chroma="repeat" replicates chroma up to luma resolution (the engines'
    ingest); chroma="bilinear" interpolates it (the restore tools' ingest —
    see chroma_up_bilinear_np)."""
    yh, yw = y.shape
    if chroma == "bilinear" and u.shape != y.shape:
        u = chroma_up_bilinear_np(u, yh, yw)
        v = chroma_up_bilinear_np(v, yh, yw)
    else:
        u = np.repeat(np.repeat(u, yh // u.shape[0], axis=0),
                      yw // u.shape[1], axis=1)
        v = np.repeat(np.repeat(v, yh // v.shape[0], axis=0),
                      yw // v.shape[1], axis=1)
    r, g, b = yuv_to_rgb601_np(np.asarray(y, np.int32),
                               np.asarray(u, np.int32),
                               np.asarray(v, np.int32))
    rgb = np.stack([r, g, b], axis=-1)
    # horizontal, then vertical via the transposed frame
    rgb = np.moveaxis(hscale_bilinear_np(np.moveaxis(rgb, -1, 0), width),
                      0, -1)
    rgbt = np.swapaxes(rgb, 0, 1)
    rgbt = np.moveaxis(hscale_bilinear_np(np.moveaxis(rgbt, -1, 0), height),
                       0, -1)
    return np.swapaxes(rgbt, 0, 1)  # [H, W, 3]
