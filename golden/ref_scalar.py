"""Scalar NumPy/Python port of the reference DSP, used as the golden oracle.

Each function mirrors, loop for loop and truncation for truncation, the cited
reference code (float64 filters, C int conversion = trunc toward zero,
in-place writeback order). It is deliberately slow and unvectorized; tests
run it on small fields only.

This is an original re-implementation from the formulas documented in
SURVEY.md section 2.2 — not a copy of the C++ — kept in exact semantic
correspondence so the JAX engines can be validated bit-for-bit (float64) or
within tight tolerance (float32).
"""

from __future__ import annotations

import math

import numpy as np

NTSC_RATE = (315000000.0 * 4) / 88
NTSC_RATE_422 = (315000000.0 * 4) / (88 * 2)


def cdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def ctrunc(x: float) -> int:
    return int(x)  # Python int() on float truncates toward zero


def clampu8(x) -> int:
    x = int(x)
    return 0 if x < 0 else (255 if x > 255 else x)


class Lowpass:
    """LowpassFilter (ffmpeg_to_composite.cpp:99-131)."""

    def __init__(self, rate: float, hz: float, reset: float = 0.0):
        dt = 1.0 / rate
        tau = 1.0 / (hz * 2 * math.pi)
        self.alpha = dt / (tau + dt)
        self.prev = float(reset)

    def lowpass(self, s: float) -> float:
        self.prev = s * self.alpha + (self.prev - self.prev * self.alpha)
        return self.prev

    def highpass(self, s: float) -> float:
        return s - self.lowpass(s)


# ------------------------------------------------------------------- phase xi

def xi_phase(fieldno: int, y: int, phase_shift: int, phase_offset: int,
             ntsc: bool = True, gen1: bool = False) -> int:
    if gen1 and not ntsc:
        return (fieldno + y) & 3
    if phase_shift == 90:
        return (fieldno + phase_offset + (y >> 1)) & 3
    if phase_shift == 180:
        return (((fieldno + y) & 2) + phase_offset) & 3
    if phase_shift == 270:
        return (fieldno + phase_offset - (y >> 1)) & 3
    return 0 if gen1 else (phase_offset & 3)


UMULT = [1, 0, -1, 0]
VMULT = [0, 1, 0, -1]


# =============================================================== gen-2 (YIQ)

def rgb_to_yiq(r, g, b):
    dy = 0.30 * r + 0.59 * g + 0.11 * b
    y = ctrunc(256 * dy)
    i = ctrunc(256 * ((-0.27 * (b - dy)) + (0.74 * (r - dy))))
    q = ctrunc(256 * ((0.41 * (b - dy)) + (0.48 * (r - dy))))
    return y, i, q


def yiq_to_rgb(y, i, q):
    r = ctrunc((1.000 * y + 0.956 * i + 0.621 * q) / 256)
    g = ctrunc((1.000 * y - 0.272 * i - 0.647 * q) / 256)
    b = ctrunc((1.000 * y - 1.106 * i + 1.703 * q) / 256)
    clip = lambda v: 0 if v < 0 else (255 if v > 255 else v)
    return clip(r), clip(g), clip(b)


def composite_lowpass_yiq(i_plane, q_plane, lite: bool = False):
    """ffmpeg_ntsc.cpp:1399-1458 on [L, W] int arrays (field lines)."""
    for p, plane in ((1, i_plane), (2, q_plane)):
        if lite:
            cutoff, delay = 2600000.0, 1
        else:
            cutoff = 1300000.0 if p == 1 else 600000.0
            delay = 2 if p == 1 else 4
        for row in plane:
            lps = [Lowpass(NTSC_RATE, cutoff, 0) for _ in range(3)]
            w = len(row)
            for x in range(w):
                s = float(row[x])
                for f in lps:
                    s = f.lowpass(s)
                if x >= delay:
                    row[x - delay] = ctrunc(s)
    return i_plane, q_plane


def chroma_into_luma_yiq(y, i, q, fieldno, parity, amp,
                         phase_shift=180, phase_offset=0):
    l, w = y.shape
    for li in range(l):
        yy = parity + 2 * li
        xi = xi_phase(fieldno, yy, phase_shift, phase_offset)
        for x in range(w):
            sxi = (xi + x) & 3
            chroma = int(i[li, x]) * amp * UMULT[sxi] + int(q[li, x]) * amp * VMULT[sxi]
            y[li, x] += cdiv(chroma, 50)
            i[li, x] = 0
            q[li, x] = 0
    return y, i, q


def chroma_from_luma_yiq(y, i, q, fieldno, parity, amp_back,
                         phase_shift=180, phase_offset=0):
    l, w = y.shape
    for li in range(l):
        yy = parity + 2 * li
        xi = xi_phase(fieldno, yy, phase_shift, phase_offset)
        row = y[li]
        chroma = [0] * w
        delay = [0, 0, 0, 0]
        delay[2] = int(row[0]); delay[3] = int(row[1])
        s = delay[2] + delay[3]
        for x in range(w):
            c = int(row[x + 2]) if (x + 2) < w else 0
            s -= delay[0]
            delay[0], delay[1], delay[2] = delay[1], delay[2], delay[3]
            delay[3] = c
            s += c
            row[x] = cdiv(s, 4)
            chroma[x] = c - row[x]

        x = (4 - xi) & 3
        while x + 3 < w:
            chroma[x + 2] = -chroma[x + 2]
            chroma[x + 3] = -chroma[x + 3]
            x += 4

        for x in range(w):
            chroma[x] = cdiv(chroma[x] * 50, amp_back)

        x = 0
        while (x + xi + 1) < w:
            i[li, x] = -chroma[x + xi]
            q[li, x] = -chroma[x + xi + 1]
            x += 2
        while x < w:
            i[li, x] = 0
            q[li, x] = 0
            x += 2
        x = 0
        while (x + 2) < w:
            i[li, x + 1] = (int(i[li, x]) + int(i[li, x + 2])) >> 1
            q[li, x + 1] = (int(q[li, x]) + int(q[li, x + 2])) >> 1
            x += 2
        while x < w:
            i[li, x] = 0
            q[li, x] = 0
            x += 1
    return y, i, q


def preemphasis_yiq(y, scale, cut):
    for row in y:
        pre = Lowpass(NTSC_RATE, cut, 16)
        for x in range(len(row)):
            s = float(row[x])
            s += pre.highpass(s) * scale
            row[x] = ctrunc(s)
    return y


def vhs_luma_lowpass_yiq(y, luma_cut):
    for row in y:
        lps = [Lowpass(NTSC_RATE, luma_cut, 16) for _ in range(3)]
        pre = Lowpass(NTSC_RATE, luma_cut, 16)
        for x in range(len(row)):
            s = float(row[x])
            for f in lps:
                s = f.lowpass(s)
            s += pre.highpass(s) * 1.6
            row[x] = ctrunc(s)
    return y


def vhs_chroma_lowpass_yiq(i, q, chroma_cut, delay):
    for plane in (i, q):
        for row in plane:
            lps = [Lowpass(NTSC_RATE, chroma_cut, 0) for _ in range(3)]
            w = len(row)
            for x in range(w):
                s = float(row[x])
                for f in lps:
                    s = f.lowpass(s)
                if x >= delay:
                    row[x - delay] = ctrunc(s)
    return i, q


def vhs_chroma_vert_blend_yiq(i, q):
    l, w = i.shape
    for plane in (i, q):
        delay = [0] * w
        for li in range(1, l):
            for x in range(w):
                c = int(plane[li, x])
                plane[li, x] = (delay[x] + c + 1) >> 1
                delay[x] = c
    return i, q


def vhs_sharpen_yiq(y, luma_cut, sharpen):
    for row in y:
        lps = [Lowpass(NTSC_RATE, luma_cut * 4, 0) for _ in range(3)]
        for x in range(len(row)):
            s = ts = float(row[x])
            for f in lps:
                ts = f.lowpass(ts)
            row[x] = ctrunc(s + (s - ts) * sharpen * 2)
    return y


# ============================================================ gen-1 (YUV422)

def chroma_lowpass_yuv(u, v, ntsc=True, lite=False):
    """ffmpeg_to_composite.cpp:353-431 on [L, W/2] u8 arrays."""
    for p, plane in ((1, u), (2, v)):
        if lite:
            cutoff = NTSC_RATE_422 / 4
            delay = 1
        elif ntsc:
            cutoff = 1300000.0 if p == 1 else 600000.0
            delay = 2 if p == 1 else 4
        else:
            cutoff, delay = 1300000.0, 2
        for row in plane:
            w = len(row)
            lps = [Lowpass(NTSC_RATE_422, cutoff, 128) for _ in range(3)]
            hp = None if lite else Lowpass(NTSC_RATE_422, cutoff / 2, 128)
            for x in range(w):
                s = float(row[x])
                if hp is not None:
                    s += hp.highpass(s)
                for f in lps:
                    s = f.lowpass(s)
                if x >= delay:
                    row[x - delay] = clampu8(s)
    return u, v


def yuv_to_ntsc(y, u, v, fieldno, parity, amp, phase_shift=180, phase_offset=0,
                ntsc=True, nocolor=False):
    l, w = y.shape
    for li in range(l):
        yy = parity + 2 * li
        xi = xi_phase(fieldno, yy, phase_shift, phase_offset, ntsc=ntsc, gen1=True)
        for x in range(0, w, 2):
            for sx in range(2):
                sxi = xi + x + sx
                chroma = (int(u[li, x // 2]) - 128) * amp * UMULT[sxi & 3]
                chroma += (int(v[li, x // 2]) - 128) * amp * VMULT[sxi & 3]
                y[li, x + sx] = clampu8(int(y[li, x + sx]) + cdiv(chroma, 50))
            if nocolor:
                u[li, x // 2] = 128
                v[li, x // 2] = 128
    return y, u, v


def ntsc_to_yuv(y, u, v, fieldno, parity, amp_back, phase_shift=180,
                phase_offset=0, ntsc=True, nocolor_after_sep=False,
                pad_value=16):
    l, w = y.shape
    for li in range(l):
        yy = parity + 2 * li
        xi = xi_phase(fieldno, yy, phase_shift, phase_offset, ntsc=ntsc, gen1=True)
        row = y[li]
        chroma = [0] * (w + 4)  # slack like the C VLA's stack margin
        delay = [16, 16, 0, 0]
        s = 16 * 2
        delay[2] = int(row[0]); s += delay[2]
        delay[3] = int(row[1]); s += delay[3]
        for x in range(w):
            c = int(row[x + 2]) if (x + 2) < w else pad_value
            s -= delay[0]
            delay[0], delay[1], delay[2] = delay[1], delay[2], delay[3]
            delay[3] = c
            s += c
            row[x] = s // 4  # unsigned sum: floor == trunc
            chroma[x] = clampu8(c + 128 - int(row[x]))

        if nocolor_after_sep:
            for x in range(w):
                row[x] = chroma[x]
                u[li, x // 2] = 128
                v[li, x // 2] = 128
            continue

        x = (4 - xi) & 3
        while x < w:
            if x + 2 < w:
                chroma[x + 2] = 255 - chroma[x + 2]
            if x + 3 < w:
                chroma[x + 3] = 255 - chroma[x + 3]
            x += 4

        for x in range(w):
            chroma[x] = clampu8(cdiv((chroma[x] - 128) * 50, amp_back) + 128)

        if xi & 1:
            for x in range(w // 2):
                u[li, x] = 255 - chroma[x * 2 + 1]
                v[li, x] = 255 - chroma[x * 2 + 0]
        else:
            for x in range(w // 2):
                u[li, x] = 255 - chroma[x * 2 + 0]
                v[li, x] = 255 - chroma[x * 2 + 1]
    return y, u, v


def preemphasis_yuv(y, scale, cut):
    for row in y:
        pre = Lowpass(NTSC_RATE, cut, 16)
        for x in range(len(row)):
            s = float(row[x])
            s += pre.highpass(s) * scale
            row[x] = clampu8(s)
    return y


def vhs_luma_lowpass_yuv(y, luma_cut):
    for row in y:
        lps = [Lowpass(NTSC_RATE, luma_cut, 16) for _ in range(3)]
        pre = Lowpass(NTSC_RATE, luma_cut, 16)
        for x in range(len(row)):
            s = float(row[x])
            for f in lps:
                s = f.lowpass(s)
            s += pre.highpass(s) * 1.6
            row[x] = clampu8(s)
    return y


def vhs_chroma_lowpass_yuv(u, v, chroma_cut, delay):
    for plane in (u, v):
        for row in plane:
            lps = [Lowpass(NTSC_RATE_422, chroma_cut, 128) for _ in range(3)]
            w = len(row)
            for x in range(w):
                s = float(row[x])
                for f in lps:
                    s = f.lowpass(s)
                if x >= delay:
                    row[x - delay] = clampu8(s)
    return u, v


def vhs_chroma_vert_blend_yuv(u, v):
    l, w = u.shape
    for plane in (u, v):
        delay = [128] * w
        for li in range(1, l):
            for x in range(w):
                c = int(plane[li, x])
                plane[li, x] = (delay[x] + c + 1) >> 1
                delay[x] = c
    return u, v


def vhs_sharpen_luma_yuv(y, luma_cut, sharpen):
    for row in y:
        lps = [Lowpass(NTSC_RATE, luma_cut * 2, 16) for _ in range(3)]
        for x in range(len(row)):
            s = ts = float(row[x])
            for f in lps:
                ts = f.lowpass(ts)
            row[x] = clampu8(s + (s - ts) * sharpen)
    return y


def vhs_sharpen_chroma_yuv(u, v, chroma_cut, sharpen):
    for plane in (u, v):
        for row in plane:
            lps = [Lowpass(NTSC_RATE_422, chroma_cut * 2, 128) for _ in range(3)]
            for x in range(len(row)):
                s = ts = float(row[x])
                for f in lps:
                    ts = f.lowpass(ts)
                row[x] = clampu8(s + (s - ts) * sharpen)
    return u, v


def head_switching(y, parity, point, phase, noise, ntsc=True, fill=16):
    """ffmpeg_to_composite.cpp:668-732 / ffmpeg_ntsc.cpp:1646-1713 on a
    [L, W] plane, deterministic (noise passed in, not drawn)."""
    l, w = y.shape
    height = l * 2
    twidth = w + w // 10
    t = twidth * (262.5 if ntsc else 312.5)
    # C: p = (unsigned int)(fmod(v, 1.0) * t). fmod is sign-preserving and
    # the cast truncates then wraps mod 2^32 — a negative phase/point (large
    # -hs-noise draws, or a negative flag value) wraps to a huge p, putting
    # the switch line far below the raster (no bar) and x at the wrapped
    # residue, NOT at the positive mod.
    p = int(math.fmod(point + noise, 1.0) * t) & 0xFFFFFFFF
    yy = (p // twidth) * 2 + parity
    p = int(math.fmod(phase + noise, 1.0) * t) & 0xFFFFFFFF
    x = p % twidth
    yy -= ((262 - 240) * 2) if ntsc else ((312 - 288) * 2)
    ishif = x - twidth if x >= (twidth // 2) else x
    shif = 0
    shy = 0
    tx = x
    while yy < height:
        if yy >= 0 and shif != 0:
            row = y[(yy - parity) // 2]
            tmp = [fill] * twidth
            for k in range(w):
                tmp[k] = int(row[k])
            x2 = (tx + twidth + shif) % twidth
            for k in range(tx, w):
                row[k] = tmp[x2]
                x2 += 1
                if x2 == twidth:
                    x2 = 0
        shif = ishif if shy == 0 else cdiv(shif * 7, 8)
        tx = 0
        yy += 2
        shy += 1
    return y


# ===================================================== render_field (L4)

def render_field_scalar(y_src, u_src, v_src, dst_height, parity,
                        interlaced=False, tff=True, pts_delta=0,
                        ticks_per_frame=2):
    """Scalar port of render_field (ffmpeg_to_composite.cpp:1001-1129).
    Returns field-line planes (luma [L, W], chroma [L, Wc])."""
    src_h = y_src.shape[0]
    chroma_h = u_src.shape[0]
    is420 = chroma_h != src_h
    out_y, out_u, out_v = [], [], []
    for y in range(parity, dst_height, 2):
        sy = (y * 0x100 * src_h) // dst_height
        syf = sy & 0xFF
        sy >>= 8
        csy, csyf = sy, syf
        if is420:
            if not (csy & 1):
                csyf = 0
            csy >>= 1
        if interlaced:
            which = 0 if tff else 1
            if pts_delta >= ticks_per_frame // 2:
                which ^= 1
            if which == 0:
                sy += 1
                if not (sy & 1):
                    syf = 0
                else:
                    sy -= 1
            else:
                if not (sy & 1):
                    syf = 0
                    sy += 1
            if which == 0:
                csy += 1
                if not (csy & 1):
                    csyf = 0
                else:
                    csy -= 1
            else:
                if not (csy & 1):
                    csyf = 0
                    csy += 1
            if sy >= src_h - 2:
                sy = src_h - 2
                syf = 0
            sy2 = sy + 2
            if csy >= chroma_h - 2:
                csy = chroma_h - 2
                csyf = 0
            csy2 = csy + 1
        else:
            if sy >= src_h - 1:
                sy = src_h - 1
                syf = 0
            sy2 = sy + 1
            if csy >= chroma_h - 1:
                csy = chroma_h - 1
                csyf = 0
            csy2 = csy + 1

        if not is420:
            # the reference's non-420 blend (:1109-1126) uses the LUMA
            # indices for all three planes; csy/csy2/csyf feed only the
            # 420 path (:1102-1107)
            csy, csy2, csyf = sy, sy2, syf

        def interp(plane, i1, i2, f):
            s1 = plane[i1].astype(np.int64)
            if f == 0:
                return s1  # reference memcpy path; s2 never read (:1094-1096)
            s2 = plane[i2].astype(np.int64)
            return s1 + (((s2 - s1) * f) >> 8)

        out_y.append(interp(y_src, sy, sy2, syf))
        out_u.append(interp(u_src, csy, csy2, csyf))
        out_v.append(interp(v_src, csy, csy2, csyf))
    return np.stack(out_y), np.stack(out_u), np.stack(out_v)


# ===================================================== audio chain (L7)

def audio_chain_scalar(samples, rate, channels, lowpass_hz, highpass_hz,
                       passes=6, preemph=True, deemph=True, pre_cut=16000.0,
                       vhs_hifi=True, buzz_db=-42.0, hiss_level=0,
                       high_boost=0.25, ntsc=True, start_count=0):
    """Scalar port of composite_audio_process (ffmpeg_to_composite.cpp:558-627)
    with hiss forced deterministic (hiss_level must be 0 for golden use).
    samples: [N, C] int16-range ints. Returns int16-range [N, C]."""
    n = samples.shape[0]
    out = np.zeros_like(samples)
    lo = [[Lowpass(rate, lowpass_hz, 0) for _ in range(passes)] for _ in range(channels)]
    hi = [[Lowpass(rate, highpass_hz, 0) for _ in range(passes)] for _ in range(channels)]
    pre = [Lowpass(rate, pre_cut, 0) for _ in range(channels)]
    post = [Lowpass(rate, pre_cut, 0) for _ in range(channels)]
    boost = [Lowpass(rate, 10000.0, 0) for _ in range(channels)]
    linear_buzz = 10.0 ** (buzz_db / 20.0)
    hsync_hz = 15734.0 if ntsc else 15625.0
    vsync_lines = 525 if ntsc else 625
    vpulse_end = 10 if ntsc else 12
    hpulse_end = hsync_hz * ((4.7 if ntsc else 4.0) / 1e6)

    count = start_count
    for si in range(n):
        for c in range(channels):
            s = float(samples[si, c]) / 32768.0
            for f in lo[c]:
                s = f.lowpass(s)
            for f in hi[c]:
                s = f.highpass(s)
            if preemph:
                for i in range(channels):
                    s = s + pre[i].highpass(s)
            if (not vhs_hifi) and linear_buzz > 1e-9:
                for oi in range(16):
                    t = ((count * 16.0 + oi) * hsync_hz) / rate / 16.0
                    hpos = math.fmod(t, 1.0)
                    vline = int(math.fmod(math.floor(t + 1e-4 - hpos),
                                          vsync_lines / 2.0))
                    if hpos < hpulse_end or vline < vpulse_end:
                        s -= linear_buzz / 16.0 / 2.0
            s = max(-1.0, min(1.0, s))
            if (not vhs_hifi) and high_boost > 0:
                s += boost[c].highpass(s) * high_boost
            if deemph:
                for i in range(channels):
                    s = post[i].lowpass(s)
            v = int(s * 32768.0)
            out[si, c] = max(-32768, min(32767, v))
        count += 1
    return out


# ===================================================== cassette chain

def cassette_chain_scalar(samples, rate, channels, lowpass_hz, highpass_hz,
                          head_tilt=0.2, head_tilt_waver=0.5, preemph=True,
                          deemph=True, pre_cut=4000.0, hiss_level=0,
                          mono_downmix=False, passes=6):
    """Scalar port of ffmpeg_cassette.cpp composite_audio_process (:334-416)
    with hiss forced deterministic (hiss_level must be 0)."""
    n = samples.shape[0]
    out = np.zeros_like(samples)
    lo = [[Lowpass(rate, lowpass_hz, 0) for _ in range(passes)] for _ in range(channels)]
    hi = [[Lowpass(rate, highpass_hz, 0) for _ in range(passes)] for _ in range(channels)]
    pre = [Lowpass(rate, pre_cut, 0) for _ in range(channels)]
    post = [Lowpass(rate, pre_cut, 0) for _ in range(channels)]
    length = int(math.floor(abs(head_tilt) * 2 + abs(head_tilt) * 3 + 7.5))
    maps = [[0.0] * length for _ in range(channels)]
    mult = [[0.0] * length for _ in range(channels)]

    count = 0
    for si in range(n):
        t = count / rate
        htf = (head_tilt_waver * math.sin(t * math.pi * 2 * 1.5)) + head_tilt
        lr = htf * 1.5
        for c in range(channels):
            mid = (lr if c == 0 else -lr) + length / 2.0
            for i in range(length):
                d = (i - mid) / (abs(htf) + 1.0)
                d = 1.0 - abs(d)
                if d < 0:
                    d = 0
                d /= abs(htf) + 1.0
                mult[c][i] = d
        for c in range(channels):
            s = float(samples[si, c]) / 32768.0
            for f in lo[c]:
                s = f.lowpass(s)
            for f in hi[c]:
                s = f.highpass(s)
            if preemph:
                for i in range(channels):
                    s = s + pre[i].highpass(s)
            s = max(-1.0, min(1.0, s))
            # hiss omitted (hiss_level == 0)
            m = maps[c]
            for i in range(length - 1):
                m[i] = m[i + 1]
            m[length - 1] = s
            s = sum(m[i] * mult[c][i] for i in range(length))
            if deemph:
                for i in range(channels):
                    s = post[i].lowpass(s)
            v = int(s * 32768.0)
            out[si, c] = max(-32768, min(32767, v))
        if mono_downmix and channels == 2:
            tot = int(out[si, 0]) + int(out[si, 1])
            q = abs(tot) // 2
            tot = -q if tot < 0 else q
            out[si, 0] = out[si, 1] = tot
        count += 1
    return out


# ===================================================== whole chains, noise off

def _check_noise_off(cfg):
    noisy = {k: getattr(cfg, k) for k in (
        "video_noise", "video_chroma_noise", "video_chroma_phase_noise",
        "video_chroma_loss") if getattr(cfg, k)}
    if cfg.vhs_head_switching and cfg.vhs_head_switching_phase_noise:
        noisy["vhs_head_switching_phase_noise"] = (
            cfg.vhs_head_switching_phase_noise)
    if noisy:
        raise ValueError(f"scalar chains run with noise off, got {noisy}")


def composite_layer_scalar(rgb, cfg, fieldno, parity):
    """Gen-2 composite_layer (ffmpeg_ntsc.cpp:1570-1921) on one [L, W, 3]
    RGB field, stage order as in models/yiq.composite_layer, with every
    noise source off (cfg must say so). Returns the [L, W, 3] RGB field."""
    _check_noise_off(cfg)
    l, w, _ = rgb.shape
    y = np.zeros((l, w), np.int64)
    i = np.zeros((l, w), np.int64)
    q = np.zeros((l, w), np.int64)
    for li in range(l):
        for x in range(w):
            y[li, x], i[li, x], q[li, x] = rgb_to_yiq(
                *(int(c) for c in rgb[li, x]))
    ph = dict(phase_shift=cfg.video_scanline_phase_shift,
              phase_offset=cfg.video_scanline_phase_shift_offset)
    amp = cfg.subcarrier_amplitude

    def into(y, i, q):
        return chroma_into_luma_yiq(y, i, q, fieldno, parity, amp, **ph)

    def back(y, i, q, a=amp):
        return chroma_from_luma_yiq(y, i, q, fieldno, parity, a, **ph)

    if cfg.composite_in_chroma_lowpass:
        i, q = composite_lowpass_yiq(i, q)
    y, i, q = into(y, i, q)
    if cfg.composite_preemphasis != 0 and cfg.composite_preemphasis_cut > 0:
        y = preemphasis_yiq(y, cfg.composite_preemphasis,
                            cfg.composite_preemphasis_cut)
    if cfg.vhs_head_switching:
        y = head_switching(y, parity, cfg.vhs_head_switching_point,
                           cfg.vhs_head_switching_phase, 0.0, ntsc=cfg.ntsc,
                           fill=0)
    if not cfg.nocolor_subcarrier:
        y, i, q = back(y, i, q, cfg.subcarrier_amplitude_back)
    if cfg.emulating_vhs:
        sp = cfg.vhs_tape_speed
        y = vhs_luma_lowpass_yiq(y, sp.luma_cut)
        i, q = vhs_chroma_lowpass_yiq(i, q, sp.chroma_cut,
                                      sp.chroma_delay_gen2)
        if cfg.vhs_chroma_vert_blend and cfg.ntsc:
            i, q = vhs_chroma_vert_blend_yiq(i, q)
        y = vhs_sharpen_yiq(y, sp.luma_cut, cfg.vhs_out_sharpen)
        if not cfg.vhs_svideo_out:
            y, i, q = back(*into(y, i, q))
    for _ in range(cfg.video_yc_recombine):
        y, i, q = back(*into(y, i, q))
    if cfg.composite_out_chroma_lowpass:
        i, q = composite_lowpass_yiq(
            i, q, lite=cfg.composite_out_chroma_lowpass_lite)
    out = np.zeros((l, w, 3), np.int64)
    for li in range(l):
        for x in range(w):
            out[li, x] = yiq_to_rgb(int(y[li, x]), int(i[li, x]),
                                    int(q[li, x]))
    return out


def composite_video_process_scalar(y, u, v, cfg, fieldno, parity):
    """Gen-1 composite_video_process (ffmpeg_to_composite.cpp:629-952) on
    one field's u8-range planes (y [L, W], u/v [L, W/2]), stage order as in
    models/yuv422.composite_video_process, with every noise source off.
    Returns new (y, u, v) int64 planes."""
    _check_noise_off(cfg)
    y, u, v = (np.array(p, np.int64) for p in (y, u, v))
    ph = dict(phase_shift=cfg.video_scanline_phase_shift,
              phase_offset=cfg.video_scanline_phase_shift_offset,
              ntsc=cfg.ntsc)
    amp = cfg.subcarrier_amplitude

    def enc(y, u, v, nocolor=False):
        return yuv_to_ntsc(y, u, v, fieldno, parity, amp, nocolor=nocolor,
                           **ph)

    def dec(y, u, v, a=amp, nocolor_after_sep=False):
        return ntsc_to_yuv(y, u, v, fieldno, parity, a,
                           nocolor_after_sep=nocolor_after_sep, **ph)

    if cfg.composite_in_chroma_lowpass:
        u, v = chroma_lowpass_yuv(u, v, ntsc=cfg.ntsc)
    y, u, v = enc(y, u, v, nocolor=cfg.nocolor_subcarrier)
    if cfg.composite_preemphasis != 0 and cfg.composite_preemphasis_cut > 0:
        y = preemphasis_yuv(y, cfg.composite_preemphasis,
                            cfg.composite_preemphasis_cut)
    if cfg.vhs_head_switching:
        y = head_switching(y, parity, cfg.vhs_head_switching_point,
                           cfg.vhs_head_switching_point, 0.0, ntsc=cfg.ntsc,
                           fill=16)
    if not cfg.nocolor_subcarrier:
        y, u, v = dec(y, u, v, cfg.subcarrier_amplitude_back,
                      cfg.nocolor_subcarrier_after_yc_sep)
    if cfg.emulating_vhs:
        sp = cfg.vhs_tape_speed
        y = vhs_luma_lowpass_yuv(y, sp.luma_cut)
        u, v = vhs_chroma_lowpass_yuv(u, v, sp.chroma_cut,
                                      sp.chroma_delay_gen1)
        if cfg.vhs_chroma_vert_blend and cfg.ntsc:
            u, v = vhs_chroma_vert_blend_yuv(u, v)
        y = vhs_sharpen_luma_yuv(y, sp.luma_cut, cfg.vhs_out_sharpen)
        u, v = vhs_sharpen_chroma_yuv(u, v, sp.chroma_cut,
                                      cfg.vhs_out_sharpen_chroma)
        if not cfg.vhs_svideo_out:
            y, u, v = dec(*enc(y, u, v))
    for _ in range(cfg.video_yc_recombine):
        y, u, v = dec(*enc(y, u, v))
    if cfg.composite_out_chroma_lowpass:
        u, v = chroma_lowpass_yuv(u, v, ntsc=cfg.ntsc)
    elif cfg.composite_out_chroma_lowpass_lite:
        u, v = chroma_lowpass_yuv(u, v, lite=True)
    return y, u, v
