"""Audio-cassette emulation chain (ffmpeg_cassette.cpp:334-416).

Per-sample order: bandpass bank -> preemphasis (4 kHz, interleaved-stream
quirk) -> hard clip -> hiss -> time-varying triangular-FIR head-azimuth
convolution with per-channel +/- lr_delay skew -> deemphasis -> optional mono
downmix.

The head-tilt FIR (ConvolutionMap, :278-371) rebuilds its kernel every
sample from

    head_tilt_final(t) = tilt + waver * sin(2*pi*1.5*t)
    lr_delay(t) = 1.5 * head_tilt_final(t)
    kernel_len  = floor(5*|tilt| + 7.5)          (fixed at stream start)
    mid_ch      = +/- lr_delay + len/2
    k[i] = max(0, 1 - |(i - mid)/( |htf|+1 )|) / (|htf|+1)

and convolves past samples: out(t) = sum_i k[i] * s(t - (len-1-i)).

Vectorized: the kernel bank for a whole chunk is computed closed-form as a
[N, len] array, the signal history as a [N, len] sliding window (static
slices of a padded buffer, with len-1 samples of carried state), and the
convolution as one batched dot — no per-sample loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cvsim_tpu.config import iir_alpha
from cvsim_tpu.ops.cmath import clips16
from cvsim_tpu.ops.noise import hiss_per_sample
from cvsim_tpu.audio.chains import _bandpass_bank, _interleaved_stage


class CassetteConfig(NamedTuple):
    rate: int = 44100
    channels: int = 2
    lowpass_hz: float = 20000.0
    highpass_hz: float = 20.0
    hiss_db: float = -72.0
    head_tilt: float = 0.2
    head_tilt_waver: float = 0.5
    emulating_preemphasis: bool = True
    emulating_deemphasis: bool = True
    preemphasis_cut_hz: float = 4000.0
    mono_downmix: bool = False
    bandpass_passes: int = 6

    @property
    def hiss_level(self) -> int:
        return int(10.0 ** (self.hiss_db / 20.0) * 5000)

    @property
    def kernel_len(self) -> int:
        return int(math.floor(abs(self.head_tilt) * 5 + 7.5))


CASSETTE_PRESETS = {
    # -preset 0..4 (ffmpeg_cassette.cpp:515-556)
    0: dict(lowpass_hz=16000, highpass_hz=100, head_tilt_waver=0.55, head_tilt=3.5),
    1: dict(lowpass_hz=14000, highpass_hz=100, head_tilt_waver=0.6, head_tilt=6),
    2: dict(lowpass_hz=10000, highpass_hz=100, head_tilt_waver=0.5, head_tilt=3),
    3: dict(lowpass_hz=16000, highpass_hz=20, head_tilt_waver=0.75, head_tilt=10),
    4: dict(lowpass_hz=16000, highpass_hz=20, head_tilt_waver=0.25, head_tilt=1.1),
}


class CassetteState(NamedTuple):
    bank_lo: jax.Array      # [C, passes]
    bank_hi: jax.Array      # [C, passes]
    pre: jax.Array          # [C]
    post: jax.Array         # [C]
    history: jax.Array      # [len-1, C] trailing samples feeding the FIR
    sample_count: jax.Array


def init_cassette_state(cfg: CassetteConfig, dtype=jnp.float32) -> CassetteState:
    c, p = cfg.channels, cfg.bandpass_passes
    z = lambda *s: jnp.zeros(s, dtype)
    return CassetteState(
        bank_lo=z(c, p), bank_hi=z(c, p), pre=z(c), post=z(c),
        history=z(cfg.kernel_len - 1, c),
        sample_count=jnp.zeros((), jnp.int32))


def _head_kernels(cfg: CassetteConfig, start_count, n, dtype):
    """Per-sample triangular kernels, [N, len, C]."""
    length = cfg.kernel_len
    # the 1.5 Hz waver's phase repeats every 2 seconds exactly (3 cycles);
    # reduce the absolute sample index mod 2*rate in INTEGER math before
    # the f32 divide — a raw f32 counter loses sample resolution past 2^24
    # (~6 minutes at 44.1k) and the waver would staircase/freeze
    period = 2 * cfg.rate
    idx = (jnp.asarray(start_count, jnp.int32) % period
           + jnp.arange(n, dtype=jnp.int32)) % period
    t = idx.astype(dtype) / cfg.rate
    htf = cfg.head_tilt + cfg.head_tilt_waver * jnp.sin(t * (2.0 * jnp.pi) * 1.5)
    lr = htf * 1.5
    i = jnp.arange(length, dtype=dtype)
    denom = jnp.abs(htf) + 1.0
    ks = []
    for c in range(cfg.channels):
        mid = (lr if c == 0 else -lr) + length / 2.0
        d = (i[None, :] - mid[:, None]) / denom[:, None]
        d = jnp.maximum(1.0 - jnp.abs(d), 0.0) / denom[:, None]
        ks.append(d)
    return jnp.stack(ks, axis=-1)  # [N, len, C]


def cassette_audio_process(
    audio,                   # int16-range [N, C]
    state: CassetteState,
    key,
    *,
    cfg: CassetteConfig,
    dtype=jnp.float32,
):
    n, c = audio.shape
    assert c == cfg.channels
    s = audio.astype(dtype) / 32768.0

    # 1. bandpass bank (shared with the VHS chain)
    s, bank_lo, bank_hi = _bandpass_bank(
        s, state.bank_lo, state.bank_hi, iir_alpha(cfg.rate, cfg.lowpass_hz),
        iir_alpha(cfg.rate, cfg.highpass_hz), cfg.bandpass_passes)

    # 2. preemphasis (interleaved-stream quirk, 4 kHz)
    pre_reg = state.pre
    if cfg.emulating_preemphasis:
        a_pre = iir_alpha(cfg.rate, cfg.preemphasis_cut_hz)
        regs = []
        for i in range(c):
            s, r = _interleaved_stage(s, a_pre, state.pre[i], "preemph")
            regs.append(r)
        pre_reg = jnp.stack(regs)

    # 3. clip
    s = jnp.clip(s, -1.0, 1.0)

    # 4. hiss (content-addressed per absolute sample index; callers pass one
    # base key for the whole stream)
    if cfg.hiss_level != 0:
        u = hiss_per_sample(key, state.sample_count, n, c, cfg.hiss_level,
                            dtype)
        s = s + u / 20000.0

    # 5. head-tilt convolution: windows [N, len, C] x kernels [N, len, C]
    length = cfg.kernel_len
    full = jnp.concatenate([state.history, s], axis=0)   # [len-1+N, C]
    wins = jnp.stack(
        [jax.lax.dynamic_slice_in_dim(full, i, n, axis=0)
         for i in range(length)], axis=1)                # win[t, i] = s[t-(len-1-i)]
    kern = _head_kernels(cfg, state.sample_count, n, dtype)
    s = jnp.einsum("nlc,nlc->nc", wins, kern, preferred_element_type=dtype,
                   precision=jax.lax.Precision.HIGHEST)
    history = full[-(length - 1):] if length > 1 else full[:0]

    # 6. deemphasis
    post_reg = state.post
    if cfg.emulating_deemphasis:
        a_post = iir_alpha(cfg.rate, cfg.preemphasis_cut_hz)
        regs = []
        for i in range(c):
            s, r = _interleaved_stage(s, a_post, state.post[i], "deemph")
            regs.append(r)
        post_reg = jnp.stack(regs)

    out = clips16(s * 32768.0).astype(jnp.int32)

    # 7. mono downmix: audio[0] = audio[1] = (a0 + a1) / 2 (C trunc division)
    if cfg.mono_downmix and c == 2:
        mono = out[:, 0] + out[:, 1]
        mono = jnp.where(mono < 0, -((-mono) // 2), mono // 2)
        out = jnp.stack([mono, mono], axis=-1)

    new_state = CassetteState(
        bank_lo=bank_lo, bank_hi=bank_hi, pre=pre_reg, post=post_reg,
        history=history, sample_count=state.sample_count + n)
    return out, new_state
