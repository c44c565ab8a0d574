"""Audio chain tests: golden parity (hiss off) and streaming-state equality."""

import numpy as np
import jax
import jax.numpy as jnp

import golden.ref_scalar as ref
from cvsim_tpu.audio import (
    AudioState,
    buzz_pulse_counts,
    composite_audio_process,
    init_audio_state,
)
from cvsim_tpu.config import AudioConfig


def rand_audio(n, c, seed=0):
    rng = np.random.default_rng(seed)
    # band-limited-ish content so filters have something to do
    t = np.arange(n)[:, None]
    sig = (8000 * np.sin(2 * np.pi * 440 * t / 44100)
           + 4000 * np.sin(2 * np.pi * 3000 * t / 44100 + np.arange(c))
           + rng.normal(0, 800, size=(n, c)))
    return np.clip(sig, -32768, 32767).astype(np.int64)


def run_chain(audio, cfg, state=None, dtype=jnp.float64):
    if state is None:
        state = init_audio_state(cfg, dtype)
    pulses = None
    if not cfg.vhs_hifi:
        pulses = buzz_pulse_counts(cfg, int(state.sample_count), audio.shape[0])
    out, new_state = composite_audio_process(
        jnp.asarray(audio, jnp.int32), state, jax.random.PRNGKey(0),
        cfg=cfg, pulses=pulses, dtype=dtype)
    return np.asarray(out), new_state


def assert_close_lsb(got, want, lsb=2, frac=0.01):
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= lsb, f"max diff {diff.max()}"
    assert (diff > 0).mean() <= frac, f"{(diff > 0).mean()} mismatch"


def test_hifi_stereo_matches_golden():
    cfg = AudioConfig(hiss_db=-1000.0)  # hiss_level -> 0
    assert cfg.hiss_level == 0
    audio = rand_audio(3000, 2, seed=1)
    got, _ = run_chain(audio, cfg)
    want = ref.audio_chain_scalar(
        audio, cfg.rate, 2, cfg.lowpass_hz, cfg.highpass_hz,
        preemph=True, deemph=True, pre_cut=cfg.preemphasis_cut_hz,
        vhs_hifi=True)
    assert_close_lsb(got, want)


def test_linear_mono_with_buzz_and_boost():
    cfg = AudioConfig(hiss_db=-1000.0, vhs_hifi=False, channels=1,
                      lowpass_hz=4000.0, highpass_hz=100.0,
                      preemphasis_cut_hz=8000.0,
                      emulating_preemphasis=False, emulating_deemphasis=False)
    audio = rand_audio(3000, 1, seed=2)
    got, _ = run_chain(audio, cfg)
    want = ref.audio_chain_scalar(
        audio, cfg.rate, 1, 4000.0, 100.0, preemph=False, deemph=False,
        pre_cut=8000.0, vhs_hifi=False, buzz_db=cfg.linear_buzz_db,
        high_boost=cfg.linear_high_boost)
    assert_close_lsb(got, want)


def test_linear_pal_buzz_matches_golden():
    """PAL buzz timing: hsync 15625 Hz, 625 lines, vpulse<12, hpulse 4.0us
    (ffmpeg_to_composite.cpp:561-564); the oracle itself is pinned bit-exact
    against the compiled reference in test_ref_crosscheck.py."""
    cfg = AudioConfig(hiss_db=-1000.0, vhs_hifi=False, ntsc=False,
                      channels=2, rate=48000, lowpass_hz=10000.0,
                      highpass_hz=100.0, preemphasis_cut_hz=8000.0)
    audio = rand_audio(3000, 2, seed=5)
    got, _ = run_chain(audio, cfg)
    want = ref.audio_chain_scalar(
        audio, cfg.rate, 2, cfg.lowpass_hz, cfg.highpass_hz,
        preemph=True, deemph=True, pre_cut=8000.0, vhs_hifi=False,
        buzz_db=cfg.linear_buzz_db, high_boost=cfg.linear_high_boost,
        ntsc=False)
    assert_close_lsb(got, want)


def test_streaming_chunks_match_whole():
    """Chunked processing with carried state == one-shot processing."""
    cfg = AudioConfig(hiss_db=-1000.0, vhs_hifi=False, channels=2,
                      lowpass_hz=10000.0, highpass_hz=100.0)
    audio = rand_audio(4096, 2, seed=3)
    whole, _ = run_chain(audio, cfg)

    state = init_audio_state(cfg, jnp.float64)
    outs = []
    pos = 0
    for size in (1000, 37, 2000, 1059):
        chunk = audio[pos:pos + size]
        pulses = buzz_pulse_counts(cfg, pos, size)
        out, state = composite_audio_process(
            jnp.asarray(chunk, jnp.int32), state, jax.random.PRNGKey(0),
            cfg=cfg, pulses=pulses, dtype=jnp.float64)
        outs.append(np.asarray(out))
        pos += size
    chunked = np.concatenate(outs)
    assert_close_lsb(chunked, whole, lsb=1, frac=0.001)


def test_buzz_is_audible_and_periodic():
    cfg = AudioConfig(vhs_hifi=False, channels=1)
    p = buzz_pulse_counts(cfg, 0, 44100)
    assert p.max() >= 1           # pulses present
    assert p.min() >= 0
    # pulse duty: hsync 4.7us * 15734Hz ~ 7.4% of slots + vsync lines
    # 10/262.5 ~ 3.8% -> ~1.8 of 16 slots per sample on average
    assert 1.0 <= p.mean() <= 3.0


def test_hiss_statistics():
    cfg = AudioConfig(hiss_db=-40.0)
    level = cfg.hiss_level
    assert level > 0
    audio = np.zeros((8000, 2), np.int64)
    got, _ = run_chain(audio, cfg, dtype=jnp.float32)
    # silence in, hiss out: nonzero with bounded amplitude
    assert np.abs(got).max() > 0


def test_cassette_matches_golden():
    from cvsim_tpu.audio.cassette import (
        CassetteConfig, cassette_audio_process, init_cassette_state)

    cfg = CassetteConfig(hiss_db=-1000.0, head_tilt=3.5, head_tilt_waver=0.55,
                         lowpass_hz=16000.0, highpass_hz=100.0)
    assert cfg.hiss_level == 0
    audio = rand_audio(2000, 2, seed=7)
    state = init_cassette_state(cfg, jnp.float64)
    got, _ = cassette_audio_process(
        jnp.asarray(audio, jnp.int32), state, jax.random.PRNGKey(0),
        cfg=cfg, dtype=jnp.float64)
    want = ref.cassette_chain_scalar(
        audio, cfg.rate, 2, cfg.lowpass_hz, cfg.highpass_hz,
        head_tilt=cfg.head_tilt, head_tilt_waver=cfg.head_tilt_waver,
        pre_cut=cfg.preemphasis_cut_hz)
    assert_close_lsb(np.asarray(got), want)


def test_cassette_streaming_chunks():
    from cvsim_tpu.audio.cassette import (
        CassetteConfig, cassette_audio_process, init_cassette_state)

    cfg = CassetteConfig(hiss_db=-1000.0, head_tilt=1.1, head_tilt_waver=0.25,
                         mono_downmix=True)
    audio = rand_audio(3000, 2, seed=8)
    state = init_cassette_state(cfg, jnp.float64)
    whole, _ = cassette_audio_process(
        jnp.asarray(audio, jnp.int32), state, jax.random.PRNGKey(0),
        cfg=cfg, dtype=jnp.float64)

    state = init_cassette_state(cfg, jnp.float64)
    outs = []
    pos = 0
    for size in (700, 1300, 1000):
        out, state = cassette_audio_process(
            jnp.asarray(audio[pos:pos+size], jnp.int32), state,
            jax.random.PRNGKey(0), cfg=cfg, dtype=jnp.float64)
        outs.append(np.asarray(out))
        pos += size
    assert_close_lsb(np.concatenate(outs), np.asarray(whole), lsb=1, frac=0.001)


def test_streaming_equals_whole_with_hiss():
    """Hiss is content-addressed per absolute sample index, so chunked
    streaming with ONE base key is bit-identical to one-shot processing."""
    cfg = AudioConfig(hiss_db=-40.0, vhs_hifi=False, channels=2,
                      emulating_preemphasis=True, emulating_deemphasis=True)
    assert cfg.hiss_level > 0
    rng = np.random.default_rng(7)
    audio = rng.integers(-20000, 20000, (4096, 2))
    key = jax.random.PRNGKey(11)

    def run(dtype, chunk):
        whole, _ = composite_audio_process(
            jnp.asarray(audio, jnp.int32), init_audio_state(cfg, dtype), key,
            cfg=cfg, pulses=buzz_pulse_counts(cfg, 0, 4096), dtype=dtype)
        state = init_audio_state(cfg, dtype)
        outs = []
        for pos in range(0, 4096, chunk):
            part = audio[pos:pos + chunk]
            out, state = composite_audio_process(
                jnp.asarray(part, jnp.int32), state, key, cfg=cfg,
                pulses=buzz_pulse_counts(cfg, pos, len(part)), dtype=dtype)
            outs.append(np.asarray(out))
        return np.concatenate(outs), np.asarray(whole)

    # f64: bit-exact at any chunking (the hiss keys are content-addressed).
    got, whole = run(jnp.float64, 1000)
    np.testing.assert_array_equal(got, whole)
    # f32: the blocked-IIR reduction tree depends on sequence length, so
    # chunking may differ by 1 int16 LSB on rounding-boundary samples.
    got, whole = run(jnp.float32, 1024)
    assert np.abs(got.astype(np.int64) - whole.astype(np.int64)).max() <= 1


def test_cassette_streaming_equals_whole_with_hiss():
    from cvsim_tpu.audio.cassette import (
        CassetteConfig, cassette_audio_process, init_cassette_state)
    cfg = CassetteConfig(hiss_db=-50.0, head_tilt=1.1, head_tilt_waver=0.25,
                         channels=2)
    assert cfg.hiss_level > 0
    rng = np.random.default_rng(8)
    audio = rng.integers(-20000, 20000, (3000, 2))
    key = jax.random.PRNGKey(12)

    whole, _ = cassette_audio_process(
        jnp.asarray(audio, jnp.int32), init_cassette_state(cfg), key, cfg=cfg)

    state = init_cassette_state(cfg)
    outs = []
    for pos in range(0, 3000, 768):   # 768*2ch aligns to the IIR block grid
        part = audio[pos:pos + 768]
        out, state = cassette_audio_process(
            jnp.asarray(part, jnp.int32), state, key, cfg=cfg)
        outs.append(np.asarray(out))
    # The carried-state math is chunk-invariant; bit-equality additionally
    # needs shape-independent float scheduling, which XLA does not promise:
    # it contracts FMAs shape-dependently, so a sample sitting within an
    # ULP of a truncation boundary may flip by 1 LSB — bound it.
    chunked = np.concatenate(outs)
    want = np.asarray(whole)
    diff = np.abs(chunked.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() < 1e-3, (diff != 0).mean()


def test_sinc_resampler_quality():
    """Windowed-sinc resampler: clean in-band tones both directions, strong
    alias rejection on downsample, exact DC."""
    from cvsim_tpu.host.pipeline import _resample_sinc

    def snr(y, ideal):
        err = y[200:-200] - ideal[200:-200]
        return 10 * np.log10((ideal[200:-200] ** 2).mean() / (err ** 2).mean())

    t = np.arange(32000) / 32000.0
    x = (20000 * np.sin(2 * np.pi * 1000.0 * t))[:, None].astype(np.int64)
    y = _resample_sinc(x, 32000, 44100)[:, 0].astype(np.float64)
    assert len(y) == 44100
    ideal = 20000 * np.sin(2 * np.pi * 1000.0 * np.arange(len(y)) / 44100.0)
    assert snr(y, ideal) > 70.0

    # 15 kHz is above the 11.025 kHz output Nyquist: must be rejected
    xx = (20000 * np.sin(2 * np.pi * 15000.0 * np.arange(44100) / 44100.0))
    y = _resample_sinc(xx[:, None].astype(np.int64), 44100, 22050)[:, 0]
    assert np.sqrt((y[200:-200].astype(np.float64) ** 2).mean()) < 200.0

    dc = np.full((8000, 2), 12345, np.int64)
    y = _resample_sinc(dc, 48000, 44100)
    assert np.all(y == 12345)
