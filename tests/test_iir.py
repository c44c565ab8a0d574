"""Unit tests for the scan-based IIR primitives against sequential float64."""

import numpy as np
import jax.numpy as jnp

from cvsim_tpu.config import iir_alpha, NTSC_RATE
from cvsim_tpu.ops.blocked_iir import iir_lowpass_blocked
from cvsim_tpu.ops.iir import (
    delay_writeback,
    iir_highpass,
    iir_lowpass,
    iir_lowpass_cascade,
    iir_lowpass_scan,
)
from golden.ref_scalar import Lowpass


def seq_lowpass(x, rate, hz, reset):
    f = Lowpass(rate, hz, reset)
    return np.array([f.lowpass(float(s)) for s in x])


def test_lowpass_matches_sequential():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, size=257)
    alpha = iir_alpha(NTSC_RATE, 1300000.0)
    got = np.asarray(iir_lowpass(jnp.asarray(x, jnp.float64), alpha, 128.0))
    want = seq_lowpass(x, NTSC_RATE, 1300000.0, 128.0)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_lowpass_batched_axes():
    rng = np.random.default_rng(1)
    x = rng.uniform(-100, 100, size=(3, 5, 64))
    alpha = iir_alpha(NTSC_RATE, 600000.0)
    got = np.asarray(iir_lowpass(jnp.asarray(x, jnp.float64), alpha, 0.0))
    for b in range(3):
        for l in range(5):
            want = seq_lowpass(x[b, l], NTSC_RATE, 600000.0, 0.0)
            np.testing.assert_allclose(got[b, l], want, rtol=1e-9, atol=1e-9)


def test_cascade_matches_sequential():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 255, size=128)
    alpha = iir_alpha(NTSC_RATE, 2400000.0)
    got = np.asarray(
        iir_lowpass_cascade(jnp.asarray(x, jnp.float64), alpha, 16.0, 3))
    fs = [Lowpass(NTSC_RATE, 2400000.0, 16.0) for _ in range(3)]
    want = []
    for s in x:
        v = float(s)
        for f in fs:
            v = f.lowpass(v)
        want.append(v)
    np.testing.assert_allclose(got, np.array(want), rtol=1e-9, atol=1e-9)


def test_highpass_identity():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(0, 255, size=64), jnp.float64)
    alpha = iir_alpha(NTSC_RATE, 1000000.0)
    hp = iir_highpass(x, alpha, 16.0)
    lp = iir_lowpass(x, alpha, 16.0)
    np.testing.assert_allclose(np.asarray(hp + lp), np.asarray(x), rtol=1e-12)


def test_blocked_matches_sequential():
    """Blocked-matmul IIR vs sequential float64, including non-multiple-of-128
    widths, nonzero reset values, and batched axes."""
    rng = np.random.default_rng(7)
    for w in (64, 128, 257, 704):
        x = rng.uniform(0, 65280, size=(2, 3, w))
        for hz, y0 in ((1300000.0, 0.0), (280000.0, 128.0), (2400000.0, 16.0)):
            alpha = iir_alpha(NTSC_RATE, hz)
            got = np.asarray(
                iir_lowpass_blocked(jnp.asarray(x, jnp.float64), alpha, y0))
            for b in range(2):
                for l in range(3):
                    want = seq_lowpass(x[b, l], NTSC_RATE, hz, y0)
                    np.testing.assert_allclose(
                        got[b, l], want, rtol=1e-9, atol=1e-6)


def test_blocked_long_axis_scan_carry():
    """Large block counts (noise walks over L*W) take the scan-carry path."""
    rng = np.random.default_rng(9)
    x = rng.uniform(-16, 16, size=(2, 4096))
    got = np.asarray(iir_lowpass_blocked(jnp.asarray(x, jnp.float64), 0.5, 3.0))
    for b in range(2):
        f = 3.0
        want = []
        for s in x[b]:
            f = 0.5 * s + 0.5 * f
            want.append(f)
        np.testing.assert_allclose(got[b], np.array(want), rtol=1e-9, atol=1e-9)


def test_blocked_matches_scan_f32():
    """In float32 (the production dtype) blocked and scan paths agree to
    float32 tolerance on plane-scale values."""
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.uniform(-32768, 65280, size=(4, 704)), jnp.float32)
    alpha = iir_alpha(NTSC_RATE, 600000.0)
    a = np.asarray(iir_lowpass_blocked(x, alpha, 0.0))
    b = np.asarray(iir_lowpass_scan(x, alpha, 0.0))
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=0.25)


def test_delay_writeback():
    orig = jnp.arange(10)
    filt = jnp.arange(10) * 100
    out = np.asarray(delay_writeback(orig, filt, 3))
    # out[i] = filt[i+3] for i < 7; tail keeps original
    np.testing.assert_array_equal(out[:7], np.arange(3, 10) * 100)
    np.testing.assert_array_equal(out[7:], [7, 8, 9])
    np.testing.assert_array_equal(
        np.asarray(delay_writeback(orig, filt, 0)), np.asarray(filt))


def test_roll_rows_max_shift():
    from cvsim_tpu.ops.roll import roll_rows

    rng = np.random.default_rng(11)
    a = jnp.asarray(rng.integers(0, 100, (4, 37)))
    s = jnp.asarray([0, 1, 2, 3])
    full = np.asarray(roll_rows(a, s))
    trimmed = np.asarray(roll_rows(a, s, max_shift=3))
    np.testing.assert_array_equal(full, trimmed)
    for r in range(4):
        np.testing.assert_array_equal(trimmed[r], np.roll(np.asarray(a)[r], -int(s[r])))


def test_cascade3_blocked_multiblock_carry():
    """The composed T^3 cascade (one matmul per block + 3-state carry
    chain) must match three sequential blocked passes across MANY blocks
    to f32 rounding, including a nonzero reset value."""
    from cvsim_tpu.ops.blocked_iir import (iir_lowpass3_blocked,
                                           iir_lowpass_blocked)

    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.uniform(0, 255, size=(3, 5, 704)), jnp.float32)
    alpha = float(iir_alpha(NTSC_RATE, 600000.0))
    got = np.asarray(iir_lowpass3_blocked(x, alpha, 128.0))
    ref = x
    for _ in range(3):
        ref = iir_lowpass_blocked(ref, alpha, 128.0)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=3e-6, atol=2e-3)
    # f64: both formulations agree to ~1e-9 of the sequential truth
    xd = x.astype(jnp.float64)
    got64 = np.asarray(iir_lowpass3_blocked(xd, alpha, 128.0))
    ref64 = xd
    for _ in range(3):
        ref64 = iir_lowpass_blocked(ref64, alpha, 128.0)
    np.testing.assert_allclose(got64, np.asarray(ref64), rtol=1e-11,
                               atol=1e-8)
