"""Golden-clip regression guard: full chains with ALL stochastic stages on,
seeded, hashed. Catches any unintended behavior change across refactors
(jax.random is deterministic per key; float64 CPU math is stable).

If a change is *intended* to alter output (new quirk fix, reordered RNG
consumption), update the hashes and say why in the commit message.
"""

import hashlib

import numpy as np
import jax
import jax.numpy as jnp

from cvsim_tpu.config import CompositeConfig, VHSSpeed
from cvsim_tpu.models import yiq, yuv422

L, W = 16, 128

# Re-pinned twice for intended stream changes, same distributions:
# 1) noise generator moved from jax.random threefry to the splitmix32
#    counter stream (ops/noise.py docstring; ~2.5x less device time);
# 2) noise walks reset per scanline instead of running across the field
#    (ops/noise.smoothed_noise_walk_rows), so a line block's noise needs
#    no stream carry from the lines above it.
YIQ_HASH = "6a10e6e35177d940f926785ece50ff0280b4f7868fd8ce768c4edb67cd779087"
YUV_HASH = "6ba3b3efcd23616c95aaf5829666b0dd6e68e99b466281e30ce5a3c80ec20201"


def _cfg():
    return CompositeConfig(
        emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP,
        vhs_head_switching=True, vhs_head_switching_point=0.15,
        vhs_head_switching_phase=0.15, vhs_head_switching_phase_noise=0.0,
        video_noise=6, video_chroma_noise=22, video_chroma_phase_noise=6,
        video_chroma_loss=100)


def _hash(planes):
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(np.asarray(t, np.int64)).tobytes()
        for t in planes)).hexdigest()


def test_yiq_golden_clip():
    rng = np.random.default_rng(42)
    y = jnp.asarray(rng.integers(0, 65280, (2, L, W)), jnp.int32)
    i = jnp.asarray(rng.integers(-8000, 8000, (2, L, W)), jnp.int32)
    q = jnp.asarray(rng.integers(-8000, 8000, (2, L, W)), jnp.int32)
    out = yiq.composite_layer(
        y, i, q, cfg=_cfg(), fieldno=jnp.array([0, 1], jnp.int32),
        field_parity=jnp.array([0, 1], jnp.int32),
        key=jax.random.PRNGKey(123), dtype=jnp.float64)
    assert _hash(out) == YIQ_HASH


def test_yuv422_golden_clip():
    rng = np.random.default_rng(42)
    _ = rng.integers(0, 65280, (2, L, W))      # keep draw order aligned
    _ = rng.integers(-8000, 8000, (2, L, W))
    _ = rng.integers(-8000, 8000, (2, L, W))
    y = jnp.asarray(rng.integers(16, 236, (2, L, W)), jnp.int32)
    u = jnp.asarray(rng.integers(16, 241, (2, L, W // 2)), jnp.int32)
    v = jnp.asarray(rng.integers(16, 241, (2, L, W // 2)), jnp.int32)
    out = yuv422.composite_video_process(
        y, u, v, cfg=_cfg(), fieldno=jnp.array([0, 1], jnp.int32),
        field_parity=jnp.array([0, 1], jnp.int32),
        key=jax.random.PRNGKey(123), dtype=jnp.float64)
    assert _hash(out) == YUV_HASH
