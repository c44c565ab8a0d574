"""Noise generators.

The reference uses unseeded libc rand() with a smoothed random-walk idiom
(ffmpeg_to_composite.cpp:661-663):

    use n; n += rand() % (2*mag + 1) - mag; n /= 2

Exact rand() parity is meaningless (libc-specific); per SURVEY.md section 7 we
target *statistical* parity: same increment distribution (uniform over
2*mag+1 values, the same modulo idiom) and the same first-order decay
recurrence, deterministic per seed and independent of evaluation order.

Generator: a splitmix32 counter stream (golden-ratio counter step + murmur3
avalanche finalizer). Every draw is a pure function of
(seed, fieldno, stage, element index) — "content-addressed", so output is
invariant to GOP batching and restarts. splitmix32 is ~7 integer ops per
element, against the 20 rounds of jax.random's threefry block cipher, for
visual noise whose reference is a libc LCG; it passes the statistical checks
in tests/test_properties.py and is far above rand()'s quality. The golden
full-chain hashes are pinned in tests/test_golden_clip.py.

The recurrence n[t] = (n[t-1] + u[t]) / 2 is affine, so it runs as the
blocked-matmul IIR instead of a sequential loop.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cvsim_tpu.ops.iir import iir_lowpass

_GOLDEN = np.uint32(0x9E3779B9)


def mix32(x):
    """murmur3/splitmix32 avalanche finalizer over uint32."""
    x = jnp.asarray(x, jnp.uint32)
    x = (x ^ (x >> 16)) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> 13)) * np.uint32(0xC2B2AE35)
    return x ^ (x >> 16)


def _key32(key):
    """Collapse a jax PRNG key (typed or raw [2]u32) to one u32 seed."""
    try:
        kd = jax.random.key_data(key)
    except (TypeError, AttributeError):
        kd = jnp.asarray(key)
    kd = kd.astype(jnp.uint32).reshape(-1)
    return mix32(kd[0] ^ mix32(kd[-1]))


def _bits(key32, idx):
    """splitmix32 stream: word i of stream `key32` (idx uint32 array)."""
    return mix32(jnp.asarray(key32, jnp.uint32) + idx * _GOLDEN)


def _randint_bits(bits, lo: int, hi: int):
    """bits % span + lo — the reference's own rand() % span idiom; the
    modulo bias over 2^32 is < 1e-4 for every span used here."""
    span = np.uint32(hi - lo)
    return (bits % span).astype(jnp.int32) + lo


def _counters(shape):
    n = int(np.prod(shape)) if shape else 1
    return jnp.arange(n, dtype=jnp.uint32)


def random_walk(key, shape, mag: int, axis: int = -1, dtype=jnp.float32):
    """Post-update walk values n[t] = (n[t-1] + u[t]) / 2, n[-1] = 0,
    u ~ uniform int in [-mag, mag].

    This is exactly a one-pole lowpass with alpha=0.5 over the increment
    stream, so it runs on the blocked-matmul IIR path."""
    u = _randint_bits(_bits(_key32(key), _counters(shape)), -mag, mag + 1)
    u = u.reshape(shape).astype(dtype)
    return iir_lowpass(u, 0.5, 0.0, axis=axis)


def smoothed_noise_walk(key, shape, mag: int, axis: int = -1, dtype=jnp.float32):
    """Pre-update walk values as *used* by the video-noise loops: the value
    added at sample t is the walk state before the t'th update, i.e.
    [0, n[0], n[1], ...]."""
    post = random_walk(key, shape, mag, axis=axis, dtype=dtype)
    w = post.shape[axis]
    head = jnp.zeros_like(jax.lax.slice_in_dim(post, 0, 1, axis=axis))
    return jnp.concatenate(
        [head, jax.lax.slice_in_dim(post, 0, w - 1, axis=axis)], axis=axis
    )


def uniform_pm1(key, shape=(), dtype=jnp.float32):
    """Uniform in [-1, 1) — used for head-switching phase jitter
    (ffmpeg_to_composite.cpp:675-680). Uses the top 24 bits so every value
    is exactly representable in f32 and the half-open bound holds (full
    32-bit values near 2^32 would round UP to 2^32 and map to +1.0)."""
    bits = _bits(_key32(key), _counters(shape)).reshape(shape)
    return (bits >> 8).astype(dtype) * dtype(2.0 ** -23) - dtype(1.0)


def randint_stream(key, shape, lo: int, hi: int):
    """[shape] int32 in [lo, hi) from stream `key` (any _key32-able seed).

    The content-addressed replacement for jax.random.randint in the tool
    ops: bit-identical to ops/noise_np.randint_stream so the host-numpy CLI
    path and the jittable deployment path key the same pixels."""
    idx = _counters(shape)
    return _randint_bits(_bits(_key32(key), idx), lo, hi).reshape(shape)


def field_stage_keys(key, fieldno, stage: int):
    """Content-addressed per-field stream ids (u32 [B]): noise for field N
    is a pure function of (seed, N, stage) — independent of how fields are
    batched (GOP size, restarts), unlike per-batch key splitting."""
    base = _key32(key) ^ mix32(np.uint32((stage * 0x632BE59B) & 0xFFFFFFFF))
    f = jnp.asarray(fieldno).astype(jnp.uint32)
    return mix32(base + f * _GOLDEN)


def randint_per_field(keys, shape, lo, hi):
    """keys: [B] u32 stream ids. Returns [B, *shape] int32 in [lo, hi)."""
    idx = _counters(shape)
    bits = _bits(keys[:, None], idx[None, :])
    out = _randint_bits(bits, lo, hi)
    return out.reshape((keys.shape[0],) + tuple(shape))


def random_walk_per_field(keys, n: int, mag: int, dtype=jnp.float32):
    """Per-field post-update walks [B, n]."""
    u = randint_per_field(keys, (n,), -mag, mag + 1)
    return iir_lowpass(u.astype(dtype), 0.5, 0.0, axis=-1)


def smoothed_noise_walk_rows(keys, l: int, w: int, mag: int,
                             dtype=jnp.float32):
    """Per-scanline smoothed walks [B, l, w].

    Identical content-addressed increment stream as the per-field variant
    (element (y, x) draws stream index y*w + x), but the walk recurrence
    resets to 0 at each line start — like every other per-scanline filter
    register in the reference. The walk's alpha-0.5 correlation dies within
    ~20 samples, so the distributions are unchanged except at the first few
    pixels of a line (statistical-parity contract, SURVEY §7 hard-part 2).
    With per-row reset each line's walk depends only on its own row, so a
    line-sharded batch needs no carry between shards."""
    u = randint_per_field(keys, (l, w), -mag, mag + 1)
    post = iir_lowpass(u.astype(dtype), 0.5, 0.0, axis=-1)
    head = jnp.zeros_like(post[..., :1])
    return jnp.concatenate([head, post[..., :-1]], axis=-1)


def chroma_noise_walk_rows(keys, l: int, w: int, mag: int,
                           dtype=jnp.float32):
    """Two per-scanline smoothed walk planes [B, 2, l, w] (I/Q or U/V);
    plane c's element (y, x) draws stream index c*l*w + y*w + x."""
    u = randint_per_field(keys, (2, l, w), -mag, mag + 1)
    post = iir_lowpass(u.astype(dtype), 0.5, 0.0, axis=-1)
    head = jnp.zeros_like(post[..., :1])
    return jnp.concatenate([head, post[..., :-1]], axis=-1)


def uniform_pm1_per_field(keys, dtype=jnp.float32):
    """[-1, 1), exact-in-f32 (see uniform_pm1)."""
    bits = _bits(keys, jnp.zeros_like(keys))
    return (bits >> 8).astype(dtype) * dtype(2.0 ** -23) - dtype(1.0)


def hiss_per_sample(key, start, n: int, c: int, level: int,
                    dtype=jnp.float32):
    """Content-addressed iid audio hiss: the noise added to sample t is a
    pure function of (seed, absolute sample index start + t, channel), so
    streaming in chunks with a carried sample counter is bit-identical to
    one-shot processing (mirrors field_stage_keys for video). Returns
    [n, c] in [-level, level]."""
    idx = (jnp.asarray(start, jnp.uint32)
           + jnp.arange(n, dtype=jnp.uint32))[:, None]
    ch = jnp.arange(c, dtype=jnp.uint32)[None, :]
    bits = _bits(_key32(key), idx * np.uint32(c) + ch)
    return _randint_bits(bits, -level, level + 1).astype(dtype)
