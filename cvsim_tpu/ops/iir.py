"""One-pole IIR primitives as parallel scans.

The reference's `LowpassFilter` (ffmpeg_to_composite.cpp:99-131) is the basis
of every frequency-domain effect in the suite:

    y[t] = alpha * x[t] + (1 - alpha) * y[t-1],   y[-1] = y0 (reset value)
    highpass(x)[t] = x[t] - lowpass(x)[t]

The reference runs it sequentially per scanline sample. Scanlines (and fields
in a batch) are mutually independent — filter state is constructed fresh per
scanline — so we vectorize over (batch, line) and parallelize the
scanline-sample recurrence itself with `lax.associative_scan` over the sample
axis (a first-order linear recurrence is an associative affine composition).

This yields identical results to the sequential loop up to floating-point
reassociation; golden tests bound the difference post-quantization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _affine_combine(left, right):
    """Compose affine updates y -> a*y + b: right after left."""
    a_l, b_l = left
    a_r, b_r = right
    return a_r * a_l, a_r * b_l + b_r


def iir_lowpass_scan(x: jax.Array, alpha, y0, axis: int = -1) -> jax.Array:
    """Parallel associative-scan one-pole lowpass along `axis` (reference
    implementation; the production path is the blocked-matmul version)."""
    x = jnp.asarray(x)
    dtype = x.dtype
    alpha = jnp.asarray(alpha, dtype)
    one_m = jnp.asarray(1.0, dtype) - alpha

    a = jnp.broadcast_to(one_m, x.shape)
    b = alpha * x
    a_cum, b_cum = jax.lax.associative_scan(_affine_combine, (a, b), axis=axis)
    y0 = jnp.asarray(y0, dtype)
    if jnp.ndim(y0) != 0:
        y0 = jnp.expand_dims(y0, axis)
    return a_cum * y0 + b_cum


def iir_lowpass(x: jax.Array, alpha, y0, axis: int = -1) -> jax.Array:
    """One-pole lowpass along `axis`.

    alpha: scalar filter coefficient (see config.iir_alpha).
    y0: reset value of the filter register (LowpassFilter::resetFilter) —
        scalar or array broadcastable to x with `axis` removed.

    Dispatches to the blocked-matmul formulation on the last axis (the
    hot path: scanline samples / audio samples) and to the associative scan
    otherwise.
    """
    from cvsim_tpu.ops.blocked_iir import iir_lowpass_blocked

    x = jnp.asarray(x)
    if axis in (-1, x.ndim - 1):
        return iir_lowpass_blocked(x, alpha, y0)
    return iir_lowpass_scan(x, alpha, y0, axis=axis)


def iir_lowpass_cascade(x: jax.Array, alpha, y0, passes: int, axis: int = -1) -> jax.Array:
    """N identical one-pole lowpasses in series (each with its own register,
    all reset to y0) — the `LowpassFilter lp[3]` idiom.  Groups of three
    compose into a single T^3 blocked matmul on the sample axis (a third
    of the matmul work; ops/blocked_iir.iir_lowpass3_blocked)."""
    from cvsim_tpu.ops.blocked_iir import iir_lowpass3_blocked

    x = jnp.asarray(x)
    y = x
    last_axis = axis in (-1, x.ndim - 1)
    while passes >= 3 and last_axis:
        y = iir_lowpass3_blocked(y, alpha, y0)
        passes -= 3
    for _ in range(passes):
        y = iir_lowpass(y, alpha, y0, axis=axis)
    return y


def cascade_emph(x, alpha, y0, passes: int, gain: float):
    """cascade(x) then s += highpass_alpha(s) * gain — the VHS-luma /
    preemphasis stage shape."""
    s = iir_lowpass_cascade(x, alpha, y0, passes)
    return s + iir_highpass(s, alpha, y0) * jnp.asarray(gain, x.dtype)


def cascade_unsharp(x, alpha, y0, passes: int, gain: float):
    """x + (x - cascade(x)) * gain — the VHS sharpen stage shape."""
    ts = iir_lowpass_cascade(x, alpha, y0, passes)
    return x + (x - ts) * jnp.asarray(gain, x.dtype)


def iir_highpass(x: jax.Array, alpha, y0, axis: int = -1) -> jax.Array:
    """highpass = x - lowpass(x) (ffmpeg_to_composite.cpp:120-124)."""
    return x - iir_lowpass(x, alpha, y0, axis=axis)


def delay_writeback(orig: jax.Array, filtered: jax.Array, delay: int, axis: int = -1) -> jax.Array:
    """Reproduce the reference's in-place delayed writeback:

        for x: ... if (x >= delay) P[x-delay] = f(P[x])

    i.e. out[i] = filtered[i+delay] for i < W-delay, and the final `delay`
    samples keep their original values (they are never written).
    """
    if delay == 0:
        return filtered
    w = orig.shape[axis]
    shifted = jax.lax.slice_in_dim(filtered, delay, w, axis=axis)
    tail = jax.lax.slice_in_dim(orig, w - delay, w, axis=axis)
    return jnp.concatenate([shifted, tail], axis=axis)
