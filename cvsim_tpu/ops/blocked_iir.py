"""One-pole IIR as a blocked lower-triangular matmul.

The recurrence y[t] = a*x[t] + (1-a)*y[t-1] has the closed form

    y[t] = sum_k a*(1-a)^(t-k) x[k]  +  (1-a)^(t+1) y0

Split the sample axis into blocks of size K. Within a block the map
x_block -> y_block (ignoring carry-in) is multiplication by the dense lower-
triangular K x K matrix T[i,j] = a*(1-a)^(i-j); the carry-in contributes
d[i] = (1-a)^(i+1) times the previous block's final value. The carry itself
obeys c_b = yw_b[K-1] + (1-a)^K * c_{b-1} — a scalar recurrence over the
handful of blocks, unrolled in Python.

This replaces an O(W log W) associative scan with one matmul pass plus an
O(W/K) fixup, which is how the reference's per-scanline filters
(ffmpeg_to_composite.cpp:99-131) run over [batch, lines, samples] tensors.
K = 128 is a fixed choice; other block sizes have not been measured.

Numerics: every matmul asks for Precision.HIGHEST, i.e. true float32
products. Without it an H100 computes them in TF32 (about 10 mantissa
bits), and 0.5-15% of the chains' output samples move by up to 3 LSB
against the float64 oracle. In float32 the result matches the sequential
float64 loop to within float32 rounding: after truncation to integers at
most 1 LSB on a small fraction of samples (tests/test_iir.py,
tests/test_golden_chain.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

BLOCK = 128
_HIGHEST = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=64)
def _decay_consts(alpha: float, block: int, np_dtype: str):
    """(T [K,K], d [K], pK scalar) as numpy constants for a given alpha."""
    a = np.float64(alpha)
    one_m = 1.0 - a
    i = np.arange(block)
    # T[i,j] = a * (1-a)^(i-j) for i >= j
    expo = i[:, None] - i[None, :]
    T = np.where(expo >= 0, a * one_m ** np.maximum(expo, 0), 0.0)
    d = one_m ** (i + 1.0)
    pk = one_m ** float(block)
    dt = np.dtype(np_dtype)
    return T.astype(dt), d.astype(dt), dt.type(pk)


@functools.lru_cache(maxsize=64)
def _cascade3_consts(alpha: float, block: int, np_dtype: str):
    """Constants for THREE identical poles composed into one matmul.

    y1 = T x + d c1;  y2 = T y1 + d c2;  y3 = T y2 + d c3  composes to
        y3 = T^3 x + (T^2 d) c1 + (T d) c2 + d c3
    and the block-end carries (last element of y1/y2/y3) need only the
    last ROWS of T and T^2.  All powers computed in float64, cast once.
    Returns (T3 [K,K], dc1 [K], dc2 [K], d [K], V12 [2,K]) with
    V12 = [T[K-1,:]; T^2[K-1,:]].
    """
    a = np.float64(alpha)
    one_m = 1.0 - a
    i = np.arange(block)
    expo = i[:, None] - i[None, :]
    T = np.where(expo >= 0, a * one_m ** np.maximum(expo, 0), 0.0)
    d = one_m ** (i + 1.0)
    T2 = T @ T
    T3 = T2 @ T
    dc1 = T2 @ d
    dc2 = T @ d
    v12 = np.stack([T[block - 1, :], T2[block - 1, :]])
    dt = np.dtype(np_dtype)
    return (T3.astype(dt), dc1.astype(dt), dc2.astype(dt), d.astype(dt),
            v12.astype(dt))


def iir_lowpass3_blocked(x: jax.Array, alpha, y0, block: int = BLOCK) -> jax.Array:
    """Three identical one-pole lowpasses in series (`LowpassFilter lp[3]`,
    all registers reset to y0) as ONE blocked matmul per 128-sample block —
    a third of the matmul work of three sequential iir_lowpass_blocked
    passes. Long axes (nb > 16: noise walks, audio) fall back to three
    sequential passes.
    """
    x = jnp.asarray(x)
    dtype = x.dtype
    w = x.shape[-1]
    nb = -(-w // block)
    if nb > 16:
        y = x
        for _ in range(3):
            y = iir_lowpass_blocked(y, alpha, y0, block)
        return y
    pad = nb * block - w

    consts = _cascade3_consts(float(alpha), block, np.dtype(dtype).name)
    T3, dc1, dc2, d, v12 = (jnp.asarray(c) for c in consts)
    dl = d[-1]
    s2 = dc2[-1]
    q1 = dc1[-1]

    xb = x if pad == 0 else jnp.concatenate(
        [x, jnp.zeros(x.shape[:-1] + (pad,), dtype)], axis=-1)
    xb = xb.reshape(x.shape[:-1] + (nb, block))

    yw3 = jnp.einsum("ij,...bj->...bi", T3, xb,
                     preferred_element_type=dtype, precision=_HIGHEST)
    # block-end responses of the three stages with zero carry
    u12 = jnp.einsum("kj,...bj->...bk", v12, xb,
                     preferred_element_type=dtype, precision=_HIGHEST)
    u1 = u12[..., 0]
    u2 = u12[..., 1]
    u3 = yw3[..., -1]

    y0b = jnp.broadcast_to(jnp.asarray(y0, dtype), x.shape[:-1])
    c1 = c2 = c3 = y0b
    c1s, c2s, c3s = [], [], []
    for b in range(nb):
        c1s.append(c1)
        c2s.append(c2)
        c3s.append(c3)
        nc1 = u1[..., b] + dl * c1
        nc2 = u2[..., b] + s2 * c1 + dl * c2
        nc3 = u3[..., b] + q1 * c1 + s2 * c2 + dl * c3
        c1, c2, c3 = nc1, nc2, nc3
    C1 = jnp.stack(c1s, axis=-1)[..., None]
    C2 = jnp.stack(c2s, axis=-1)[..., None]
    C3 = jnp.stack(c3s, axis=-1)[..., None]

    y = yw3 + dc1 * C1 + dc2 * C2 + d * C3
    y = y.reshape(x.shape[:-1] + (nb * block,))
    return y[..., :w] if pad else y


def iir_lowpass_blocked(x: jax.Array, alpha, y0, block: int = BLOCK) -> jax.Array:
    """Blocked-matmul one-pole lowpass along the last axis.

    x: [..., W]; y0: scalar or [...] carry-in (the filter's reset value).
    Bit-compatible with the sequential recurrence to ~f32 rounding.
    """
    x = jnp.asarray(x)
    dtype = x.dtype
    w = x.shape[-1]
    nb = -(-w // block)
    pad = nb * block - w

    T_np, d_np, pk = _decay_consts(float(alpha), block, np.dtype(dtype).name)
    T = jnp.asarray(T_np)
    d = jnp.asarray(d_np)

    xb = x if pad == 0 else jnp.concatenate(
        [x, jnp.zeros(x.shape[:-1] + (pad,), dtype)], axis=-1)
    xb = xb.reshape(x.shape[:-1] + (nb, block))

    # Within-block response (no carry): yw[..., b, i] = sum_j T[i,j] x[b, j]
    yw = jnp.einsum("ij,...bj->...bi", T, xb,
                    preferred_element_type=dtype, precision=_HIGHEST)

    # Carry chain across blocks: c_b = yw[b, -1] + pk * c_{b-1}. Unroll when
    # the block count is small (keeps the graph tiny for scanline widths);
    # otherwise run it as an associative scan over the block axis so long
    # axes (noise walks over L*W, audio streams) don't explode compile time.
    y0 = jnp.broadcast_to(jnp.asarray(y0, dtype), x.shape[:-1])
    last = yw[..., -1]
    if nb <= 16:
        carries = [y0]
        for b in range(nb - 1):
            carries.append(last[..., b] + pk * carries[-1])
        c = jnp.stack(carries, axis=-1)      # [..., nb] carry-in per block
    else:
        def comb(lhs, rhs):
            a_l, b_l = lhs
            a_r, b_r = rhs
            return a_r * a_l, a_r * b_l + b_r
        aa = jnp.full(last.shape, pk, dtype)
        _, post = jax.lax.associative_scan(comb, (aa, last), axis=-1)
        # post[b] = carry *after* block b with zero init; carry-in for block b
        # is post[b-1] plus the y0 term pk^b * y0.
        powers = jnp.asarray(
            np.power(np.float64(pk), np.arange(nb)).astype(np.dtype(dtype).name))
        prev = jnp.concatenate(
            [jnp.zeros_like(post[..., :1]), post[..., :-1]], axis=-1)
        c = prev + powers * y0[..., None]

    y = yw + d * c[..., None]
    y = y.reshape(x.shape[:-1] + (nb * block,))
    return y[..., :w] if pad else y
