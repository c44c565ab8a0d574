"""Per-row dynamic rotation without gathers (barrel shifter).

A rotation by a per-row dynamic amount decomposes into log2(W) static rolls
+ selects (a barrel shifter): elementwise work that XLA fuses, in place of a
per-sample gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def roll_rows(a, shift, max_shift: int | None = None):
    """out[..., x] = a[..., (x + shift) mod W] with a per-row integer shift
    along the LAST axis (move other axes there first: the shift mask and
    selects broadcast against axis -1 only).

    a: [..., W]; shift: int array broadcastable to a.shape[:-1].
    max_shift bounds the (already mod-W-reduced) shift values, trimming the
    barrel-shifter passes: e.g. subcarrier phases need 2 passes, not log2(W).
    """
    w = a.shape[-1]
    s = jnp.mod(jnp.asarray(shift, jnp.int32), w)[..., None]
    bound = (w - 1) if max_shift is None else min(max_shift, w - 1)
    nbits = max(1, bound.bit_length())
    for b in range(nbits):
        bit = ((s >> b) & 1) == 1
        rolled = jnp.roll(a, -(1 << b), axis=-1)
        a = jnp.where(bit, rolled, a)
    return a


def select_by_phase(xi, table):
    """Row-phase lookup without a gather: table is a small static [4, W]
    array; returns table[xi] as [..., W] via a one-hot contraction. HIGHEST
    keeps a float table's rows exact (each output is one row plus exact
    zeros) where a GPU would otherwise round the products to TF32.

    xi: int array [...] with values in [0, 4).
    """
    table = jnp.asarray(table)
    onehot = (xi[..., None] == jnp.arange(4, dtype=jnp.int32))
    return jnp.einsum("...k,kw->...w", onehot.astype(table.dtype), table,
                      precision=jax.lax.Precision.HIGHEST)
