"""Subcarrier scanline phase (xi) tables.

The reference computes, per scanline, a phase index xi in {0,1,2,3} selecting
where the 4-sample QAM multiplier pattern starts
(ffmpeg_to_composite.cpp:446-459, ffmpeg_ntsc.cpp:1473-1480). It is a pure
function of (fieldno, frame_row, comp_phase, comp_phase_offset), so we
precompute it as a [batch, lines] int32 array and vectorize the QAM stages.
"""

from __future__ import annotations

import jax.numpy as jnp


def scanline_phase_xi(
    fieldno,                 # int32 [B] running 59.94Hz field counter
    field_parity,            # int32 [B] 0=top,1=bottom (frame row offset)
    num_lines: int,          # L = lines in this field
    phase_shift: int,        # -comp-phase: 0|90|180|270
    phase_offset: int,       # -comp-phase-offset
    ntsc: bool,
    gen1: bool = False,      # gen-1 'else' branch gives xi=0; gen-2 gives offset&3
):
    """Return int32 [B, L] xi table. Frame row y = field_parity + 2*l."""
    fieldno = jnp.asarray(fieldno, jnp.int32)[:, None]
    parity = jnp.asarray(field_parity, jnp.int32)[:, None]
    l = jnp.arange(num_lines, dtype=jnp.int32)[None, :]
    y = parity + 2 * l

    if not ntsc and gen1:
        # gen-1 PAL branch (ffmpeg_to_composite.cpp:456-459)
        return (fieldno + y) & 3

    if phase_shift == 90:
        xi = (fieldno + phase_offset + (y >> 1)) & 3
    elif phase_shift == 180:
        xi = (((fieldno + y) & 2) + phase_offset) & 3
    elif phase_shift == 270:
        xi = (fieldno + phase_offset - (y >> 1)) & 3
    else:
        xi = jnp.broadcast_to(
            jnp.int32(0 if gen1 else (phase_offset & 3)), y.shape
        ) & 3
    return xi.astype(jnp.int32)
