"""Every float32 matrix product on the main path asks for HIGHEST precision.

Without it an H100 computes an f32 dot in TF32 (about 10 mantissa bits),
and the chains fail the golden tolerance of tests/test_golden_chain.py
(0.5-15% of samples off by up to 3 LSB). This walks the jaxpr of
each jitted chain, sub-jaxprs included, and fails on any f32 dot_general
whose precision is not HIGHEST on both operands.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

from cvsim_tpu.config import AudioConfig, CompositeConfig, VHSSpeed

F32 = jnp.float32
EP = CompositeConfig(
    emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP, vhs_head_switching=True,
    video_noise=6, video_chroma_noise=22, video_chroma_phase_noise=6,
    video_chroma_loss=8)


def _subjaxprs(params):
    for v in params.values():
        for item in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(item, jcore.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jcore.Jaxpr):
                yield item


def f32_dots(jaxpr):
    """(count of f32 dot_generals, list of those without HIGHEST)."""
    n, bad = 0, []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
                v.aval.dtype == np.float32 for v in eqn.invars):
            n += 1
            prec = eqn.params.get("precision")
            prec = prec if isinstance(prec, tuple) else (prec, prec)
            if any(p != jax.lax.Precision.HIGHEST for p in prec):
                bad.append(f"{eqn.params.get('dimension_numbers')} "
                           f"precision={eqn.params.get('precision')}")
        for sub in _subjaxprs(eqn.params):
            sn, sbad = f32_dots(sub)
            n, bad = n + sn, bad + sbad
    return n, bad


def gen1(b=2, l=8, w=720):
    from cvsim_tpu.models import yuv422

    y = jnp.zeros((b, l, w), jnp.int32)
    u = jnp.zeros((b, l, w // 2), jnp.int32)
    fno = jnp.arange(b, dtype=jnp.int32)
    return (lambda y, u, v, f: yuv422.composite_video_process(
        y, u, v, cfg=EP, fieldno=f, field_parity=f & 1,
        key=jax.random.PRNGKey(0), dtype=F32)), (y, u, u, fno)


def gen2(b=2, l=8, w=720):
    from cvsim_tpu.models import yiq

    rgb = jnp.zeros((b, l, w, 3), jnp.uint8)
    fno = jnp.arange(b, dtype=jnp.int32)
    return (lambda r, f: yiq.composite_layer_rgb(
        r, f, f & 1, jax.random.PRNGKey(0), cfg=EP, dtype=F32)), (rgb, fno)


def vhs_audio():
    from cvsim_tpu.audio import (buzz_pulse_counts, composite_audio_process,
                                 init_audio_state)

    cfg = AudioConfig(vhs_hifi=False, vhs_linear_audio=True)
    n = 4096
    x = jnp.zeros((n, 2), jnp.int32)
    pulses = jnp.asarray(buzz_pulse_counts(cfg, 0, n))
    return (lambda x, p: composite_audio_process(
        x, init_audio_state(cfg, F32), jax.random.PRNGKey(0), cfg=cfg,
        pulses=p, dtype=F32)), (x, pulses)


def cassette():
    from cvsim_tpu.audio.cassette import (CassetteConfig,
                                          cassette_audio_process,
                                          init_cassette_state)

    cfg = CassetteConfig()
    x = jnp.zeros((4096, 2), jnp.int32)
    return (lambda x: cassette_audio_process(
        x, init_cassette_state(cfg, F32), jax.random.PRNGKey(0), cfg=cfg,
        dtype=F32)), (x,)


def raw28():
    from cvsim_tpu.models import raw28

    rl = raw28.RawTiming(raw28.rate_preset("ntsc28")).raw_length
    lines = jnp.zeros((16, rl + 24), jnp.int32)
    return (lambda x: raw28.decode_lines(
        x, 60.0, 200.0, raw_len=rl, width=720)), (lines,)


def iir(passes):
    from cvsim_tpu.ops.iir import iir_lowpass_cascade

    x = jnp.zeros((2, 8, 720), F32)
    return (lambda x: iir_lowpass_cascade(x, 0.3, 16.0, passes)), (x,)


CHAINS = {
    "gen1": gen1, "gen2": gen2, "vhs-audio": vhs_audio,
    "cassette": cassette, "raw28": raw28,
    "iir-1-pole": lambda: iir(1), "iir-3-pole": lambda: iir(3),
}
# chains whose float work includes matmuls (raw28 has none, which the
# walk must report as zero rather than miss)
HAS_F32_DOT = {"gen1", "gen2", "vhs-audio", "cassette", "iir-1-pole",
               "iir-3-pole"}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_f32_dots_are_highest(name):
    fn, args = CHAINS[name]()
    n, bad = f32_dots(jax.make_jaxpr(jax.jit(fn))(*args).jaxpr)
    assert not bad, f"{name}: {len(bad)} f32 dot(s) without HIGHEST: {bad}"
    assert (n > 0) == (name in HAS_F32_DOT), f"{name}: {n} f32 dots"


def test_walk_catches_default_precision():
    def fn(x):
        return jax.jit(lambda y: jax.lax.scan(
            lambda c, r: (c + r @ x, 0), jnp.zeros(4, F32), y)[0])(x)

    n, bad = f32_dots(jax.make_jaxpr(fn)(jnp.ones((4, 4), F32)).jaxpr)
    assert n == 1 and len(bad) == 1
