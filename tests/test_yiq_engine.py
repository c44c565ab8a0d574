"""Golden tests: gen-2 YIQ engine vs the scalar reference port.

Filter stages may differ by 1 LSB on a tiny fraction of samples (parallel
scan reassociation at truncation boundaries); integer stages must be exact.
"""

import numpy as np
import jax
import jax.numpy as jnp

import golden.ref_scalar as ref
from cvsim_tpu.config import CompositeConfig, VHSSpeed
from cvsim_tpu.models import yiq

L, W = 6, 64


def rand_yiq(seed=0, l=L, w=W):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, size=(l, w, 3))
    y = np.zeros((l, w), np.int64)
    i = np.zeros((l, w), np.int64)
    q = np.zeros((l, w), np.int64)
    for li in range(l):
        for x in range(w):
            y[li, x], i[li, x], q[li, x] = ref.rgb_to_yiq(*rgb[li, x].tolist())
    return rgb, y, i, q


def to_dev(a):
    return jnp.asarray(a, jnp.int32)[None]  # add batch dim


def assert_near_exact(got, want, frac=0.005, name=""):
    got = np.asarray(got)[0].astype(np.int64)
    diff = np.abs(got - want)
    assert diff.max() <= 1, f"{name}: max diff {diff.max()}"
    assert (diff != 0).mean() <= frac, f"{name}: {(diff != 0).mean()} mismatch frac"


def test_rgb_yiq_roundtrip_matches_golden():
    # XLA may contract a*b+c into FMA, so 256*dY can land on the other side of
    # a truncation boundary vs C's strict left-to-right double math; allow
    # 1 LSB of the x256-scaled YIQ (1/256 of a luma level).
    rgb, y, i, q = rand_yiq(0)
    gy, gi, gq = yiq.rgb_to_yiq(
        jnp.asarray(rgb[..., 0]), jnp.asarray(rgb[..., 1]), jnp.asarray(rgb[..., 2]),
        dtype=jnp.float64)
    assert np.abs(np.asarray(gy).astype(np.int64) - y).max() <= 1
    assert np.abs(np.asarray(gi).astype(np.int64) - i).max() <= 1
    assert np.abs(np.asarray(gq).astype(np.int64) - q).max() <= 1

    rr, gg, bb = yiq.yiq_to_rgb(jnp.asarray(y), jnp.asarray(i), jnp.asarray(q),
                                dtype=jnp.float64)
    want = np.zeros((L, W, 3), np.int64)
    for li in range(L):
        for x in range(W):
            want[li, x] = ref.yiq_to_rgb(int(y[li, x]), int(i[li, x]), int(q[li, x]))
    assert np.abs(np.asarray(rr).astype(np.int64) - want[..., 0]).max() <= 1
    assert np.abs(np.asarray(gg).astype(np.int64) - want[..., 1]).max() <= 1
    assert np.abs(np.asarray(bb).astype(np.int64) - want[..., 2]).max() <= 1


def test_composite_lowpass():
    _, y, i, q = rand_yiq(1)
    gi, gq = yiq.composite_lowpass(to_dev(i), to_dev(q), dtype=jnp.float64)
    wi, wq = ref.composite_lowpass_yiq(i.copy(), q.copy())
    assert_near_exact(gi, wi, name="I")
    assert_near_exact(gq, wq, name="Q")


def test_composite_lowpass_tv():
    _, y, i, q = rand_yiq(2)
    gi, gq = yiq.composite_lowpass_tv(to_dev(i), to_dev(q), dtype=jnp.float64)
    wi, wq = ref.composite_lowpass_yiq(i.copy(), q.copy(), lite=True)
    assert_near_exact(gi, wi, name="I")
    assert_near_exact(gq, wq, name="Q")


def test_chroma_into_luma_exact():
    for fieldno, parity, shift, off in [(0, 0, 180, 0), (3, 1, 90, 1), (7, 0, 270, 2), (2, 1, 0, 0)]:
        _, y, i, q = rand_yiq(3 + fieldno)
        xi = yiq.scanline_phase_xi(
            jnp.array([fieldno]), jnp.array([parity]), L, shift, off, True)
        gy, gi, gq = yiq.chroma_into_luma(to_dev(y), to_dev(i), to_dev(q), xi, 50)
        wy, wi, wq = ref.chroma_into_luma_yiq(
            y.copy(), i.copy(), q.copy(), fieldno, parity, 50, shift, off)
        np.testing.assert_array_equal(np.asarray(gy)[0], wy)
        np.testing.assert_array_equal(np.asarray(gi)[0], wi)
        np.testing.assert_array_equal(np.asarray(gq)[0], wq)


def test_chroma_from_luma_exact():
    for fieldno, parity, shift in [(0, 0, 180), (1, 1, 180), (5, 0, 90), (6, 1, 270)]:
        _, y, i, q = rand_yiq(10 + fieldno)
        xi = yiq.scanline_phase_xi(
            jnp.array([fieldno]), jnp.array([parity]), L, shift, 0, True)
        # encode first so the luma actually carries a subcarrier
        y2, i2, q2 = ref.chroma_into_luma_yiq(
            y.copy(), i.copy(), q.copy(), fieldno, parity, 50, shift, 0)
        gy, gi, gq = yiq.chroma_from_luma(
            to_dev(y2), to_dev(i2), to_dev(q2), xi, 50)
        wy, wi, wq = ref.chroma_from_luma_yiq(
            y2.copy(), i2.copy(), q2.copy(), fieldno, parity, 50, shift, 0)
        np.testing.assert_array_equal(np.asarray(gy)[0], wy)
        np.testing.assert_array_equal(np.asarray(gi)[0], wi)
        np.testing.assert_array_equal(np.asarray(gq)[0], wq)


def test_preemphasis():
    _, y, _, _ = rand_yiq(20)
    got = yiq.composite_preemphasis_stage(to_dev(y), 1.5, 1000000.0, jnp.float64)
    want = ref.preemphasis_yiq(y.copy(), 1.5, 1000000.0)
    assert_near_exact(got, want, name="preemph")


def test_vhs_stages():
    _, y, i, q = rand_yiq(21)
    sp = VHSSpeed.SP
    got = yiq.vhs_luma_lowpass(to_dev(y), sp.luma_cut, jnp.float64)
    want = ref.vhs_luma_lowpass_yiq(y.copy(), sp.luma_cut)
    assert_near_exact(got, want, name="vhs luma")

    gi, gq = yiq.vhs_chroma_lowpass(to_dev(i), to_dev(q), sp.chroma_cut,
                                    sp.chroma_delay_gen2, jnp.float64)
    wi, wq = ref.vhs_chroma_lowpass_yiq(i.copy(), q.copy(), sp.chroma_cut,
                                        sp.chroma_delay_gen2)
    assert_near_exact(gi, wi, name="vhs chroma I")
    assert_near_exact(gq, wq, name="vhs chroma Q")

    gi, gq = yiq.vhs_chroma_vert_blend(to_dev(i), to_dev(q))
    wi, wq = ref.vhs_chroma_vert_blend_yiq(i.copy(), q.copy())
    np.testing.assert_array_equal(np.asarray(gi)[0], wi)
    np.testing.assert_array_equal(np.asarray(gq)[0], wq)

    got = yiq.vhs_sharpen(to_dev(y), sp.luma_cut, 1.5, dtype=jnp.float64)
    want = ref.vhs_sharpen_yiq(y.copy(), sp.luma_cut, 1.5)
    assert_near_exact(got, want, name="vhs sharpen")


def test_head_switching_deterministic():
    _, y, _, _ = rand_yiq(22)
    cfg = CompositeConfig()
    got = yiq.head_switching_stage(
        to_dev(y), jnp.array([0], jnp.int32), jax.random.PRNGKey(0),
        point=cfg.vhs_head_switching_point, phase=cfg.vhs_head_switching_phase,
        phase_noise=0.0, ntsc=True, fill=0, dtype=jnp.float64)
    want = ref.head_switching(
        y.copy(), 0, cfg.vhs_head_switching_point, cfg.vhs_head_switching_phase,
        0.0, ntsc=True, fill=0)
    np.testing.assert_array_equal(np.asarray(got)[0], want)


def test_head_switching_negative_phase_c_cast():
    """Negative phase/point exercise the C (unsigned int) cast semantics:
    fmod is sign-preserving and the cast wraps mod 2^32 (the switch line
    lands far below the raster for negative point; x at the wrapped
    residue for negative phase). Oracle pinned to the compiled reference
    in tests/test_ref_crosscheck.py."""
    for point, phase in ((0.15, -0.005), (-0.01, 0.17)):
        _, y, _, _ = rand_yiq(29, l=32, w=64)
        got = yiq.head_switching_stage(
            to_dev(y), jnp.array([0], jnp.int32), jax.random.PRNGKey(0),
            point=point, phase=phase, phase_noise=0.0, ntsc=True, fill=0,
            dtype=jnp.float64)
        want = ref.head_switching(y.copy(), 0, point, phase, 0.0,
                                  ntsc=True, fill=0)
        np.testing.assert_array_equal(np.asarray(got)[0], want)


def test_head_switching_pal_raster():
    """PAL head switching: 312.5-line virtual raster and the (312-288)*2
    row offset (ffmpeg_to_composite.cpp:682-691) — bar must be on-raster
    AND match the oracle (which is pinned to the compiled reference in
    tests/test_ref_crosscheck.py::pal_head_switching)."""
    _, y, _, _ = rand_yiq(31, l=32, w=64)
    point = 0.12   # 312.5*0.12 -> switch row 26 of this 64-line frame
    got = yiq.head_switching_stage(
        to_dev(y), jnp.array([0], jnp.int32), jax.random.PRNGKey(0),
        point=point, phase=point, phase_noise=0.0, ntsc=False, fill=16,
        dtype=jnp.float64)
    want = ref.head_switching(y.copy(), 0, point, point, 0.0,
                              ntsc=False, fill=16)
    np.testing.assert_array_equal(np.asarray(got)[0], want)
    assert not np.array_equal(np.asarray(got)[0], rand_yiq(31, l=32, w=64)[1])


def test_head_switching_visible_bar():
    # Put the switch point inside the visible area so rotation actually
    # happens: for a 32-line field the visible rows cover raster lines
    # [22, 54) after the (262-240)*2 offset, i.e. point ~ 0.084..0.206.
    _, y, _, _ = rand_yiq(23, l=32, w=64)
    point = 0.15
    got = yiq.head_switching_stage(
        to_dev(y), jnp.array([0], jnp.int32), jax.random.PRNGKey(0),
        point=point, phase=point, phase_noise=0.0, ntsc=True, fill=0,
        dtype=jnp.float64)
    want = ref.head_switching(y.copy(), 0, point, point, 0.0, ntsc=True, fill=0)
    np.testing.assert_array_equal(np.asarray(got)[0], want)
    assert not np.array_equal(np.asarray(got)[0], rand_yiq(23, l=32, w=64)[1])


def test_full_chain_noise_off_matches_golden():
    cfg = CompositeConfig(
        video_noise=0, video_chroma_noise=0, video_chroma_phase_noise=0,
        video_chroma_loss=0, vhs_head_switching=False, emulating_vhs=True,
        vhs_tape_speed=VHSSpeed.SP)
    _, y, i, q = rand_yiq(30)
    fieldno, parity = 4, 0
    gy, gi, gq = yiq.composite_layer(
        to_dev(y), to_dev(i), to_dev(q), cfg=cfg,
        fieldno=jnp.array([fieldno], jnp.int32),
        field_parity=jnp.array([parity], jnp.int32),
        key=jax.random.PRNGKey(0), dtype=jnp.float64)

    wy, wi, wq = y.copy(), i.copy(), q.copy()
    wi, wq = ref.composite_lowpass_yiq(wi, wq)
    wy, wi, wq = ref.chroma_into_luma_yiq(wy, wi, wq, fieldno, parity, 50)
    wy, wi, wq = ref.chroma_from_luma_yiq(wy, wi, wq, fieldno, parity, 50)
    sp = VHSSpeed.SP
    wy = ref.vhs_luma_lowpass_yiq(wy, sp.luma_cut)
    wi, wq = ref.vhs_chroma_lowpass_yiq(wi, wq, sp.chroma_cut, sp.chroma_delay_gen2)
    wi, wq = ref.vhs_chroma_vert_blend_yiq(wi, wq)
    wy = ref.vhs_sharpen_yiq(wy, sp.luma_cut, cfg.vhs_out_sharpen)
    wy, wi, wq = ref.chroma_into_luma_yiq(wy, wi, wq, fieldno, parity, 50)
    wy, wi, wq = ref.chroma_from_luma_yiq(wy, wi, wq, fieldno, parity, 50)
    wi, wq = ref.composite_lowpass_yiq(wi, wq, lite=True)

    assert_near_exact(gy, wy, frac=0.01, name="Y")
    assert_near_exact(gi, wi, frac=0.01, name="I")
    assert_near_exact(gq, wq, frac=0.01, name="Q")


def test_batched_fields_independent():
    """Batch processing must equal per-field processing."""
    cfg = CompositeConfig(video_noise=0)
    _, y0, i0, q0 = rand_yiq(40)
    _, y1, i1, q1 = rand_yiq(41)
    yb = jnp.asarray(np.stack([y0, y1]), jnp.int32)
    ib = jnp.asarray(np.stack([i0, i1]), jnp.int32)
    qb = jnp.asarray(np.stack([q0, q1]), jnp.int32)
    fn = jnp.array([0, 1], jnp.int32)
    fp = jnp.array([0, 1], jnp.int32)
    key = jax.random.PRNGKey(0)
    by, bi, bq = yiq.composite_layer(
        yb, ib, qb, cfg=cfg, fieldno=fn, field_parity=fp, key=key,
        dtype=jnp.float64)
    for k in range(2):
        sy, si, sq = yiq.composite_layer(
            yb[k:k+1], ib[k:k+1], qb[k:k+1], cfg=cfg,
            fieldno=fn[k:k+1], field_parity=fp[k:k+1], key=key,
            dtype=jnp.float64)
        np.testing.assert_array_equal(np.asarray(by)[k], np.asarray(sy)[0])
        np.testing.assert_array_equal(np.asarray(bi)[k], np.asarray(si)[0])
        np.testing.assert_array_equal(np.asarray(bq)[k], np.asarray(sq)[0])


def test_full_chain_wide_field_multi_block():
    """W=256 exercises multiple 128-sample IIR blocks and cross-block carry
    in every filter stage (the small-W tests cover only one block)."""
    cfg = CompositeConfig(
        video_noise=0, video_chroma_noise=0, video_chroma_phase_noise=0,
        video_chroma_loss=0, vhs_head_switching=False, emulating_vhs=True,
        vhs_tape_speed=VHSSpeed.EP)
    _, y, i, q = rand_yiq(99, l=4, w=256)
    fieldno, parity = 1, 1
    gy, gi, gq = yiq.composite_layer(
        to_dev(y), to_dev(i), to_dev(q), cfg=cfg,
        fieldno=jnp.array([fieldno], jnp.int32),
        field_parity=jnp.array([parity], jnp.int32),
        key=jax.random.PRNGKey(0), dtype=jnp.float64)

    wy, wi, wq = y.copy(), i.copy(), q.copy()
    wi, wq = ref.composite_lowpass_yiq(wi, wq)
    wy, wi, wq = ref.chroma_into_luma_yiq(wy, wi, wq, fieldno, parity, 50)
    wy, wi, wq = ref.chroma_from_luma_yiq(wy, wi, wq, fieldno, parity, 50)
    sp = VHSSpeed.EP
    wy = ref.vhs_luma_lowpass_yiq(wy, sp.luma_cut)
    wi, wq = ref.vhs_chroma_lowpass_yiq(wi, wq, sp.chroma_cut, sp.chroma_delay_gen2)
    wi, wq = ref.vhs_chroma_vert_blend_yiq(wi, wq)
    wy = ref.vhs_sharpen_yiq(wy, sp.luma_cut, cfg.vhs_out_sharpen)
    wy, wi, wq = ref.chroma_into_luma_yiq(wy, wi, wq, fieldno, parity, 50)
    wy, wi, wq = ref.chroma_from_luma_yiq(wy, wi, wq, fieldno, parity, 50)
    wi, wq = ref.composite_lowpass_yiq(wi, wq, lite=True)

    assert_near_exact(gy, wy, frac=0.01, name="Y")
    assert_near_exact(gi, wi, frac=0.01, name="I")
    assert_near_exact(gq, wq, frac=0.01, name="Q")
