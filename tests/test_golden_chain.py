"""Whole staged float32 chains vs the scalar float64 oracle
(golden/ref_scalar.composite_layer_scalar / composite_video_process_scalar),
noise off, at the SD (720) and 1080i (1888) line widths.

Tolerance is the engines' own (test_yiq_engine.assert_near_exact): at most
1 LSB on at most 0.5% of samples. float32 against float64 differs only at
exact truncation boundaries; a matmul that dropped to TF32 or bf16 precision
moves far more samples than that.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import golden.ref_scalar as ref
from cvsim_tpu.config import CompositeConfig, VHSSpeed
from cvsim_tpu.models import yiq, yuv422

LINES = 16
MAX_LSB, MAX_FRAC = 1, 0.005

GEN2_CONFIGS = {
    "bare": CompositeConfig(
        video_noise=0, composite_in_chroma_lowpass=False,
        composite_out_chroma_lowpass=False,
        composite_out_chroma_lowpass_lite=False),
    "defaults-noise-off": CompositeConfig(video_noise=0),
    "full-lowpass-out": CompositeConfig(
        video_noise=0, composite_out_chroma_lowpass_lite=False),
    "preemph": CompositeConfig(
        video_noise=0, composite_preemphasis=7.0,
        composite_preemphasis_cut=315000000 / 88,
        subcarrier_amplitude_back=50 + int(50 * 7 * (315000000 / 88)
                                           / (2 * (315000000 / 88)))),
    "vhs-sp": CompositeConfig(video_noise=0, emulating_vhs=True),
    "yc-recomb": CompositeConfig(video_noise=0, video_yc_recombine=2),
    "svideo": CompositeConfig(video_noise=0, emulating_vhs=True,
                              vhs_svideo_out=True),
}

GEN1_CONFIGS = {
    "defaults-noise-off": CompositeConfig(video_noise=0),
    "vhs-sp": CompositeConfig(video_noise=0, emulating_vhs=True),
    "pal": CompositeConfig(video_noise=0, ntsc=False),
    "out-full-recomb": CompositeConfig(
        video_noise=0, composite_out_chroma_lowpass=True,
        composite_out_chroma_lowpass_lite=False, video_yc_recombine=2),
    "preemph-catv": CompositeConfig(
        video_noise=0, composite_preemphasis=1.5,
        composite_preemphasis_cut=315000000 / 88 / 2,
        subcarrier_amplitude_back=68),
    "svideo-novblend": CompositeConfig(
        video_noise=0, emulating_vhs=True, vhs_svideo_out=True,
        vhs_chroma_vert_blend=False),
}

# The reference's own switch point sits near the bottom of a field, so the
# head-switching case needs a full-height (240-line) field.
EP_HEADSWITCH = CompositeConfig(
    video_noise=0, emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP,
    vhs_head_switching=True, vhs_head_switching_phase_noise=0.0)

FIELDNO = jnp.array([4, 5], jnp.int32)
PARITY = jnp.array([0, 1], jnp.int32)


def assert_within(got, want, name):
    d = np.abs(np.asarray(got).astype(np.int64) - want)
    assert d.max() <= MAX_LSB, f"{name}: max diff {d.max()}"
    assert (d > 0).mean() <= MAX_FRAC, f"{name}: {(d > 0).mean():.4%} differ"


def check_gen2(cfg, lines, w, seed):
    rgb = np.random.default_rng(seed).integers(0, 256, (2, lines, w, 3))
    got = yiq.composite_layer_rgb(jnp.asarray(rgb, jnp.int32), FIELDNO,
                                  PARITY, jax.random.PRNGKey(0), cfg=cfg)
    want = np.stack([ref.composite_layer_scalar(rgb[k], cfg, 4 + k, k)
                     for k in range(2)])
    assert_within(got, want, "rgb")


def check_gen1(cfg, lines, w, seed):
    rng = np.random.default_rng(seed)
    planes = (rng.integers(16, 236, (2, lines, w)),
              rng.integers(16, 241, (2, lines, w // 2)),
              rng.integers(16, 241, (2, lines, w // 2)))
    got = yuv422.composite_video_process_jit(
        *(jnp.asarray(p, jnp.int32) for p in planes), FIELDNO, PARITY,
        jax.random.PRNGKey(0), cfg=cfg)
    want = [ref.composite_video_process_scalar(
        planes[0][k], planes[1][k], planes[2][k], cfg, 4 + k, k)
        for k in range(2)]
    for i, name in enumerate("yuv"):
        assert_within(got[i], np.stack([wt[i] for wt in want]), name)


@pytest.mark.parametrize("width", [720, 1888])
@pytest.mark.parametrize("name", sorted(GEN2_CONFIGS))
def test_gen2_chain_matches_scalar(name, width):
    check_gen2(GEN2_CONFIGS[name], LINES, width, width)


@pytest.mark.parametrize("width", [720, 1888])
@pytest.mark.parametrize("name", sorted(GEN1_CONFIGS))
def test_gen1_chain_matches_scalar(name, width):
    check_gen1(GEN1_CONFIGS[name], LINES, width, width + 1)


@pytest.mark.parametrize("engine", ["gen1", "gen2"])
def test_ep_head_switching_full_field_matches_scalar(engine):
    check = check_gen1 if engine == "gen1" else check_gen2
    check(EP_HEADSWITCH, 240, 720, 7)


def test_scalar_chain_refuses_noise():
    rgb = np.zeros((2, 4, 3), np.int64)
    with pytest.raises(ValueError, match="noise off"):
        ref.composite_layer_scalar(rgb, CompositeConfig(), 0, 0)
    with pytest.raises(ValueError, match="noise off"):
        ref.composite_video_process_scalar(
            np.zeros((2, 4)), np.zeros((2, 2)), np.zeros((2, 2)),
            CompositeConfig(video_noise=0, vhs_head_switching=True), 0, 0)
