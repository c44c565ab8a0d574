"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cvsim_tpu.config import CompositeConfig, VHSSpeed
from cvsim_tpu.models import yiq
from cvsim_tpu.parallel.mesh import (
    make_mesh,
    run_field_sharded_chain,
    run_sharded_chain,
    _factor_2d,
)


def test_factor_2d():
    assert _factor_2d(8) == (4, 2)
    assert _factor_2d(4) == (2, 2)
    assert _factor_2d(1) == (1, 1)
    assert _factor_2d(6) == (3, 2)


def test_sharded_chain_matches_single_device():
    cfg = CompositeConfig(
        emulating_vhs=True, vhs_tape_speed=VHSSpeed.SP,
        video_noise=0, video_chroma_noise=0, video_chroma_phase_noise=0,
        video_chroma_loss=0, vhs_head_switching=True,
        vhs_head_switching_phase_noise=0.0)
    rng = np.random.default_rng(0)
    b, l, w = 8, 32, 128
    rgb = rng.integers(0, 256, size=(b, l, w, 3)).astype(np.int32)
    fieldno = np.arange(b, dtype=np.int32)
    parity = (np.arange(b) & 1).astype(np.int32)
    key = jax.random.PRNGKey(3)

    mesh = make_mesh(8)
    sharded = np.asarray(run_sharded_chain(mesh, cfg, rgb, fieldno, parity, key))

    single = np.asarray(yiq.composite_layer_rgb(
        jnp.asarray(rgb), jnp.asarray(fieldno), jnp.asarray(parity), key,
        cfg=cfg))
    np.testing.assert_array_equal(sharded, single)


def test_field_sharded_chain_matches_single_device():
    """The shard_map layout the CLI's -devices uses (fields over every
    device, the whole chain per shard): must equal the single-device batch
    bit-for-bit, including content-addressed noise."""
    cfg = CompositeConfig(
        emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP,
        video_noise=6, video_chroma_noise=22, video_chroma_phase_noise=6,
        video_chroma_loss=8, vhs_head_switching=True)
    rng = np.random.default_rng(1)
    b, l, w = 16, 16, 128
    rgb = rng.integers(0, 256, size=(b, l, w, 3)).astype(np.int32)
    fieldno = np.arange(b, dtype=np.int32)
    parity = (np.arange(b) & 1).astype(np.int32)
    key = jax.random.PRNGKey(9)

    mesh = make_mesh(8)
    sharded = np.asarray(
        run_field_sharded_chain(mesh, cfg, rgb, fieldno, parity, key))
    single = np.asarray(yiq.composite_layer_rgb(
        jnp.asarray(rgb), jnp.asarray(fieldno), jnp.asarray(parity), key,
        cfg=cfg))
    np.testing.assert_array_equal(sharded, single)

    import pytest
    with pytest.raises(ValueError, match="must divide"):
        run_field_sharded_chain(mesh, cfg, rgb[:6], fieldno[:6], parity[:6],
                                key)


def test_make_mesh_fails_loud_on_too_few_devices():
    import pytest

    with pytest.raises(ValueError, match="only 8 device"):
        make_mesh(16)
    assert make_mesh(8).devices.size == 8
    assert make_mesh(4).devices.size == 4


def test_graft_entry():
    import os
    import sys
    sys.path.insert(0,
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == args[0].shape
    # in-process worker on the virtual CPU mesh (what the subprocess runs)
    ge._dryrun_multichip_inproc(8)
    ge._dryrun_multichip_inproc(4)


def test_graft_entry_dryrun_subprocess():
    """The multi-device dry-run entry point: must succeed from an arbitrary
    parent process without touching an accelerator."""
    import os
    import sys
    sys.path.insert(0,
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@pytest.mark.parametrize("ndev", [4, 8])
@pytest.mark.parametrize("tool, extra", [
    # -bkey-feedback: the gen-1 black-key scan carries sequential per-field
    # state through the plain-jit prolog while the chain itself is
    # mesh-sharded — the seam must still be exact
    ("to-composite", ["-bkey-feedback", "20"]),
    ("ntsc", []),
])
def test_devices_flag_pipelines_bit_identical(tmp_path, tool, extra, ndev):
    """-devices n (CLI multi-device flag): both engine pipelines shard the
    field batch over the mesh via shard_map inside their GOP program;
    output must be byte-identical to the single-device run."""
    from test_cli import make_clip
    from cvsim_tpu.cli.main import main

    src = make_clip(str(tmp_path / "in.y4m"))
    a = str(tmp_path / f"{tool}-1.y4m")
    b = str(tmp_path / f"{tool}-{ndev}.y4m")
    args = ([tool, "-i", src, "-width", "128", "-vhs", "-seed", "7"]
            + extra)
    assert main(args + ["-o", a]) == 0
    assert main(args + ["-o", b, "-devices", str(ndev)]) == 0
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), tool


@pytest.mark.parametrize("dp", [1, 2])
def test_one_frame_lines_over_four_devices(dp):
    """One interlaced frame's two fields over four devices with the line
    axis sharded (dp=1: 4-way over lines; dp=2: fields x 2-way lines), the
    route for one HD frame across cards: equal to the single-device chain,
    including head switching and the vertical chroma blend across shard
    boundaries."""
    cfg = CompositeConfig(
        emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP,
        video_noise=6, video_chroma_noise=22, video_chroma_phase_noise=6,
        video_chroma_loss=8, vhs_head_switching=True,
        vhs_head_switching_point=0.2)
    rng = np.random.default_rng(4)
    b, l, w = 2, 64, 128
    rgb = rng.integers(0, 256, size=(b, l, w, 3)).astype(np.int32)
    fieldno = np.arange(b, dtype=np.int32)
    parity = (np.arange(b) & 1).astype(np.int32)
    key = jax.random.PRNGKey(11)

    mesh = make_mesh(4, dp=dp)
    assert mesh.shape["sp"] == 4 // dp
    sharded = np.asarray(run_sharded_chain(mesh, cfg, rgb, fieldno, parity,
                                           key))
    single = np.asarray(yiq.composite_layer_rgb(
        jnp.asarray(rgb), jnp.asarray(fieldno), jnp.asarray(parity), key,
        cfg=cfg))
    np.testing.assert_array_equal(sharded, single)


def test_devices_flag_must_divide_gop():
    import pytest

    from cvsim_tpu.host.pipeline import CompositePipeline
    from cvsim_tpu.presets import FlagState

    st = FlagState()
    cfg = st.to_run_config(gen1=True)
    with pytest.raises(ValueError, match="must divide"):
        CompositePipeline(cfg, gop=64, mesh=make_mesh(6))
