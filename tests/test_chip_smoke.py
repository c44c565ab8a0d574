"""chip_smoke.py pieces that run without a GPU: arguments, phase choice,
the tolerance helper, and the refusal to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_GPU_PHASES = ["device", "golden", "sd", "hd", "cli-gen1", "cli-gen2",
                  "daemon", "audio", "raw28"]


def test_default_runs_every_one_gpu_phase():
    args = chip_smoke.parse_args([])
    assert not args.four
    assert chip_smoke.phase_names(args) == ONE_GPU_PHASES


def test_four_selects_only_its_phase():
    args = chip_smoke.parse_args(["--four"])
    assert args.four
    assert chip_smoke.phase_names(args) == ["device", "four"]


def test_every_phase_has_a_method():
    for name in ONE_GPU_PHASES + ["four"]:
        assert callable(getattr(chip_smoke.Smoke, name.replace("-", "_")))


def test_unknown_argument_exits_nonzero():
    with pytest.raises(SystemExit) as e:
        chip_smoke.parse_args(["--eight"])
    assert e.value.code != 0


@pytest.mark.parametrize("delta, ok", [(0, True), (1, True), (2, False)])
def test_check_within_max_lsb(delta, ok):
    want = np.full((4, 100), 100)
    got = want.copy()
    got[0, 0] += delta
    if ok:
        mx, frac = chip_smoke.check_within("x", got, want, 1)
        assert mx == delta
        assert frac == pytest.approx(1 / 400 if delta else 0.0)
    else:
        with pytest.raises(chip_smoke.SmokeFailure, match="max diff 2"):
            chip_smoke.check_within("x", got, want, 1)


def test_check_within_share_and_shape():
    want = np.zeros(1000, np.uint8)
    got = want.copy()
    got[:6] = 1                       # 0.6% differ by 1 LSB
    with pytest.raises(chip_smoke.SmokeFailure, match="0.6000%"):
        chip_smoke.check_within("x", got, want, 1, 0.005)
    assert chip_smoke.check_within("x", got[:500], want[:500], 1, 0.02)
    with pytest.raises(chip_smoke.SmokeFailure, match="shape"):
        chip_smoke.diff_stats(got[:10], want[:11])


def test_refuses_cpu_backend_in_process():
    with pytest.raises(chip_smoke.SmokeFailure, match="needs gpu"):
        chip_smoke.main([])


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu_backend_nonzero_exit_no_result():
    r = _run(REPO, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs gpu" in r.stderr


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
