"""The native build rule (cvsim_tpu.native.ensure_built): rebuild exactly
when the sources, flags or host target change, whatever the file times."""

import os
import shutil
import subprocess

import pytest

from cvsim_tpu import native

SRC = '#include <cstdio>\nint main() { std::puts("%s"); return 0; }\n'


@pytest.fixture
def prog(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    src = tmp_path / "p.cpp"
    src.write_text(SRC % "one")
    return str(src), str(tmp_path / "p")


def run(exe):
    return subprocess.run([exe], capture_output=True, text=True,
                          check=True).stdout.strip()


def test_source_change_under_same_mtime_rebuilds(prog):
    src, exe = prog
    native.ensure_built(exe, [src], ["-O0"])
    assert run(exe) == "one"
    st = os.stat(src)
    with open(src, "w") as f:
        f.write(SRC % "two")
    os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns))
    os.utime(exe, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    native.ensure_built(exe, [src], ["-O0"])
    assert run(exe) == "two"


def test_unchanged_build_is_reused(prog, monkeypatch):
    src, exe = prog
    native.ensure_built(exe, [src], ["-O0"])

    def no_compiler(*a, **k):
        raise AssertionError("rebuilt an up-to-date binary")

    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert native.ensure_built(exe, [src], ["-O0"]) == exe


@pytest.mark.parametrize("change", ["flags", "native"])
def test_flags_and_target_are_part_of_the_key(prog, change):
    src, _ = prog
    base = native.build_key([src], ["-O0"])
    if change == "flags":
        assert native.build_key([src], ["-O2"]) != base
    else:
        assert native.build_key([src], ["-O0"], native=True) != base


def test_failed_build_leaves_no_key(prog):
    src, exe = prog
    with open(src, "w") as f:
        f.write("this is not C++\n")
    with pytest.raises(subprocess.CalledProcessError):
        native.ensure_built(exe, [src], ["-O0"])
    assert not os.path.exists(exe + ".key")
    assert not [p for p in os.listdir(os.path.dirname(exe)) if ".tmp." in p]
