"""Process-wide compiled-program cache (host/progcache.py).

A resident `cvsim serve` daemon constructs a fresh pipeline object per
command; without the process-wide cache every warm command would re-pay
the full AOT compile of its batch program. These tests pin the
contract: identical (config, geometry) share ONE compiled program across
pipeline instances; any config or geometry difference gets its own.
"""

from cvsim_tpu.host import progcache
from cvsim_tpu.host.pipeline import CompositePipeline
from cvsim_tpu.host.pipeline_yiq import YIQPipeline
from cvsim_tpu.presets import parse_composite_flags


def _cfg(extra=(), gen2=False):
    st = parse_composite_flags(["-width", "128", *extra], gen2=gen2)
    return st.to_run_config(gen1=not gen2)


GEO = (96, 128, 48, 64, True, False)


def test_gen1_program_shared_across_pipeline_instances():
    cfg = _cfg()
    p1 = CompositePipeline(cfg, gop=8, progress=False)
    p2 = CompositePipeline(cfg, gop=8, progress=False)
    a = p1._build_gop_program(*GEO)
    assert p2._build_gop_program(*GEO) is a

    # per-instance first level still hits
    assert p1._build_gop_program(*GEO) is a

    # a different geometry or config must NOT share
    assert p1._build_gop_program(96, 128, 48, 64, False, False) is not a
    p3 = CompositePipeline(_cfg(["-noise", "42"]), gop=8, progress=False)
    assert p3._build_gop_program(*GEO) is not a


def test_gen2_program_shared_across_pipeline_instances():
    cfg = _cfg(gen2=True)
    p1 = YIQPipeline(cfg, gop=4, progress=False)
    p2 = YIQPipeline(cfg, gop=4, progress=False)
    assert p1._process_batch is p2._process_batch
    p3 = YIQPipeline(cfg, gop=8, progress=False)
    assert p3._process_batch is not p1._process_batch


def test_clear_empties_cache():
    cfg = _cfg()
    a = CompositePipeline(cfg, gop=8, progress=False)._build_gop_program(*GEO)
    progcache.clear()
    b = CompositePipeline(cfg, gop=8, progress=False)._build_gop_program(*GEO)
    assert b is not a
