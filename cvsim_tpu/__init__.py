"""cvsim_tpu — a JAX rebuild of composite-video-simulator.

This is the `composite-video-simulator_tpu` package (spelled `cvsim_tpu` so it is
importable from Python). It reimplements, from scratch as batched JAX/XLA
programs that run on a GPU, the full capability surface of the reference
C++ tool suite
`joncampbell123/composite-video-simulator`:

- the gen-1 YUV 4:2:2 composite/VHS engine  (`ffmpeg_to_composite.cpp`)
- the gen-2 signed-int YIQ engine            (`ffmpeg_ntsc.cpp`)
- VHS + cassette audio chains                (`ffmpeg_to_composite.cpp:558`,
                                              `ffmpeg_cassette.cpp:334`)
- the sibling pixel tools (colorkey, colormap, posterize, scanimate,
  average_delay, frameblend, filmac, vhsled)
- the raw composite-signal software TV decoder (`ffmpeg_raw28ntsc.cpp`)

Layout:
- ops/       scan/FIR/noise primitives (reference L5)
- models/    composite + VHS + tool engines (reference L6/L7)
- audio/     audio emulation chains (reference L7)
- parallel/  device mesh + sharding (original design; reference has none)
- host/      container I/O, PTS/field clock, streaming pipeline (reference L2-L4)
- cli/       flag-compatible command line (reference L8)
- utils/     logging/progress
"""

__version__ = "0.1.0"
