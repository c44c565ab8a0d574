#!/usr/bin/env python
"""End-to-end demo: synthesize SMPTE-ish color bars, push them through a few
tools, and write PNG snapshots (requires PIL; runs on CPU or GPU).

    python examples/demo.py /tmp/cvsim_demo
"""

import os
import sys
from fractions import Fraction

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from cvsim_tpu.cli.main import main as cvsim_main
from cvsim_tpu.host import y4m


BARS = [(192, 192, 192), (192, 192, 0), (0, 192, 192), (0, 192, 0),
        (192, 0, 192), (192, 0, 0), (0, 0, 192)]


def write_bars_clip(path, frames=4, w=704, h=480):
    yp = np.zeros((h, w), np.uint8)
    up = np.zeros((h // 2, w // 2), np.uint8)
    vp = np.zeros((h // 2, w // 2), np.uint8)
    seg = w // len(BARS)
    for k, (r, g, b) in enumerate(BARS):
        yl = 0.299 * r + 0.587 * g + 0.114 * b
        yp[:, k * seg:(k + 1) * seg] = int(yl * 219 / 255 + 16)
        up[:, k * seg // 2:(k + 1) * seg // 2] = int((b - yl) / 1.772 * 224 / 255 + 128)
        vp[:, k * seg // 2:(k + 1) * seg // 2] = int((r - yl) / 1.402 * 224 / 255 + 128)
    with open(path, "wb") as f:
        wr = y4m.Y4MWriter(f, y4m.Y4MHeader(
            width=w, height=h, fps=Fraction(30000, 1001)))
        for _ in range(frames):
            wr.write(yp, up, vp)


def save_png(y4m_path, png_path, frame=2):
    try:
        from PIL import Image
    except ImportError:
        print("PIL not available; skipping PNG", file=sys.stderr)
        return
    with open(y4m_path, "rb") as f:
        frames = list(y4m.Y4MReader(f))
    yf, uf, vf = frames[min(frame, len(frames) - 1)]
    u = np.repeat(np.repeat(uf, 2, 0), 2, 1).astype(np.float32) - 128
    v = np.repeat(np.repeat(vf, 2, 0), 2, 1).astype(np.float32) - 128
    yl = (yf.astype(np.float32) - 16) * 255 / 219
    rgb = np.stack([yl + 1.402 * 255 / 224 * v,
                    yl - 0.344 * 255 / 224 * u - 0.714 * 255 / 224 * v,
                    yl + 1.772 * 255 / 224 * u], -1)
    Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).save(png_path)
    print("wrote", png_path)


def run(outdir):
    os.makedirs(outdir, exist_ok=True)
    src = os.path.join(outdir, "bars.y4m")
    write_bars_clip(src)

    jobs = [
        ("vhs_ep", ["to-composite", "-vhs", "-vhs-speed", "ep", "-seed", "1"]),
        ("catv", ["ntsc", "-comp-catv2", "-seed", "2"]),
        ("posterize", ["posterize", "-threshhold", "3"]),
        ("average_delay", ["average-delay", "-d", "2", "-n", "64"]),
    ]
    for name, args in jobs:
        out = os.path.join(outdir, f"{name}.y4m")
        rc = cvsim_main(args + ["-i", src, "-o", out, "-width", "704"])
        assert rc == 0, name
        save_png(out, os.path.join(outdir, f"{name}.png"))


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "/tmp/cvsim_demo")
