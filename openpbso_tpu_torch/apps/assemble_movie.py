"""assemble_movie — turn numbered frame PNGs into a movie.

The port's copy of openpbso_tpu/apps/assemble_movie.py (it touches no
device). Equivalent of the reference's ``scripts/remove_head_frames.py``: captured
viewer frames (``test-*.png`` from the CapturePlugin,
render_fields.cpp:40-84; here, render_fields' numbered exports) are
numerically sorted, the first ``start_from`` head frames are dropped (the
reference trims the pre-roll before the field animation settles), the
survivors are renumbered densely, and ffmpeg encodes them at the capture
rate (the reference's ``ffmpeg -r 30 ... -c:v libx264``).

Zero-egress friendly: when ffmpeg is absent (or ``--out`` ends in .gif)
the frames are assembled into an animated GIF with PIL instead.

    python -m openpbso_tpu_torch.apps.assemble_movie --frames renders \
        --pattern 'mode3-*.png' --start-from 30 --out mode3.mp4
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import subprocess
import sys
import tempfile


def numeric_frame_sort(paths: list[str]) -> list[str]:
    """Sort by the trailing integer in the filename (the reference's
    ``int(x.split('-')[-1].split('.')[0])`` key — 'test-10.png' must sort
    AFTER 'test-2.png', which plain string order gets wrong)."""

    def key(p):
        stem = os.path.splitext(os.path.basename(p))[0]
        m = re.search(r"(\d+)$", stem)
        if m is None:
            raise ValueError(f"frame name has no trailing number: {p}")
        return int(m.group(1))

    return sorted(paths, key=key)


def select_frames(frames_dir: str, pattern: str = "*.png",
                  start_from: int = 0,
                  count: int | None = None) -> list[str]:
    """Numerically-sorted frame paths with the head trimmed."""
    paths = numeric_frame_sort(glob.glob(os.path.join(frames_dir, pattern)))
    if not paths:
        raise FileNotFoundError(
            f"no frames match {pattern!r} in {frames_dir}")
    end = None if count is None else start_from + count
    out = paths[start_from:end]
    if not out:
        raise ValueError(f"start_from={start_from} skips all "
                         f"{len(paths)} frames")
    return out


def assemble(frames: list[str], out: str, fps: int = 30) -> str:
    """Encode the ordered frames into ``out`` (.mp4 via ffmpeg, .gif via
    PIL; mp4 falls back to gif with a warning when ffmpeg is missing)."""
    if not out.endswith(".gif") and shutil.which("ffmpeg"):
        with tempfile.TemporaryDirectory(prefix="pbso_movie_") as tmp:
            for i, src in enumerate(frames):
                # dense renumbering like the reference's tmp/test-%0.4u
                shutil.copy(src, os.path.join(tmp, f"frame-{i:04d}.png"))
            cmd = ["ffmpeg", "-y", "-r", str(fps), "-i",
                   os.path.join(tmp, "frame-%04d.png"),
                   "-c:v", "libx264", "-r", str(fps), "-crf", "5",
                   "-qcomp", "1.0", "-pix_fmt", "yuv420p", out]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"ffmpeg failed: {r.stderr[-500:]}")
        return out
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("neither ffmpeg nor PIL available to encode "
                           "the movie") from e
    if not out.endswith(".gif"):
        gif = os.path.splitext(out)[0] + ".gif"
        print(f"warning: ffmpeg not found; writing {gif} instead of {out}",
              file=sys.stderr)
        out = gif
    # convert() copies the pixels so each source file closes immediately
    # (a list of open Image handles exhausts fds on ~1000-frame captures)
    images = []
    for path in frames:
        with Image.open(path) as im:
            images.append(im.convert("P"))
    images[0].save(out, save_all=True, append_images=images[1:],
                   duration=int(1000 / fps), loop=0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", default=".",
                   help="directory of numbered frame PNGs")
    p.add_argument("--pattern", default="*.png")
    p.add_argument("--start-from", type=int, default=0,
                   help="head frames to drop (the reference's argv[1])")
    p.add_argument("--count", type=int, default=None,
                   help="max frames after the trim (reference used 1800)")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--out", default="movie.mp4")
    args = p.parse_args(argv)
    frames = select_frames(args.frames, args.pattern, args.start_from,
                           args.count)
    out = assemble(frames, args.out, fps=args.fps)
    print(f"wrote {out} ({len(frames)} frames @ {args.fps} fps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
