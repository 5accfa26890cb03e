"""Video overlay tooling — counterpart of the reference's
``q1physrl_make_speed_anim`` entry point (reference vidtools.py:66-84,
setup.py:33): renders per-frame speed-bar + "N ups" text overlays at 60 fps
from a demo file's origin trace, for compositing over game footage.

Host code with no tensors, the same as the JAX package's module: the whole
animation's bar strips are rendered as ONE vectorized (F, H, W, 4) numpy
broadcast (the reference recomputes a matplotlib colormap object and masks
per frame), with the text pass layered on top.  The visual contract —
32x256 'hot'-ramp bar scaled 0..700 ups, dimmed unfilled region, white
speed label — matches the reference so overlays remain comparable.
matplotlib and PIL are imported inside the functions that need them.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

import numpy as np

from . import analyse

__all__ = ("OverlayStyle", "demo_speeds", "resample_speeds",
           "render_speed_bars", "annotate_speed", "rgba_to_bgra",
           "make_speed_anim", "main")


@dataclasses.dataclass(frozen=True)
class OverlayStyle:
    """Geometry and palette of the speed overlay."""

    width: int = 256
    height: int = 32
    border: int = 2
    max_speed: float = 700.0     # full-bar speed, Quake units/s
    colormap: str = "hot"
    dim_rgba: tuple = (0, 0, 0, 128)   # unfilled bar region
    font_size: int = 28


def demo_speeds(times, origins):
    """Finite-difference horizontal speeds from a demo origin trace.

    Returns (segment_start_times, speeds), one entry per inter-frame
    segment (len(times) - 1).
    """
    times = np.asarray(times, float)
    origins = np.asarray(origins, float)
    dt = np.diff(times)
    dxy = np.diff(origins[:, :2], axis=0)
    return times[:-1], np.hypot(dxy[:, 0], dxy[:, 1]) / dt


def resample_speeds(seg_times, speeds, start, stop, fps):
    """Resample segment speeds onto a fixed-fps frame clock."""
    frame_times = np.arange(np.floor(start * fps), np.floor(stop * fps)) / fps
    return np.interp(frame_times, seg_times, speeds)


def render_speed_bars(speeds, style: OverlayStyle = OverlayStyle()):
    """Render every frame's speed bar at once -> (F, H, W, 4) uint8.

    Column c of the bar represents speed c/W * max_speed; columns at or
    below the frame's speed show the colormap ramp, the rest are dimmed.
    """
    import matplotlib

    speeds = np.atleast_1d(np.asarray(speeds, float))
    w, h, b = style.width, style.height, style.border
    ramp = matplotlib.colormaps[style.colormap](np.linspace(0.0, 1.0, w))
    ramp = (ramp * 255).astype(np.uint8)                       # (W, 4)
    thresholds = np.linspace(0.0, style.max_speed, w)          # (W,)
    filled = thresholds[None, :] <= speeds[:, None]            # (F, W)
    dim = np.asarray(style.dim_rgba, np.uint8)
    strip = np.where(filled[:, :, None], ramp[None], dim)      # (F, W, 4)

    frames = np.zeros((len(speeds), h + 2 * b, w + 2 * b, 4), np.uint8)
    frames[..., 3] = 255                                       # opaque border
    frames[:, b:h + b, b:w + b] = strip[:, None, :, :]
    return frames


def annotate_speed(frame, speed, style: OverlayStyle = OverlayStyle()):
    """Overlay the '<speed> ups' label onto one RGBA frame (returns a copy)."""
    import PIL.Image
    import PIL.ImageDraw
    import PIL.ImageFont

    try:
        font = PIL.ImageFont.truetype(
            "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
            style.font_size)
    except OSError:
        font = PIL.ImageFont.load_default()
    image = PIL.Image.fromarray(frame)
    PIL.ImageDraw.Draw(image).text((10, 0), f"{int(speed)} ups",
                                   (255, 255, 255), font=font)
    return np.asarray(image)


def rgba_to_bgra(im):
    """RGBA -> BGRA channel order (for OpenCV-style writers)."""
    return im[..., [2, 1, 0, 3]]


def make_speed_anim(demo_file_path, output_dir, anim_fps=60,
                    style: OverlayStyle = OverlayStyle()):
    """Render speed-overlay PNG frames (``output_dir/NNNNN.png``, one per
    tick of an ``anim_fps`` clock over the demo's time span) from a demo's
    origin trace; return how many."""
    import PIL.Image

    output_dir = pathlib.Path(output_dir)
    output_dir.mkdir(exist_ok=True, parents=True)

    times, origins, _yaws, _finish = analyse.parse_demo(
        pathlib.Path(demo_file_path))
    seg_times, speeds = demo_speeds(times, origins)
    frame_speeds = resample_speeds(seg_times, speeds, times[0], times[-1],
                                   anim_fps)
    bars = render_speed_bars(frame_speeds, style)
    for i, (bar, s) in enumerate(zip(bars, frame_speeds)):
        PIL.Image.fromarray(annotate_speed(bar, s, style)).save(
            output_dir / f"{i:05d}.png")
    return len(frame_speeds)


def main(argv=None):
    """CLI: q1physrl-torch-make-speed-anim <demo.dem> <output_dir>
    (60 fps)."""
    parser = argparse.ArgumentParser(
        prog="q1physrl-torch-make-speed-anim",
        description="Render speed-overlay PNG frames from a demo.")
    parser.add_argument("demo")
    parser.add_argument("output_dir")
    args = parser.parse_args(argv)
    n = make_speed_anim(args.demo, args.output_dir)
    print(f"wrote {n} frames to {args.output_dir}")


if __name__ == "__main__":
    main()
