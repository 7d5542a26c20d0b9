"""Command-line entry — reference src/main.rs:25-42 (counterpart of
``kanirenderer_tpu/cli.py``).

Positional arguments mirror the reference binary exactly:
  kanirenderer <file.obj> <opengl|default> [windowed|fullscreen] [hdr:true]
plus optional flags for the headless runtime (resolution, frame count,
output sink, render mode, device).
"""

from __future__ import annotations

import argparse
import sys

from kanirenderer_tpu_torch import api
from kanirenderer_tpu_torch.core.types import RenderMode

CONTROLS = """\
kanirenderer — mesh previewer on PyTorch and CUDA
  camera: WASD/arrows move, Space/LShift up/down, RMB-drag look, wheel zoom
  movable light: IJKL move, U/O up/down, =/- range, [/] color
  sun: R/T/Y rotate, 2/3 distance; Tab: render mode; 1: debug texture
  F1: present mode, F11: fullscreen
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="kanirenderer", description=CONTROLS,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("file_path", nargs="?", default="",
                    help="OBJ file (empty -> default cube)")
    ap.add_argument("file_type", nargs="?", default="opengl",
                    choices=["opengl", "default"],
                    help="texture convention (V-flip + green-invert for "
                         "opengl)")
    ap.add_argument("fullscreen_mode", nargs="?", default="windowed",
                    choices=["windowed", "fullscreen"])
    ap.add_argument("hdr", nargs="?", default="hdr:false",
                    help="hdr:true|hdr:false")
    ap.add_argument("--width", type=int, default=1440)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=60,
                    help="frame count; 0 = run until quit (interactive)")
    ap.add_argument("--mode", default="lit_shadow",
                    choices=[m.name.lower() for m in RenderMode])
    ap.add_argument("--sink", default="png",
                    choices=["png", "gif", "window", "null"])
    ap.add_argument("--out", default=None, help="output path for png/gif")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the scene lives and the frames render; "
                         "cuda needs a card and fails without one")
    ap.add_argument("--point-lights", type=int, default=1, metavar="N",
                    help="spawn N random point lights (the reference's "
                         "disabled light spawner, src/lib.rs:453-512; "
                         "N>=50 adds green+blue sets)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run to DIR")
    ap.add_argument("--render-scale", type=int, default=1, metavar="S",
                    help="render at 1/S of the resolution")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    use_hdr = str(args.hdr).lower() in ("hdr:true", "true", "1")
    if not args.quiet:
        print(CONTROLS)
    api.run(args.file_path, args.file_type, args.fullscreen_mode, use_hdr,
            width=args.width, height=args.height,
            mode=RenderMode[args.mode.upper()], frames=args.frames,
            sink=args.sink, out=args.out, verbose=not args.quiet,
            profile_dir=args.profile, point_lights=args.point_lights,
            render_scale=args.render_scale, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
