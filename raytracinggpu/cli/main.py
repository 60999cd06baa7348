"""Command-line frontend.

The reference's CLI surface is one positional pair per binary —
``./binary <num_rays> <num_bounces>`` (global_launcher.cu:971-976) — with
everything else a compile-time constant and each optimization variant its own
Makefile target (SURVEY.md §5 'Makefile-target-as-config').  Here one CLI
exposes all of it: scene preset, resolution, spp/bounces, traversal mode
(the ablation axis), sharding, and the realtime loop.

Usage examples:
  python -m raytracinggpu.cli render --preset array_bvh 32 5 --out img.png
  python -m raytracinggpu.cli render --preset global --traversal dense
  python -m raytracinggpu.cli realtime --frames 60 --out-dir frames/
  python -m raytracinggpu.cli bench --preset array_bvh
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("spp", nargs="?", type=int, default=None,
                   help="samples per pixel (reference <num_rays>)")
    p.add_argument("bounces", nargs="?", type=int, default=None,
                   help="max ray depth (reference <num_bounces>)")
    p.add_argument("--preset", default="array_bvh",
                   choices=["cpu", "global", "optimized", "array_bvh",
                            "realtime", "showcase"])
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", dest="spp_flag", type=int, default=None)
    p.add_argument("--bounces", dest="bounces_flag", type=int, default=None)
    p.add_argument("--traversal", default=None,
                   choices=["walk", "dense", "bvh"],
                   help="mesh intersection mode (walk = the BVH walk "
                        "kernel; dense and bvh are kernel-free references)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", type=int, default=1,
                   help="shard across N devices ((N,1) px-mesh)")
    p.add_argument("--obj", default=None, metavar="PATH",
                   help="render a custom OBJ mesh instead of the preset cat")
    p.add_argument("--obj-scale", type=float, default=None,
                   help="uniform scale applied to the custom OBJ")
    p.add_argument("--obj-offset", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   metavar=("X", "Y", "Z"))
    p.add_argument("--spp-unroll", type=int, default=None, metavar="N",
                   help="unroll factor for the sample-group scan (perf-"
                        "only, bit-identical)")
    p.add_argument("--chunk-unroll", type=int, default=None, metavar="N",
                   help="straight-line the ray-chunk loop when the frame "
                        "splits into <= N chunks (perf-only, bit-"
                        "identical; costs compile time)")
    p.add_argument("--depth-unroll", type=int, default=None, metavar="N",
                   help="depth-loop unroll factor (perf-only, bit-"
                        "identical; default 8 = fully unrolled for "
                        "standard depths)")
    p.add_argument("--bvh-builder", default="reference",
                   choices=["reference", "lbvh"],
                   help="acceleration-structure builder")


def _build(args):
    from raytracinggpu.scene.presets import build_preset

    over = dict(width=args.width, height=args.height)
    spp = args.spp_flag if args.spp_flag is not None else args.spp
    bounces = args.bounces_flag if args.bounces_flag is not None else args.bounces
    if spp is not None:
        over["spp"] = spp
    if bounces is not None:
        over["max_depth"] = bounces
    if args.traversal:
        over["traversal"] = args.traversal
    if getattr(args, "spp_unroll", None) is not None:
        over["spp_unroll"] = args.spp_unroll
    if getattr(args, "chunk_unroll", None) is not None:
        over["chunk_unroll"] = args.chunk_unroll
    if getattr(args, "depth_unroll", None) is not None:
        over["depth_unroll"] = args.depth_unroll

    mesh = None
    builder = getattr(args, "bvh_builder", "reference")
    if getattr(args, "obj", None) and args.preset == "showcase":
        # Mirror api.Renderer: the showcase preset composes its own scene and
        # would silently ignore a custom mesh.
        raise SystemExit(
            "error: --obj is not supported with --preset showcase "
            "(the showcase scene ignores custom meshes)"
        )
    if getattr(args, "obj", None):
        # Custom mesh in place of the cat (beyond-reference capability: the
        # reference hardcodes its scene in every main()).
        from raytracinggpu.scene.mesh import build_mesh, rescale
        from raytracinggpu.scene.obj import read_obj

        obj = read_obj(args.obj)
        if (args.obj_scale is not None
                or tuple(args.obj_offset) != (0.0, 0.0, 0.0)):
            # an offset alone must not be dropped (scale defaults to 1)
            obj.vertices = rescale(
                obj.vertices,
                1.0 if args.obj_scale is None else args.obj_scale,
                args.obj_offset)
        mesh = build_mesh(obj, builder=builder)
    elif builder != "reference":
        from raytracinggpu.scene.mesh import load_cat_mesh
        from raytracinggpu.scene.obj import CAT_OBJ_PATH
        from raytracinggpu.scene.presets import _MESH_TRANSFORM

        if args.preset in _MESH_TRANSFORM:
            embed, s, off = _MESH_TRANSFORM[args.preset]
            mesh = load_cat_mesh(CAT_OBJ_PATH, embed, s, off,
                                 builder=builder)
    return build_preset(args.preset, mesh=mesh, **over)


def cmd_render(args) -> int:
    import jax
    import numpy as np

    from raytracinggpu.render.image_io import tonemap, write_png
    from raytracinggpu.render.pipeline import Camera, render_frame
    from raytracinggpu.utils.profiling import device_trace, ray_report

    cfg, tables = _build(args)
    cam = Camera.default(cfg)
    key = jax.random.PRNGKey(args.seed)

    def run():
        if args.devices > 1:
            from raytracinggpu.parallel.sharding import (
                make_mesh,
                render_frame_sharded,
            )

            mesh = make_mesh(n_px=args.devices, n_sp=1,
                             devices=jax.devices()[: args.devices])
            img, stats = render_frame_sharded(tables, cfg, cam, key, mesh)
        else:
            img, stats = render_frame(tables, cfg, cam, key)
        img.block_until_ready()
        return img, stats

    if args.profile:
        run()  # compile outside the trace
    t0 = time.perf_counter()
    with device_trace(args.profile):
        img, stats = run()
    wall = time.perf_counter() - t0
    if args.profile:
        print(f"profiler trace -> {args.profile} (view with tensorboard)")

    out = args.out or f"image_{args.preset}.png"
    arr = np.asarray(img)
    if args.selfcheck:
        # SURVEY.md §5: the stand-in for compute-sanitizer — validate the
        # frame (finite radiance; hits account for every ray in the
        # enclosed scenes) and determinism (same seed => identical frame).
        # Re-run the SAME path (sharded stays sharded): a sharded frame is
        # bitwise-equal to single-device by test, but comparing across two
        # different compilations here would report a misleading
        # "nondeterministic render" on any fusion-layout difference.
        assert np.isfinite(arr).all(), "non-finite radiance in frame"
        img2, _ = run()
        assert np.array_equal(np.asarray(img2), arr), "nondeterministic render"
        print("selfcheck OK: finite + deterministic")
    write_png(out, tonemap(arr))
    rep = ray_report(stats, cfg.spp, cfg.width, cfg.height, wall)
    print(f"Rendering time: {wall:.3f} s")  # reference print shape
    print(json.dumps(rep))
    print(f"wrote {out}")
    return 0


def cmd_realtime(args) -> int:
    from raytracinggpu.render.realtime import run_loop
    from raytracinggpu.utils.checkpoint import save_state

    cfg, tables = _build(args)
    animate = getattr(args, "animate", "light")
    if animate in ("mesh", "both"):
        from dataclasses import replace

        cfg = replace(cfg, animate_mesh=True)
    light_speed = args.light_speed if animate in ("light", "both") else 0.0
    raw = sys.stdout.buffer if args.raw else None
    if args.interactive:
        for flag in ("checkpoint", "raw"):
            if getattr(args, flag, None):
                print(f"warning: --{flag} is ignored with --interactive",
                      file=sys.stderr)
        return _interactive_loop(tables, cfg, args, light_speed)
    state, summary = run_loop(
        tables,
        cfg,
        n_frames=args.frames,
        seed=args.seed,
        out_dir=args.out_dir,
        raw_pipe=raw,
        angular_speed=light_speed,
        mesh_speed=args.mesh_speed,
        frames_per_dispatch=getattr(args, "frames_per_dispatch", 1),
    )
    info = sys.stderr if args.raw else sys.stdout
    if args.checkpoint:
        save_state(args.checkpoint, state)
        print(f"checkpoint -> {args.checkpoint}", file=info)
    print(json.dumps(summary), file=info)
    return 0


def _interactive_loop(tables, cfg, args, light_speed=1.0) -> int:
    """Terminal-interactive progressive rendering — the GL-free equivalent of
    the reference's GLUT loop (realtime_render.cu:1214-1298).  The same key
    bindings (a/d/r/f/w/s translate, h/l/k/j = arrow yaw/pitch, q = ESC)
    apply between frames; the latest display frame is continuously written
    to <--out-dir>/live.png (default ./live.png) for an image viewer to
    follow."""
    import select
    import sys
    import termios
    import time
    import tty

    import numpy as np

    from raytracinggpu.render.image_io import write_png
    from raytracinggpu.render.realtime import init_state, on_key, step, steps

    import os

    keymap = {"h": "left", "l": "right", "k": "up", "j": "down"}
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        out = os.path.join(args.out_dir, "live.png")
    else:
        out = "live.png"
    g = max(1, getattr(args, "frames_per_dispatch", 1))
    state = init_state(cfg, tables, seed=args.seed)
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    print(f"interactive: writing {out}; keys a/d r/f w/s move, h/l/k/j look, q quits")
    try:
        tty.setcbreak(fd)
        i = 0
        pending = None  # dispatched-but-unread display (1-frame pipeline,
        # overlapping host dispatch with device compute — the async
        # analog of the reference's free-running GLUT pump)
        t0 = time.perf_counter()
        while args.frames <= 0 or i < args.frames:
            if g == 1:
                state, display = step(
                    tables, cfg, state,
                    angular_speed=np.float32(light_speed),
                    mesh_speed=np.float32(args.mesh_speed),
                )
            else:
                # micro-batch: g progressive frames per dispatch (key
                # events apply between dispatches, i.e. every g frames)
                state, batch = steps(
                    tables, cfg, g, state, np.float32(light_speed),
                    mesh_speed=np.float32(args.mesh_speed),
                )
                display = batch[-1]
            if pending is not None:
                pending.block_until_ready()
                t1 = time.perf_counter()
                dt = (t1 - t0) / g
                t0 = t1
                write_png(out, np.asarray(pending))
                # pending holds the previous dispatch's newest frame
                if ((i - g) // g) % max(1, 5 // g) == 0:
                    print(f"frame {i - g}: {dt*1e3:.0f} ms "
                          f"({1/dt:.2f} FPS)", flush=True)
            pending = display
            while select.select([sys.stdin], [], [], 0)[0]:
                ch = sys.stdin.read(1)
                if ch == "q" or ch == "\x1b":
                    return 0
                state = on_key(state, keymap.get(ch, ch))
            i += g
        if pending is not None:
            pending.block_until_ready()
            write_png(out, np.asarray(pending))
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
    return 0


def cmd_bench(args) -> int:
    from raytracinggpu.bench.sweep import run_sweep

    # Positional spp/bounces (reference CLI shape: `bench 4 2`) restrict
    # the sweep to that single cell instead of being silently ignored.
    spp = args.spp_flag if args.spp_flag is not None else args.spp
    bounces = (args.bounces_flag if args.bounces_flag is not None
               else args.bounces)
    run_sweep(
        preset=args.preset,
        width=args.width,
        height=args.height,
        spps=[int(spp)] if spp is not None
        else [int(s) for s in args.spps.split(",")],
        bounces=[int(bounces)] if bounces is not None
        else [int(b) for b in args.bounce_list.split(",")],
        repeats=args.repeats,
        traversal=args.traversal,
        out=args.out,
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytracinggpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="single-frame render to PNG")
    _add_common(pr)
    pr.add_argument("--out", default=None)
    pr.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler trace of the render to DIR")
    pr.add_argument("--selfcheck", action="store_true",
                    help="validate the frame (finite, deterministic)")

    pt = sub.add_parser("realtime", help="progressive loop with circulating light")
    _add_common(pt)
    pt.set_defaults(preset="realtime")
    pt.add_argument("--frames", type=int, default=30)
    pt.add_argument("--out-dir", default=None)
    pt.add_argument("--raw", action="store_true",
                    help="stream raw RGB24 frames to stdout (ffmpeg pipe)")
    pt.add_argument("--light-speed", type=float, default=1.0)
    pt.add_argument("--animate", choices=["light", "mesh", "both"],
                    default="light",
                    help="per-frame animation: circulating light (reference "
                         "demo), spinning mesh (jitted pose transform), or "
                         "both")
    pt.add_argument("--mesh-speed", type=float, default=1.0)
    pt.add_argument("--checkpoint", default=None)
    pt.add_argument("--interactive", action="store_true",
                    help="terminal-interactive camera (GLUT-equivalent keys)")
    pt.add_argument("--frames-per-dispatch", type=int, default=1,
                    metavar="G",
                    help="micro-batch G frames into one device dispatch "
                         "(steps() scan) to amortize per-dispatch host "
                         "cost; input latency grows to ~2G frames.  "
                         "Bit-identical to G=1")

    pb = sub.add_parser("bench", help="benchmark sweep (benchmark.py parity)")
    _add_common(pb)
    pb.add_argument("--spps", default="1,2,4,8,16,32,64,128,256")
    pb.add_argument("--bounce-list", default="1,2,3,4,5,6,7,8,9,10")
    pb.add_argument("--repeats", type=int, default=5)
    pb.add_argument("--out", default=None)

    args = ap.parse_args(argv)
    from raytracinggpu.utils.cache import setup_cache

    setup_cache()
    try:
        if args.cmd == "render":
            return cmd_render(args)
        if args.cmd == "realtime":
            return cmd_realtime(args)
        if args.cmd == "bench":
            return cmd_bench(args)
    except FileNotFoundError as e:
        # Graceful asset errors (the reference prints-and-returns on a
        # missing OBJ, cpu_launcher.cpp:322-325).
        print(f"error: file not found: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
