"""Smoke test of the renderer's main path on one NVIDIA GPU.

Runs in one process and needs a GPU: with none it exits non-zero and
prints no result.  Phases, each printing one line:

1. device   -- platform, device kind and count, and the card's name and
               power limit from nvidia-smi (a child process without JAX).
2. kernels  -- the walk kernel's closest-hit and shadow casts compiled for
               the card on a real depth-1 wavefront of the headline frame
               (cat, 512x512, one fused group of spp_fuse samples), compared
               with the dense reference; prints the cast's memory analysis.
3. headline -- Renderer("array_bvh", spp=32, max_depth=5) at 512x512:
               per-depth hit counts, shadows, a finite image, parity with a
               dense frame at the same seed, the Triton kernels present in
               the compiled program, and the frame time (median of 3).
4. realtime -- render/realtime.run_loop on the realtime preset at 512x512,
               spp 20, depth 3 (realtime_render.cu:1264-1265), 10 frames.
5. materials -- the showcase preset at 128x128: refraction with total
               internal reflection, finite output.

Options (not part of the default run):
  --compare [--modes walk,dense,bvh] [--size 512x512]
        time the headline frame end to end in each traversal mode.
  --four
        only the four-card phase: the headline frame over a (px=2, sp=2)
        mesh, compared with the same frame on card 0 alone.

The last line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage: python chip_smoke.py [--compare ...] [--four]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# Frame-level tolerances against the dense reference at the same seed (a
# flipped closest-hit winner reroutes that sample's whole path, so the
# frames are compared statistically).
STATS_REL = 5e-4       # per-depth lane counts
MEAN_REL = 1e-3        # per-channel image mean
PIXELS_1_255 = 0.95    # share of tonemapped pixels within 1/255
# Cast-level tolerances: both sides evaluate the same fp32 algebra and
# differ only by summation order and FMA contraction.
AGREE = 0.9999         # hit/miss, winning triangle, shadow predicate
T_REL = 1e-5           # t where the winners agree (plus conditioning)


def check(ok, detail=None) -> None:
    """Fail the phase (and so the run) unless ok; unlike assert, this
    survives ``python -O``."""
    if not ok:
        raise RuntimeError(f"check failed: {detail!r}")


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def card_info() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` lines (no JAX involved)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}")
    return dev


def _median_time(fn, reps: int = 3) -> float:
    """Median wall time of fn() (which blocks on its result) after one
    warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _chunked(fn, chunk: int, *arrays):
    """Apply fn to ray chunks (lax.map): bounds the dense reference's
    (chunk, 4, tri_block) intermediates on a full wavefront."""
    import jax
    import jax.numpy as jnp

    R = arrays[0].shape[0]
    pad = (-R) % chunk
    xs = [jnp.pad(a, (0, pad)).reshape(-1, chunk) for a in arrays]
    out = jax.lax.map(lambda x: fn(*x), xs)
    return jax.tree.map(lambda a: a.reshape(-1)[:R], out)


def depth1_wavefront(cfg, tables, key):
    """The depth-1 rays of one fused sample group of the frame: the bounce
    rays leaving the depth-0 hits, and the shadow rays of their own hits,
    all traced with the dense reference so the wavefront does not depend on
    the kernel under test."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracinggpu.core.rng import box_muller_jitter, cosine_hemisphere
    from raytracinggpu.core.vec import Vec3, vwhere
    from raytracinggpu.integrator import wavefront as wf
    from raytracinggpu.render.pipeline import Camera, raygen, row_uniforms

    ref = dataclasses.replace(cfg, traversal="dense")
    cam = Camera.default(cfg)
    rows = jnp.arange(cfg.height, dtype=jnp.int32)
    eps = np.float32(cfg.eps_bounce)
    mats = tables.materials

    @jax.jit
    def build(key):
        Os, us, uns = [], [], []
        for s in range(cfg.spp_fuse):
            un = row_uniforms(jax.random.fold_in(key, s), rows, cfg.width, 2)
            gx, gy = box_muller_jitter(un[0, 0], un[0, 1],
                                       np.float32(cfg.sigma))
            O, u = raygen(cfg, cam, gx, gy, rows)
            Os.append(O)
            us.append(u)
            uns.append(un)
        cat = lambda vs: Vec3(*(jnp.concatenate(c) for c in zip(*vs)))
        O, u = cat(Os), cat(us)
        un = jnp.concatenate(uns, axis=-1)

        def step(O, u, r1, r2):
            h = _chunked(
                lambda *c: wf.intersect_all(
                    tables, ref, Vec3(*c[:3]), Vec3(*c[3:])),
                cfg.ray_chunk, *O, *u)
            hit = h.obj >= 0
            oid = jnp.maximum(h.obj, 0)
            is_mirror = hit & mats.mirror[oid]
            is_refr = hit & ~mats.mirror[oid] & (
                mats.in_ri[oid] != mats.out_ri[oid])
            is_diff = hit & ~is_mirror & ~is_refr
            P_adj = h.P + h.N * eps
            Lv = tables.L - P_adj
            wl = (tables.L - h.P).normalized()
            sh_active = is_diff & (h.N.dot(wl) > 0.0)
            u_dif = cosine_hemisphere(r1, r2, h.N)
            u_mir = u - h.N * (2.0 * u.dot(h.N))
            O1 = vwhere(is_diff, P_adj, vwhere(is_mirror, h.P + h.N * eps, O))
            u1 = vwhere(is_diff, u_dif, vwhere(is_mirror, u_mir, u))
            return O1, u1, P_adj, Lv, sh_active

        O1, u1, *_ = step(O, u, un[1, 0], un[1, 1])
        _, _, shO, Lv, sh_active = step(O1, u1, un[2, 0], un[2, 1])
        return O1, u1, shO, Lv.normalized(), Lv.norm2(), sh_active

    return jax.block_until_ready(build(key))


def compare_casts(width=512, height=512, spp_fuse=None, seed=0):
    """Phase 2: the compiled walk casts vs dense on a real wavefront."""
    import jax
    import numpy as np

    from raytracinggpu.core.vec import Vec3
    from raytracinggpu.ops.sphere import INF
    from raytracinggpu.ops.triangle import intersect_tris_dense
    from raytracinggpu.ops.walk import (
        intersect_tris_walk,
        intersect_tris_walk_shadow,
    )
    from raytracinggpu.scene.presets import build_preset

    over = {} if spp_fuse is None else {"spp_fuse": spp_fuse}
    cfg, tables = build_preset("array_bvh", width=width, height=height,
                               spp=32, max_depth=5, **over)
    O, u, shO, shu, cap2, active = depth1_wavefront(
        cfg, tables, jax.random.PRNGKey(seed))
    R = int(O.x.shape[0])
    eps = cfg.eps_leaf

    closest = jax.jit(lambda O, u: intersect_tris_walk(O, u, tables.walk, eps))
    compiled = closest.lower(O, u).compile()
    mem = compiled.memory_analysis()
    shadow = jax.jit(lambda O, u, c, a: intersect_tris_walk_shadow(
        O, u, tables.walk, eps, c, active=a))
    dense = jax.jit(lambda O, u: _chunked(
        lambda *c: tuple(intersect_tris_dense(
            Vec3(*c[:3]), Vec3(*c[3:]), tables.mesh, eps)),
        cfg.ray_chunk, *O, *u))

    w = jax.tree.map(np.asarray, compiled(O, u))
    d = [np.asarray(a) for a in dense(O, u)]
    t_w, idx_w = w.t, w.idx
    t_d, idx_d = d[0], d[1]
    hit = t_d < INF
    hm_agree = float(((t_w < INF) == hit).mean())
    both = hit & (t_w < INF)
    same = both & (idx_w == idx_d)
    idx_agree = float(same.sum() / max(both.sum(), 1))
    rel = np.abs(t_w[same] - t_d[same]) / np.abs(t_d[same])
    # conditioning of t = (A.Ng - O.Ng)/denom (see tests/test_walk.py)
    mt = np.asarray(tables.mesh.mt, np.float64)
    k = idx_d[same]
    o = np.stack([np.asarray(c) for c in O], 1)[same].astype(np.float64)
    dd = np.stack([np.asarray(c) for c in u], 1)[same].astype(np.float64)
    ng = mt[0:3, 0, k].T
    cond = (np.abs((o * ng).sum(1)) + np.abs(mt[9, 3, k])) / np.abs(
        (dd * ng).sum(1))
    bound = T_REL + 8 * np.finfo(np.float32).eps * cond / np.abs(t_d[same])
    closest_report = {
        "rays": R, "hits": int(hit.sum()),
        "hitmiss_agree": hm_agree, "idx_agree": idx_agree,
        "t_max_rel": float(rel.max()) if rel.size else 0.0,
        "t_over_1e-5": int((rel > T_REL).sum()),
        "t_over_bound": int((rel > bound).sum()),
        "bitwise": bool(np.array_equal(t_w, t_d)
                        and np.array_equal(idx_w, idx_d)),
    }
    ts = np.asarray(shadow(shO, shu, cap2, active))
    td = np.asarray(dense(shO, shu)[0])
    act = np.asarray(active)
    c2 = np.asarray(cap2)
    occ_w, occ_d = ts * ts <= c2, td * td <= c2
    shadow_report = {
        "rays": R, "active": int(act.sum()),
        "occluded_dense": int((occ_d & act).sum()),
        "pred_agree": float((occ_w == occ_d)[act].mean()),
    }
    return {"closest": closest_report, "shadow": shadow_report,
            "memory": {
                "argument_bytes": mem.argument_size_in_bytes,
                "output_bytes": mem.output_size_in_bytes,
                "temp_bytes": mem.temp_size_in_bytes,
                "generated_code_bytes": mem.generated_code_size_in_bytes,
            } if mem is not None else None}


def phase_kernels():
    rep = compare_casts()
    log("kernels", **rep)
    c, s = rep["closest"], rep["shadow"]
    check(c["hitmiss_agree"] >= AGREE, c)
    check(c["idx_agree"] >= AGREE, c)
    check(c["t_over_bound"] == 0, c)
    check(s["pred_agree"] >= AGREE, s)
    check(0 < s["occluded_dense"] < s["active"], s)


def _compiled_text(cfg, tables, cam, key):
    from raytracinggpu.render.pipeline import render_frame

    return render_frame.lower(tables, cfg, cam, key).compile().as_text()


def phase_headline(card: str, size: int = 512, spp: int = 32):
    import jax
    import numpy as np

    from raytracinggpu import Renderer
    from raytracinggpu.render.image_io import tonemap
    from raytracinggpu.render.pipeline import (
        Camera,
        rays_per_frame,
        render_frame,
    )

    r = Renderer("array_bvh", spp=spp, max_depth=5, width=size, height=size)
    cfg, tables = r.cfg, r.scene
    cam = Camera.default(cfg)
    text = _compiled_text(cfg, tables, cam, jax.random.PRNGKey(0))
    n_triton = text.count("__gpu$xla.gpu.triton")
    kernels = sorted({n for n in ("bvh_walk_closest", "bvh_walk_shadow")
                      if n in text})
    img, stats = r.render_hdr(seed=1)
    d = Renderer("array_bvh", spp=spp, max_depth=5, width=size, height=size,
                 traversal="dense")
    img_d, stats_d = d.render_hdr(seed=1)
    n_rays = cfg.width * cfg.height * cfg.spp
    hit = np.asarray(stats.hit)
    hit_d = np.asarray(stats_d.hit)
    shadowed = np.asarray(stats.shadowed)
    st_rel = max(
        float(np.max(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
                     / np.maximum(np.asarray(b, np.int64), 1)))
        for a, b in zip(stats, stats_d))
    mean_rel = (np.abs(img.mean((0, 1)) - img_d.mean((0, 1)))
                / np.abs(img_d.mean((0, 1))))
    px = np.abs(tonemap(img).astype(int) - tonemap(img_d).astype(int))
    px_ok = float((px.max(-1) <= 1).mean())

    def run():
        im, _ = render_frame(tables, cfg, cam, jax.random.PRNGKey(2))
        im.block_until_ready()

    dt = _median_time(run)
    log("headline", traversal=cfg.traversal, shape=[cfg.width, cfg.height],
        spp=cfg.spp, depth=cfg.max_depth, triton_calls=n_triton,
        kernels=kernels, hit_per_depth=hit.tolist(),
        dense_hit_per_depth=hit_d.tolist(),
        shadowed_per_depth=shadowed.tolist(), stats_max_rel=st_rel,
        mean_rel=mean_rel.tolist(), pixels_within_1_255=px_ok,
        bitwise_vs_dense=bool(np.array_equal(img, img_d)),
        frame_s=dt, rays_per_s=rays_per_frame(cfg) / dt, card=card)
    if jax.default_backend() == "gpu" and cfg.traversal == "walk":
        # compiled for the card, never interpreted
        check(n_triton >= 2 and len(kernels) == 2, (n_triton, kernels))
    # Every primary ray hits (the room is closed).  Deeper, a path can
    # leave the room: the cat's feet sink 0.06 units into the floor sphere
    # (array_bvh.cu's v*0.6+(0,-10,0)), so a bounce off a sunken face starts
    # inside that sphere.  That is the scene's geometry, in every mode.
    check(hit[0] == n_rays and (hit >= n_rays * (1 - 1e-6)).all(), hit)
    check(shadowed.sum() > 0)
    check(np.isfinite(img).all())
    check(st_rel <= STATS_REL, st_rel)
    check((mean_rel <= MEAN_REL).all(), mean_rel)
    check(px_ok >= PIXELS_1_255, px_ok)


def phase_realtime(size: int = 512):
    import numpy as np

    from raytracinggpu.render.realtime import run_loop
    from raytracinggpu.scene.presets import build_preset

    cfg, tables = build_preset("realtime", width=size, height=size)
    check((cfg.spp, cfg.max_depth) == (20, 3))

    class Frames:
        def __init__(self):
            self.frames = []

        def write(self, b):
            self.frames.append(np.frombuffer(b, np.uint8))

    sink = Frames()
    state, summary = run_loop(tables, cfg, n_frames=10, seed=0,
                              raw_pipe=sink, print_every=0,
                              frames_per_dispatch=1)
    first, _ = run_loop(tables, cfg, n_frames=1, seed=0, print_every=0)
    accum = np.asarray(state.accum)
    mean1 = np.asarray(first.accum)
    # The progressive mean after 10 frames differs from frame 1's (the
    # light moved and new samples landed); u8 displays may saturate.
    delta = float(np.abs(accum / 10.0 - mean1).mean() / np.abs(mean1).mean())
    changed = sum(not np.array_equal(a, b)
                  for a, b in zip(sink.frames, sink.frames[1:]))
    log("realtime", traversal=cfg.traversal, shape=[cfg.width, cfg.height],
        spp=cfg.spp, depth=cfg.max_depth, frames=summary["frames"],
        median_ms=summary["median_ms"], mean_ms=summary["mean_ms"],
        first_frame_ms=summary["first_frame_ms"],
        displays_changed=changed, accum_mean_rel_change=delta)
    check(int(state.frames) == 10 and len(sink.frames) == 10)
    check(np.isfinite(accum).all())
    check(delta > 0.0, delta)


def phase_materials(size: int = 128):
    import numpy as np

    from raytracinggpu import Renderer

    r = Renderer("showcase", width=size, height=size, spp=8, max_depth=5)
    img, stats = r.render_hdr(seed=0)
    tir = int(np.asarray(stats.tir).sum())
    log("materials", shape=[size, size], spp=8, depth=5, tir=tir,
        refract=int(np.asarray(stats.refract).sum()),
        mirror=int(np.asarray(stats.mirror).sum()),
        finite=bool(np.isfinite(img).all()))
    check(tir > 0)
    check(np.isfinite(img).all())


def phase_compare(modes, width, height, card):
    import jax

    from raytracinggpu.render.pipeline import (
        Camera,
        rays_per_frame,
        render_frame,
    )
    from raytracinggpu.scene.presets import build_preset

    for mode in modes:
        t0 = time.perf_counter()
        cfg, tables = build_preset("array_bvh", width=width, height=height,
                                   spp=32, max_depth=5, traversal=mode)
        cam = Camera.default(cfg)
        compiled = render_frame.lower(
            tables, cfg, cam, jax.random.PRNGKey(0)).compile()
        setup = time.perf_counter() - t0

        def run():
            im, _ = compiled(tables, cam, jax.random.PRNGKey(3))
            im.block_until_ready()

        dt = _median_time(run)
        log("compare", traversal=mode, shape=[width, height], spp=32,
            depth=5, frame_s=dt, rays_per_s=rays_per_frame(cfg) / dt,
            setup_s=setup, card=card)


def phase_four(size: int = 512):
    import jax
    import numpy as np

    from raytracinggpu.parallel.sharding import make_mesh, render_frame_sharded
    from raytracinggpu.render.pipeline import Camera, render_frame
    from raytracinggpu.scene.presets import build_preset

    check(len(jax.devices()) >= 4, jax.devices())
    n_px, n_sp = 2, 2
    cfg, tables = build_preset("array_bvh", width=size, height=size, spp=32,
                               max_depth=5, spp_fuse=32 // n_sp)
    cam = Camera.default(cfg)
    key = jax.random.PRNGKey(0)
    mesh = make_mesh(n_px=n_px, n_sp=n_sp, devices=jax.devices()[:4])
    img, stats = render_frame_sharded(tables, cfg, cam, key, mesh)
    img.block_until_ready()
    t0 = time.perf_counter()
    img, stats = render_frame_sharded(tables, cfg, cam, key, mesh)
    img.block_until_ready()
    dt4 = time.perf_counter() - t0
    one = jax.device_put(tables, jax.devices()[0])
    ref, ref_stats = render_frame(one, cfg, cam, key)
    ref.block_until_ready()
    a, b = np.asarray(img), np.asarray(ref)
    log("four", mesh={"px": n_px, "sp": n_sp}, spp_fuse=cfg.spp_fuse,
        traversal=cfg.traversal, bitwise=bool(np.array_equal(a, b)),
        max_abs_diff=float(np.abs(a - b).max()),
        stats_equal=all(np.array_equal(np.asarray(x), np.asarray(y))
                        for x, y in zip(stats, ref_stats)),
        sharded_frame_s=dt4)
    check(np.isfinite(a).all())
    check(np.array_equal(a, b), float(np.abs(a - b).max()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--modes", default="walk,dense,bvh")
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--four", action="store_true")
    args = ap.parse_args(argv)

    import jax

    from raytracinggpu.utils.cache import setup_cache

    dev = require_gpu()
    setup_cache()
    cards = card_info()
    log("device", platform=dev.platform, kind=dev.device_kind,
        count=len(jax.devices()), nvidia_smi=cards)
    print(cards[0], flush=True)
    card = cards[0]

    if args.four:
        phase_four()
    elif args.compare:
        w, h = (int(x) for x in args.size.split("x"))
        phase_compare(args.modes.split(","), w, h, card)
    else:
        phase_kernels()
        phase_headline(card)
        phase_realtime()
        phase_materials()

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
