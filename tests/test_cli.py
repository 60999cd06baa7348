"""CLI surface (render / realtime subcommands) on tiny frames."""
import json
import os

import numpy as np

from raytracinggpu.cli.main import main
from raytracinggpu.render.image_io import read_png


def test_render_subcommand(tmp_path, capsys):
    out = str(tmp_path / "img.png")
    rc = main([
        "render", "2", "2", "--preset", "showcase",
        "--width", "24", "--height", "16", "--out", out,
    ])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (16, 24, 3)
    cap = capsys.readouterr().out
    assert "Rendering time:" in cap
    stats_line = [l for l in cap.splitlines() if l.startswith("{")][0]
    rep = json.loads(stats_line)
    assert rep["primary_rays"] == 24 * 16 * 2
    assert rep["total_rays"] > rep["primary_rays"]


def test_render_positional_args_match_reference_shape(tmp_path):
    # ./binary <num_rays> <num_bounces> equivalence.
    out = str(tmp_path / "i.png")
    rc = main([
        "render", "1", "1", "--preset", "showcase",
        "--width", "8", "--height", "8", "--out", out,
    ])
    assert rc == 0 and os.path.exists(out)


def test_realtime_subcommand(tmp_path, capsys):
    ck = str(tmp_path / "s.npz")
    rc = main([
        "realtime", "--preset", "realtime", "--width", "16", "--height", "16",
        "--spp", "2", "--bounces", "2", "--frames", "2",
        "--out-dir", str(tmp_path / "f"), "--checkpoint", ck,
    ])
    assert rc == 0
    assert os.path.exists(ck)
    assert os.path.exists(tmp_path / "f" / "frame_00001.png")
    cap = capsys.readouterr().out
    summary = json.loads([l for l in cap.splitlines() if l.startswith("{")][-1])
    assert summary["frames"] == 2


def test_selfcheck_and_missing_obj(tmp_path, capsys):
    out = str(tmp_path / "s.png")
    rc = main([
        "render", "1", "1", "--preset", "showcase",
        "--width", "8", "--height", "8", "--out", out, "--selfcheck",
    ])
    assert rc == 0
    assert "selfcheck OK" in capsys.readouterr().out

    rc = main([
        "render", "1", "1", "--preset", "array_bvh",
        "--obj", str(tmp_path / "missing.obj"), "--out", out,
    ])
    assert rc == 1
    assert "file not found" in capsys.readouterr().err


def test_perf_knob_flags_thread_through(tmp_path):
    """Every perf knob the repo ships is CLI-exposed: --spp-unroll,
    --chunk-unroll and --depth-unroll must parse and produce the same image
    as the defaults (all are bit-identical-by-construction levers; on a
    tiny frame they mostly no-op, which is exactly why the flag PLUMBING is
    what this test pins)."""
    out_a = str(tmp_path / "a.png")
    out_b = str(tmp_path / "b.png")
    base = ["render", "2", "2", "--preset", "array_bvh",
            "--width", "16", "--height", "16"]
    assert main(base + ["--out", out_a]) == 0
    assert main(base + [
        "--out", out_b, "--spp-unroll", "2", "--chunk-unroll", "2",
        "--depth-unroll", "2",
    ]) == 0
    np.testing.assert_array_equal(read_png(out_a), read_png(out_b))
