"""Interactive realtime CLI under a pseudo-terminal (GLUT-equivalent loop)."""
import os
import select
import subprocess
import sys
import time

import pytest


@pytest.mark.skipif(not hasattr(os, "openpty"), reason="needs pty support")
def test_interactive_quits_on_q(tmp_path):
    master, slave = os.openpty()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from raytracinggpu.cli.main import main;"
        "raise SystemExit(main(["
        "'realtime','--preset','showcase','--width','8','--height','8',"
        "'--spp','1','--bounces','1','--frames','50','--interactive',"
        f"'--out-dir','{tmp_path}']))"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", code],
        stdin=slave, stdout=slave, stderr=subprocess.DEVNULL, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    os.close(slave)
    try:
        # Give it time to compile + render a few frames, send a camera key
        # then quit.
        deadline = time.time() + 120
        sent_q = False
        while proc.poll() is None and time.time() < deadline:
            r, _, _ = select.select([master], [], [], 1.0)
            if r:
                try:
                    os.read(master, 4096)
                except OSError:
                    break
            if not sent_q and os.path.exists(tmp_path / "live.png"):
                os.write(master, b"w")   # camera move
                time.sleep(0.5)
                os.write(master, b"q")   # quit
                sent_q = True
        assert sent_q, "interactive loop never produced live.png"
        proc.wait(timeout=60)
        assert proc.returncode == 0
        assert os.path.exists(tmp_path / "live.png")
    finally:
        if proc.poll() is None:
            proc.kill()
        os.close(master)
