"""Two-process jax.distributed (DCN-path) sharded render.

Spawns two worker processes, each owning 4 virtual CPU devices, that
coordinate through jax.distributed (the wire path a real multi-host pod
uses) and render one sharded frame; worker 0 gathers and checks it against
a single-process render (see parallel/multihost_demo.py).
"""


def test_two_process_multihost():
    from raytracinggpu.parallel.multihost_demo import launch

    assert launch(num_processes=2, port=9461) == 0
