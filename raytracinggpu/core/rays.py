"""Ray batches.

The reference ``Ray {O, u, refraction_index}`` carries the *current medium's*
index of refraction so nested refractive objects track which medium the ray is
travelling in (global_launcher.cu:93-99).  Here it is a pytree of
SoA arrays over the ray batch.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp

from raytracinggpu.core.vec import Vec3


class RayBatch(NamedTuple):
    O: Vec3  # origins
    u: Vec3  # unit directions
    ri: Any  # refraction index of the current medium, shape (R,)

    @staticmethod
    def make(O: Vec3, u: Vec3, ri=None) -> "RayBatch":
        if ri is None:
            ri = jnp.ones_like(u.x)
        return RayBatch(O, u, ri)

    def at(self, t) -> Vec3:
        """Point along the ray: O + t*u."""
        return self.O + self.u * t
