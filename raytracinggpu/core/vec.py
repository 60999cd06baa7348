"""Structure-of-arrays 3-vector math.

The reference carries a per-ray ``Vector`` class with overloaded operators
(global_launcher.cu:40-91, cpu_launcher.cpp:45-96).  The batched
equivalent is three arrays of shape ``(R,)`` (one per component), so every
operation is a dense elementwise op over the ray batch with contiguous
per-component loads.

``Vec3`` is a NamedTuple and therefore a JAX pytree; it works transparently
under ``jit`` / ``vmap`` / ``shard_map`` and with numpy arrays (all methods use
operator arithmetic plus ``jnp`` ufuncs that accept numpy inputs).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp


class Vec3(NamedTuple):
    """A batch of 3D vectors stored as separate component arrays."""

    x: Any
    y: Any
    z: Any

    # ---- construction -------------------------------------------------
    @staticmethod
    def full(shape, vx, vy, vz, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.full(shape, vx, dtype=dtype),
            jnp.full(shape, vy, dtype=dtype),
            jnp.full(shape, vz, dtype=dtype),
        )

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "Vec3":
        z = jnp.zeros(shape, dtype=dtype)
        return Vec3(z, z, z)

    @staticmethod
    def from_array(a, axis: int = -1) -> "Vec3":
        """Split an ``(..., 3)`` array into components."""
        parts = jnp.split(jnp.asarray(a), 3, axis=axis)
        sq = lambda p: jnp.squeeze(p, axis=axis)
        return Vec3(sq(parts[0]), sq(parts[1]), sq(parts[2]))

    def to_array(self, axis: int = -1):
        return jnp.stack([self.x, self.y, self.z], axis=axis)

    @staticmethod
    def const(vx, vy, vz, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.asarray(vx, dtype=dtype),
            jnp.asarray(vy, dtype=dtype),
            jnp.asarray(vz, dtype=dtype),
        )

    # ---- arithmetic ---------------------------------------------------
    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, o):
        """Scalar/array broadcast multiply, or elementwise Vec3*Vec3
        (reference: element-wise ``operator*`` global_launcher.cu:80-82)."""
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, s):
        return Vec3(self.x / s, self.y / s, self.z / s)

    # ---- geometry -----------------------------------------------------
    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self):
        return self.dot(self)

    def norm(self):
        return jnp.sqrt(self.norm2())

    def normalized(self) -> "Vec3":
        return self / self.norm()


def vwhere(mask, a: Vec3, b: Vec3) -> Vec3:
    """Per-lane select between two Vec3 batches."""
    return Vec3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def vgather(v: Vec3, idx) -> Vec3:
    """Gather components of a Vec3 table by integer index array."""
    return Vec3(v.x[idx], v.y[idx], v.z[idx])
