"""Batched ray-sphere intersection.

Replaces the per-object virtual ``Sphere::intersect``
(global_launcher.cu:122-135, cpu_launcher.cpp:512-527) with one dense
elementwise op over (sphere, ray) pairs — the scene holds at most ~10 spheres so the (S, R)
broadcast is tiny.

Semantics preserved exactly:
  delta = (u.(O-C))^2 - (|O-C|^2 - R^2); reject delta < 0
  t1 = u.(C-O) - sqrt(delta), t2 = u.(C-O) + sqrt(delta); reject t2 < 0
  t = t1 if t1 >= 0 else t2;  N = normalize(O + t u - C)
The linear min-t loop with ascending object ids and strict `<` comparison
(Scene::intersect_all, global_launcher.cu:716-736) means the *lowest id* wins
ties — jnp.argmin's first-occurrence rule reproduces that.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.vec import Vec3

INF = 1e9 + 9  # reference INF (global_launcher.cu:21)


class SphereTable(NamedTuple):
    """SoA table of spheres; components shaped (S,)."""

    cx: jnp.ndarray
    cy: jnp.ndarray
    cz: jnp.ndarray
    radius: jnp.ndarray

    @staticmethod
    def from_list(spheres) -> "SphereTable":
        """spheres: iterable of (center(3,), radius)."""
        c = np.array([s[0] for s in spheres], dtype=np.float32)
        r = np.array([s[1] for s in spheres], dtype=np.float32)
        return SphereTable(c[:, 0], c[:, 1], c[:, 2], r)


def intersect_spheres(O: Vec3, u: Vec3, tab: SphereTable):
    """Nearest sphere hit over the batch.

    Args:
      O, u: ray origins/directions, components (R,).
      tab: sphere table, components (S,).
    Returns:
      (t, obj_id, N): t (R,) = INF on miss; obj_id (R,) int32 = -1 on miss;
      N unit outward normal at the hit point.
    """
    # Broadcast (S, 1) against (R,) -> (S, R).
    C = Vec3(tab.cx[:, None], tab.cy[:, None], tab.cz[:, None])
    R2 = (tab.radius * tab.radius)[:, None]
    Ob = Vec3(O.x[None, :], O.y[None, :], O.z[None, :])
    ub = Vec3(u.x[None, :], u.y[None, :], u.z[None, :])

    oc = Ob - C  # O - C, (S, R)
    b = ub.dot(oc)  # u.(O-C)
    delta = b * b - (oc.norm2() - R2)
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    t1 = -b - sq  # u.(C-O) - sqrt(delta)
    t2 = -b + sq
    valid = (delta >= 0.0) & (t2 >= 0.0)
    t = jnp.where(t1 < 0.0, t2, t1)
    t = jnp.where(valid, t, INF)

    obj = jnp.argmin(t, axis=0).astype(jnp.int32)  # (R,)
    tmin = jnp.min(t, axis=0)
    hit = tmin < INF
    obj = jnp.where(hit, obj, -1)

    # Normal at hit: normalize(O + t u - C[winner]).
    cwin = Vec3(tab.cx[obj], tab.cy[obj], tab.cz[obj])
    p = O + u * tmin
    n = p - cwin
    # Avoid NaN on miss lanes; callers mask by obj >= 0.
    nn = jnp.where(hit, n.norm(), 1.0)
    N = n / nn
    return tmin, obj, N
