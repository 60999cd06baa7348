from raytracinggpu.core.vec import Vec3  # noqa: F401
from raytracinggpu.core.rays import RayBatch  # noqa: F401
