from .tracers import Tracers, compact_swarm  # noqa: F401
