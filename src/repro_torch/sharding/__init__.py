from .policy import MeshAxes, Policy, to_placements

__all__ = ["MeshAxes", "Policy", "to_placements"]
