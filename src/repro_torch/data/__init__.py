from .pipeline import GrainSpec, MemmapSource, SyntheticSource, batch_from_grains, worker_batch

__all__ = ["GrainSpec", "MemmapSource", "SyntheticSource", "batch_from_grains", "worker_batch"]
