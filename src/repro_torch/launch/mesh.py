"""Production meshes, and the card's figures for the dry run's roofline.

Port of ``repro/launch/mesh.py``.  Functions, not constants: importing this
module sets up no process group.  ``make_production_mesh`` and
``make_debug_mesh`` build a ``torch.distributed`` ``DeviceMesh`` on the
process group the caller has set up (its world size must be the mesh's
size).  ``MeshShape`` is the shape alone (axis names and sizes): the
sharding policy builds its specs from it with no process group and no
device, as the reference's tests build theirs from a stand-in mesh.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["MeshShape", "production_mesh_shape", "debug_mesh_shape",
           "make_production_mesh", "make_debug_mesh", "make_mesh", "HW"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, major axis first."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @staticmethod
    def of(mesh) -> "MeshShape":
        """The shape of a ``MeshShape`` or a ``DeviceMesh``."""
        if isinstance(mesh, MeshShape):
            return mesh
        return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    """16 x 16 = 256 devices a pod; ``multi_pod`` adds the 2-pod outer
    axis."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def debug_mesh_shape(n_data: int = 2, n_model: int = 4) -> MeshShape:
    return MeshShape(("data", "model"), (n_data, n_model))


def make_mesh(shape: MeshShape, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` on the default process group, on
    ``device_type`` ("cuda" unless given).  Without a ``device_type`` and
    without CUDA it raises, as the port's entry points do
    (``device.resolve_device``): a mesh on the CPU is asked for by name."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device

    device_type = resolve_device(device_type).type
    return init_device_mesh(device_type, shape.sizes,
                            mesh_dim_names=shape.axis_names)


def make_production_mesh(multi_pod: bool = False, device_type=None):
    return make_mesh(production_mesh_shape(multi_pod), device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, device_type=None):
    """Small mesh for subprocess tests (world size ``n_data * n_model``)."""
    return make_mesh(debug_mesh_shape(n_data, n_model), device_type)


#: One NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit: the roofline
#: terms of ``launch/dryrun.py`` divide by these.
HW = {
    # bf16 dense tensor-core peak, without sparsity (NVIDIA H100 data
    # sheet, SXM5 column: 1,979 TFLOP/s with sparsity).
    "peak_flops_bf16": 989e12,   # FLOP/s
    # HBM3 bandwidth (NVIDIA H100 data sheet, SXM5: 3.35 TB/s).
    "hbm_bw": 3.35e12,           # B/s
    # NVLink 4: 900 GB/s a GPU over 18 links, both directions together
    # (NVIDIA H100 data sheet, SXM5), so 450 GB/s each way.
    "nvlink_bw": 450e9,          # B/s a GPU, one direction
}
