"""Production mesh factory, the counterpart of the JAX package's
``repro.launch.mesh``.

A function (not a module-level constant), so importing this module touches
no process group.  Single pod: 16 x 16 = 256 ranks over ("data",
"model"); multi-pod: 2 pods x 256 = 512 ranks with the leading "pod" axis.
The mesh is built over whatever process group the caller initialised, whose
world size must match.
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_dp_shards(mesh) -> int:
    """Total data-parallel shards (pod x data)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return sizes.get("pod", 1) * sizes.get("data", 1)


def describe(mesh) -> str:
    return "x".join(f"{n}={s}" for n, s in
                    zip(mesh.mesh_dim_names, mesh.shape))
