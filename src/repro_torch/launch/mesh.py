"""Production mesh definitions (the port of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 cards.
Multi-pod:  (pod=2, data=16, model=16) = 512 cards — the ``pod`` axis is
the GraphHP partition axis for hybrid-sync training.

Meshes are ``torch.distributed`` ``DeviceMesh``es over the ranks of the
current process group; they are made by FUNCTIONS, so importing this
module starts no process group.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.sharding.util import use_mesh

__all__ = ["SINGLE_POD", "MULTI_POD", "PEAK_FLOPS_BF16", "PEAK_FLOPS_F32",
           "HBM_BW", "HBM_BYTES", "NVLINK_BW", "make_production_mesh",
           "make_host_mesh", "set_mesh"]

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)

# One NVIDIA H100 SXM at its 700 W power limit, NVIDIA's data sheet (dense
# rates, no sparsity); a card set below 700 W runs slower under load.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, outside the tensor cores
HBM_BW = 3.35e12                # bytes/s
HBM_BYTES = 80e9                # bytes
NVLINK_BW = 450e9               # bytes/s each way, to the host's other cards


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the current process group, which must have
    256 (512 with ``multi_pod``) ranks: real cards, or a ``fake`` group
    for the dry run (``device_type="cpu"``)."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A (data, model) mesh over the ranks of the current process group
    (every rank, so ``data * model`` must equal the world size) — for tests
    and the smoke's ranks."""
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    return _mesh(device_type, (data, model), ("data", "model"))


def set_mesh(mesh):
    """Context manager: ``mesh`` is the ambient mesh inside the block (what
    ``sharding.util.maybe_constrain`` and a ``decode_axis`` given by name
    read)."""
    return use_mesh(mesh)
