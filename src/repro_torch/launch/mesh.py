"""Production and host meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group.  Both build a ``torch.distributed``
``DeviceMesh`` over the default process group, which the caller has
initialised (``torchrun``, ``init_process_group`` with a store, or the dry
run's fake group), with the reference's axis names.  ``device_type`` is
``"cuda"`` unless the caller passes ``"cpu"`` (a gloo group) or ``"meta"``
(the dry run: a fake group, tensors that hold no memory).
"""

from __future__ import annotations


def production_shape(multi_pod: bool = False) -> tuple:
    """-> (mesh shape, axis names) of the single- or multi-pod mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _mesh(device_type: str, shape: tuple, names: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised default process group")
    world = dist.get_world_size()
    if world != _prod(shape):
        raise ValueError(f"mesh {shape} needs {_prod(shape)} ranks; the group has {world}")
    # the fake group of the dry run backs a "meta" mesh on the CPU device type
    return init_device_mesh("cpu" if device_type == "meta" else device_type, shape,
                            mesh_dim_names=names)


def _prod(shape) -> int:
    out = 1
    for n in shape:
        out *= n
    return out


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model")."""
    shape, names = production_shape(multi_pod)
    return _mesh(device_type, shape, names)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """(world // model, model) ("data", "model") over the initialised group:
    tests, the train CLI and the card's one-rank mesh."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model axis {model} does not divide the world of {world}")
    return _mesh(device_type, (world // model, model), ("data", "model"))
