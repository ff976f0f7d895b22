"""Several devices on torch.distributed (port of
``vip_tpu.config.parallel``).

vip_tpu lays a cube's frame axis over a ``jax.sharding.Mesh`` and runs
``shard_map`` steps with XLA collectives. The port runs one process a
device (a rank) and maps each piece onto torch.distributed's own idiom:

- ``Mesh`` → a 1-D ``torch.distributed.device_mesh.DeviceMesh`` over the
  ranks of the default process group (:func:`frame_mesh`); its
  ``mesh_dim_names`` are vip_tpu's ``axis_names``;
- ``device_put(x, NamedSharding(mesh, P(axis)))`` → a ``DTensor`` with a
  ``Shard(dim)`` placement (:func:`shard_cube`), whose ``to_local()`` is
  this rank's slab;
- ``shard_map`` → the step called on the local slabs
  (:func:`sharded_frame_map`, :func:`local_slab`);
- ``lax.all_gather(tiled=True)`` / ``psum`` / ``all_to_all(tiled=True)`` /
  ``axis_index`` → :func:`all_gather`, :func:`all_reduce`,
  :func:`all_to_all` and ``mesh.get_local_rank()`` on the mesh's group;
- ``jax.jit`` → nothing: PyTorch runs eagerly;
- ``chunked_vmap`` (``lax.map`` with ``batch_size``) →
  ``torch.func.vmap(fun, chunk_size=batch_size)``.

Process groups. :func:`frame_mesh` uses the default process group when
one is initialized: ``torchrun --nproc-per-node N`` on N cards (NCCL), or
gloo ranks spawned by the caller (``vip_tpu_torch.dryrun``). With no group
and no launcher's ``RANK``/``WORLD_SIZE`` it starts a one-rank group on
the port's device (``config.get_device()``): NCCL for a card, gloo for
the CPU. The backend follows the device by name; nothing tries one
backend and retries another.

The helpers below hand both backends the tensors where they lie: gloo
takes CUDA tensors for ``all_gather_into_tensor``, ``all_reduce`` and
``all_to_all_single`` (it stages them through the host itself; checked
on an H100 with torch 2.11), so several gloo ranks may share one card.
"""

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from .device import as_tensor, get_device

__all__ = [
    "chunked_vmap",
    "frame_mesh",
    "shard_cube",
    "device_put_sharded_frames",
    "sharded_frame_map",
]

#: Timeout of the process groups the port starts itself.
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def chunked_vmap(fun, batch_size=None):
    """Vectorize ``fun`` over the leading axis of its arguments,
    ``batch_size`` elements at a time to bound peak device memory
    (vip_tpu parallel.py:33). ``torch.func.vmap(fun)`` when ``batch_size``
    is None, else ``torch.func.vmap(fun, chunk_size=batch_size)``."""
    if batch_size is None:
        return torch.func.vmap(fun)
    return torch.func.vmap(fun, chunk_size=int(batch_size))


def free_port():
    """A TCP port of localhost that no socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device):
    """The process-group backend of ``device``: "nccl" for a card, "gloo"
    for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def ensure_group():
    """Initialize the default process group if none is: from a launcher's
    ``RANK``/``WORLD_SIZE`` (``env://``, each rank on the card of its
    ``LOCAL_RANK``), else one rank on the port's device. Returns the
    world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    dev = get_device()
    backend = backend_for(dev)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda" and dev.index is None:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, timeout=GROUP_TIMEOUT)
    else:
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1, timeout=GROUP_TIMEOUT)
    return dist.get_world_size()


def frame_mesh(n_devices=None, axis_name="frames", devices=None):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over which cube frame axes
    are sharded (vip_tpu parallel.py:53).

    ``devices``: the global ranks of the mesh (default: every rank of the
    default group, which :func:`ensure_group` starts if needed);
    ``n_devices``: keep the first ones. Every rank of the default group
    must call this, in the same order: the mesh may create a group."""
    from torch.distributed.device_mesh import DeviceMesh

    world = ensure_group()
    ranks = list(range(world)) if devices is None \
        else [int(d) for d in devices]
    if n_devices is not None:
        ranks = ranks[:n_devices]
    return DeviceMesh(get_device().type, torch.tensor(ranks),
                      mesh_dim_names=(axis_name,))


def all_gather(x, mesh):
    """Every rank's ``x`` concatenated along dim 0 in rank order
    (``lax.all_gather(x, axis, tiled=True)``)."""
    x = x.detach().contiguous()
    out = x.new_empty((mesh.size() * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=mesh.get_group())
    return out


def all_reduce(x, mesh):
    """The sum of every rank's ``x`` (``lax.psum``), a new tensor."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.get_group())
    return out


def all_to_all(x, mesh, split_axis, concat_axis):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x``'s ``split_axis`` is cut into one block a rank, block j goes to
    rank j, and the blocks received are concatenated along
    ``concat_axis`` in rank order."""
    W = mesh.size()
    shape = list(x.shape)
    if shape[split_axis] % W:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(shape)} "
                         f"does not divide over {W} ranks")
    send = x.detach().movedim(split_axis, 0)
    send = send.reshape((W, shape[split_axis] // W) + send.shape[1:])
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group())
    # recv[i] is rank i's block: back to x's layout, then rank-major along
    # concat_axis
    recv = recv.movedim(1, split_axis + 1)
    shape[split_axis] //= W
    shape[concat_axis] *= W
    return recv.movedim(0, concat_axis).reshape(shape)


def _chunk_bounds(n, W, r):
    """Rows of rank r when n rows are cut as ``torch.chunk`` cuts them
    (DTensor's ``Shard``)."""
    c = -(-n // W)
    return min(r * c, n), min((r + 1) * c, n)


def local_slab(x, mesh, dim=0, device=None, dtype=None):
    """This rank's slab of ``x`` along ``dim``: a ``DTensor``'s local
    tensor, or this rank's equal part of a global array or tensor (a
    numpy array is cut on the host, then only the slab moves to
    ``device``, default the port's). Raises where ``dim`` does not divide
    over the mesh."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.to_local().to(device=device, dtype=dtype)
    W, r = mesh.size(), mesh.get_local_rank()
    n = x.shape[dim]
    if n % W:
        raise ValueError(f"axis {dim} of length {n} must divide evenly over "
                         f"{W} devices")
    k = n // W
    index = (slice(None),) * (dim % x.ndim) + (slice(r * k, (r + 1) * k),)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return as_tensor(x[index], device, dtype)


def replicated(x, device=None, dtype=None):
    """The full value of a replicated argument on ``device``: a
    ``DTensor``'s local tensor (``Replicate()``), or the array or tensor
    itself, under the port's dtype policy."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.to_local()
    return as_tensor(x, device, dtype)


def from_local(local, mesh, dim=0):
    """A ``DTensor`` sharded along ``dim`` (``Shard(dim)``) whose slab on
    this rank is ``local``; every rank's slab has the same shape."""
    from torch.distributed.tensor import DTensor, Shard

    shape = list(local.shape)
    shape[dim] *= mesh.size()
    return DTensor.from_local(local, mesh, [Shard(dim)], run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _placement(spec):
    """A placement (``Shard(d)``, ``Replicate()``) as it is, a dim as
    ``Shard(dim)``, None as ``Shard(0)``."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import Placement

    if spec is None:
        return Shard(0)
    if isinstance(spec, Placement):
        return spec
    return Shard(int(spec))


def shard_cube(cube, mesh, axis_name=None, spec=None):
    """Place ``cube`` on ``mesh`` sharded along its leading (frame) axis,
    or as ``spec`` says: a placement (``Shard(d)``, ``Replicate()``) or a
    dim (vip_tpu parallel.py:71). Returns a ``DTensor``; each rank holds
    only its slab (``torch.chunk``'s cut: ceil-sized blocks). Numpy input
    is cut on the host and goes to the port's device under its dtype
    policy. ``axis_name`` names the mesh dim, which must be the mesh's
    one dim."""
    from torch.distributed.tensor import DTensor, Shard

    if axis_name is not None and axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"axis {axis_name!r} is not a dim of the mesh "
                         f"{mesh.mesh_dim_names}")
    place = _placement(spec)
    if not isinstance(cube, torch.Tensor):
        cube = np.asarray(cube)
    shape = tuple(cube.shape)
    dev = get_device() if not isinstance(cube, torch.Tensor) \
        or cube.device.type != mesh.device_type else cube.device
    if isinstance(place, Shard):
        d = place.dim % len(shape)
        lo, hi = _chunk_bounds(shape[d], mesh.size(), mesh.get_local_rank())
        local = cube[(slice(None),) * d + (slice(lo, hi),)]
    else:
        local = cube
    local = as_tensor(local, dev).contiguous()
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, [place], run_check=False,
                              shape=torch.Size(shape), stride=stride)


def device_put_sharded_frames(cube, mesh=None):
    """Shard ``cube`` over every rank along frames (vip_tpu
    parallel.py:79)."""
    if mesh is None:
        mesh = frame_mesh()
    return shard_cube(cube, mesh)


def sharded_frame_map(fun, mesh, axis_name="frames", out_specs=None):
    """``fun`` over the local frame slabs of its arguments (vip_tpu
    parallel.py:86, ``shard_map``): each argument (a ``DTensor``, or a
    global array or tensor cut by :func:`local_slab`) reaches ``fun`` as
    this rank's block, and ``fun`` may call :func:`all_reduce`,
    :func:`all_gather` and :func:`all_to_all` on ``mesh``. The result is
    sharded along frames (a ``DTensor``, ``Shard(0)``) unless
    ``out_specs`` says otherwise: ``Replicate()`` returns ``fun``'s tensor
    as it is, every rank holding the same."""
    from torch.distributed.tensor import Replicate

    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"axis {axis_name!r} is not a dim of the mesh "
                         f"{mesh.mesh_dim_names}")
    place = _placement(out_specs)

    def mapped(*args):
        out = fun(*(local_slab(a, mesh) for a in args))
        if isinstance(place, Replicate):
            return out
        return from_local(out, mesh, place.dim)

    return mapped


def tree_to_numpy(tree):
    """A nested list, tuple or dict with every tensor pulled back to host
    numpy (vip_tpu parallel.py:102); other leaves stay as they are."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)
