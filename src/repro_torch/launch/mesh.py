"""Production mesh construction over a fake process group, and the card's
constants for the roofline.

Functions, not module-level state: importing this module touches no
``torch.distributed`` state (the serving and training paths never see a
process group); only the dry-run and its tests build one.

The meshes keep the reference's shapes and axis names, so every rules
table and every combo carries over: one pod = ``(data=16, model=16)``
= 256 ranks, two pods = ``(pod=2, data=16, model=16)`` = 512.  The ranks
are numbered row-major over the mesh, ``model`` the fastest-varying
axis, and placed ``RANKS_PER_NODE`` to a node (an HGX H100 board): a
16-way ``model`` group spans two nodes, a ``data`` or ``pod`` group one
rank of each of many.

The ranks live in one process: a ``torch.distributed`` group on the
``"fake"`` backend (``torch.testing._internal.distributed.fake_pg``),
whose collectives return at once and move nothing.  With fake tensors
(``FakeTensorMode``) a step runs on such a mesh as rank 0 would, shapes
only, so the dry-run reads rank 0's shards, collectives and memory.
"""
from __future__ import annotations

import math

# H100 80GB HBM3 (SXM5, 700 W), per GPU, NVIDIA's datasheet figures (not
# measurements): dense tensor-core bf16, float32 on the CUDA cores,
# the HBM3 rate, NVLink 4 (900 GB/s both ways, 450 GB/s each way, inside an HGX
# node of 8) and one ConnectX-7 InfiniBand NDR port a GPU (400 Gb/s =
# 50 GB/s each way) between nodes.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80 * 2**30
NVLINK_BYTES_PER_S = 450e9
IB_BYTES_PER_S = 50e9
RANKS_PER_NODE = 8

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def init_fake_world(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks,
    this process rank 0; an existing fake group of at least that many
    ranks is kept, any other group is replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() >= world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def make_mesh(shape, names):
    """A ``cpu`` DeviceMesh of ranks 0..prod(shape)-1, row-major, over the
    fake group (made or grown as needed)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    init_fake_world(n)
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    return make_mesh(*PRODUCTION_SHAPES[bool(multi_pod)])


def make_host_mesh(model_parallel: int = 1, data_parallel: int = 1):
    """A small ``(data, model)`` mesh for tests (1 x 1 by default)."""
    return make_mesh((data_parallel, model_parallel), ("data", "model"))


def link_bytes_per_s(ranks) -> float:
    """The rate of the slowest link a collective over ``ranks`` crosses:
    NVLink if every rank sits in one node, InfiniBand otherwise."""
    nodes = {r // RANKS_PER_NODE for r in ranks}
    return NVLINK_BYTES_PER_S if len(nodes) <= 1 else IB_BYTES_PER_S
