# -*- coding: utf-8 -*-
"""Device mesh and sharding rules (PyTorch port of
``illufly_tts_tpu/parallel/mesh.py``).

The JAX package runs data parallelism from one controller: one process
holds a ``Mesh`` of chips, and GSPMD splits each compiled program over it.
The port keeps the one process and the JAX names, and does the splitting
itself:

- batch (data) parallelism over the 'data' axis: one model replica per
  'data' device (``shard_params``); each padded batch is split row-wise
  into equal shards (``batch_sharding(mesh).place``), each replica runs its
  shard on its own device, and the results are gathered (``gather``);
- tensor parallelism over 'model': ``param_spec``/``param_shardings`` name
  the last-dim split of the wide matmuls and convs as the JAX rules do, and
  each 'data' index holds one tensor-parallel group, the row
  ``mesh.devices[d, :]``: its replica's activations live on the row's first
  device, and each split leaf is held as one slice per device of the row
  and computed column-parallel or gathered at use (``parallel/tensor.py``).

A mesh's devices are ``torch.device``s. Unlike a JAX mesh, which holds
each chip once, the list may repeat a device: ``make_mesh(n_data=8,
devices=[torch.device("cpu")] * 8)`` is an 8-way axis on the CPU,
``devices=[torch.device("cuda:0")] * 2`` two replicas on one card, and
``make_mesh(2, 2, devices=[torch.device("cuda:0")] * 4)`` two replicas of
two shards each on it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..model.kokoro import KokoroModel
from ..model.params import flax_shapes
from .tensor import split_leaf, tensor_parallel

AXES = ("data", "model")


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: per dimension, the mesh axis it is
    split over or None; ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


P = PartitionSpec


class Mesh:
    """A grid of devices over the axes ('data', 'model'): ``devices`` a
    [n_data, n_model] object array, ``shape`` ``{"data": n_data, "model":
    n_model}`` as JAX's ``Mesh.shape`` reads."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        """One device per 'data' index (the first along 'model')."""
        return list(self.devices[:, 0])

    @property
    def groups(self) -> List[List[torch.device]]:
        """One tensor-parallel group per 'data' index: its row of devices
        along 'model'."""
        return [list(row) for row in self.devices]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


def cuda_devices() -> List[torch.device]:
    """Every CUDA device of this host; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: make_mesh spans the host's cards; pass "
            "devices=[torch.device('cpu')] * n to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over the first ``n_data * n_model`` of
    ``devices`` (default: every CUDA device). ``n_data`` defaults to as many
    as the devices give. Raises AssertionError, as the JAX function's assert
    does, when the devices are too few."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else cuda_devices())]
    total = len(devices)
    if n_data is None:
        n_data = total // n_model
    if not n_data * n_model <= total:
        raise AssertionError(
            f"{(n_data, n_model, total)}: a {n_data} x {n_model} mesh needs "
            f"{n_data * n_model} devices; {total} given")
    grid = np.empty((n_data, n_model), dtype=object)
    for i, dev in enumerate(devices[: n_data * n_model]):
        grid[i // n_model, i % n_model] = dev
    return Mesh(grid)


# parameter-name patterns that carry the tensor-parallel (last-dim) shard
_TP_PATTERNS = [
    r"ffn_in", r"ffn_out", r"qkv", r"attn_out",          # ALBERT
    r"bert_encoder",                                     # 768 -> 512
    r"duration_proj",
    r"conv1$", r"conv2$", r"conv1x1", r"encode", r"decode_\d+",
    r"up_\d+", r"res_\d+_\d+", r"noise_conv", r"noise_res",
]


def param_spec(path: str, shape) -> PartitionSpec:
    """Partition rule for one parameter: ``path`` its '/'-joined flax names
    (``model/params.py`` maps each port parameter to one), ``shape`` its
    flax shape."""
    if len(shape) == 0:
        return P()
    last = shape[-1]
    if last < 128 or last % 2 != 0:
        return P()
    if any(re.search(pat, path) for pat in _TP_PATTERNS):
        return P(*([None] * (len(shape) - 1) + ["model"]))
    return P()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: ``spec`` over ``mesh``. ``place``
    puts a tensor on the mesh's devices."""

    mesh: Mesh
    spec: PartitionSpec

    def place(self, x: torch.Tensor) -> list:
        """``x`` per 'data' index: rows split into equal consecutive
        shards for ``P("data")``, whole for ``P()``, on the index's first
        device. Where the spec names 'model' at a dimension, each entry is
        instead the list of its consecutive slices along that dimension,
        slice ``i`` on the group's device ``i``. A dimension that does not
        divide its axis raises ValueError, as JAX's ``device_put`` does."""
        devices = self.mesh.data_devices
        rows = [x] * len(devices)
        if self.spec and self.spec[0] == "data":
            n = len(devices)
            if x.shape[0] % n:
                raise ValueError(
                    f"leading dim {x.shape[0]} does not divide the {n}-way "
                    "'data' mesh axis")
            rows = list(x.chunk(n))
        if "model" not in self.spec:
            return [r.to(dev, non_blocking=True)
                    for r, dev in zip(rows, devices)]
        dim = self.spec.index("model")
        return [[part.to(dev, non_blocking=True) for part, dev in zip(
            split_leaf(r, dim, len(group)), group)]
            for r, group in zip(rows, self.mesh.groups)]


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading batch dim over 'data'."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_shardings(model, mesh: Mesh) -> dict:
    """Sharding tree of ``model`` (a ``KokoroModel``) read as its flax
    tree (``model/params.py``'s paths, from "params" down): one
    ``NamedSharding`` per leaf, with the leaf's ``param_spec``."""
    root: dict = {"params": {}}
    for path, shape in flax_shapes(model).items():
        node = root["params"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = NamedSharding(
            mesh, param_spec("/".join(("params",) + path), shape))
    return root


def shard_params(model, mesh: Mesh, dtype: Optional[torch.dtype] = None
                 ) -> list:
    """The port's placement of ``model`` (a ``KokoroModel``) on the mesh:
    one compute model per 'data' index, computing in ``dtype`` (default
    ``model.config.dtype``) and filled from ``model``'s weights (a
    bfloat16 one keeps ``KokoroModel``'s float32 islands). With a 'model'
    axis above 1 each is tensor-parallel over its group
    (``tensor_parallel``); a split dimension the axis does not divide
    raises ValueError, as JAX's ``shard_params`` does. A 1-device group on
    ``model``'s own device and dtype is ``model`` itself for the first
    'data' index; every other compute model is a copy, in eval mode
    without gradients."""
    dtype = dtype or model.config.dtype
    home = next(model.parameters()).device
    return [model if i == 0 and group == [home]
            and model.config.dtype == dtype
            else tensor_parallel(compute_copy(model, dtype, group[0]), group)
            for i, group in enumerate(mesh.groups)]


def compute_copy(model, dtype: torch.dtype, device) -> torch.nn.Module:
    """A ``KokoroModel`` of ``model``'s config in ``dtype`` on ``device``,
    filled from ``model`` (each parameter cast to its own dtype), in eval
    mode without gradients."""
    with torch.device("meta"):
        net = KokoroModel(dataclasses.replace(model.config, dtype=dtype))
    net = net.to_empty(device=device)
    net.load_state_dict(model.state_dict())
    return net.eval().requires_grad_(False)


def gather(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Shards gathered row-wise onto ``device`` (differentiable: the copies
    carry gradients back to each shard's device)."""
    return torch.cat([p.to(device) for p in parts])

