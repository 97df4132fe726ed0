# -*- coding: utf-8 -*-
"""Tensor parallelism over the mesh's 'model' axis.

The JAX package splits every parameter that ``param_spec`` picks along its
last (flax) dimension over the 'model' devices, and GSPMD computes the same
function over the split. The port does the splitting itself, on one
tensor-parallel group: a row ``mesh.devices[d, :]`` of the mesh, whose
first device holds the replica's activations.

- Shard ``i`` of a split leaf lies on the group's device ``i`` and holds
  consecutive slice ``i`` of the flax last dimension, which is what JAX's
  ``shard_params`` puts on 'model' index ``i``. In the port's layout
  (``model/params.py``) that is dimension ``split_dim(perm)``: 0 for a
  Linear, a Conv1d and the LSTM gates; 1 for a ConvTranspose1d's output
  channels and for the alphas ``[1, C, 1]``; the last where the port keeps
  flax's layout (an Embedding, a LayerNorm, a bias).
- Column-parallel compute (``ColumnParallel``) where the split dimension is
  the output of a matmul or a dense conv: ``nn.Linear``, ``nn.Embedding``,
  and ``Conv1d``/``ConvTranspose1d`` with ``groups == 1``. Shard ``i``
  computes its output channels from the whole input on its device, and the
  slices are concatenated on the input's device; autograd carries the
  gradient back through the copies. The fused AdaIN + snake + conv steps of
  ``AdaSnakeResBlock`` take these convs too: each shard launches the fused
  kernel on its own device (``model/layers.py``).
- Gathered at use for the rest (``Gathered``, ``SplitParameter``):
  LayerNorms, the LSTMs (the recurrence needs every gate of ``h`` at each
  step), the depthwise pool and the fused convs' alphas (read on the input
  side). Their slices are concatenated onto the input's device at every
  call, as GSPMD all-gathers a parameter whose consumer needs it whole.

``tensor_parallel`` raises NotImplementedError for a split leaf that is
neither, so that nothing computes on a slice by mistake, and ValueError,
as JAX's ``device_put`` does, for a split dimension that the group's size
does not divide.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..model.layers import AdaSnakeResBlock
from ..model.params import _flax_shape, _leaf_specs

# nn.LSTM's one-layer, one-direction weights in the order torch.lstm takes
_LSTM_WEIGHTS = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")


class SplitLeaf(NamedTuple):
    """A split leaf of a tensor-parallel model: its flax path (under
    "params"), the flax-to-port permutation (``model/params.py``), the
    port dimension it is split along, and its shards in group order."""

    path: Tuple[str, ...]
    perm: Optional[Tuple[int, ...]]
    dim: int
    shards: List[nn.Parameter]


def split_dim(perm: Optional[Sequence[int]], ndim: int) -> int:
    """The port dimension that holds the flax last dimension."""
    return ndim - 1 if perm is None else list(perm).index(ndim - 1)


def split_leaf(t: torch.Tensor, dim: int, n: int) -> List[torch.Tensor]:
    """``t`` as ``n`` equal consecutive slices along ``dim`` (views).
    Raises ValueError where ``n`` does not divide the dimension."""
    if t.shape[dim] % n:
        raise ValueError(
            f"the {n}-way 'model' axis implies that the size of dimension "
            f"{dim} should be divisible by {n}, but it is equal to "
            f"{t.shape[dim]} (full shape: {tuple(t.shape)})")
    return list(t.chunk(n, dim))


def gather_leaf(parts: Sequence[torch.Tensor], dim: int,
                device) -> torch.Tensor:
    """The slices concatenated along ``dim`` on ``device`` (differentiable:
    the copies carry gradients back to each slice's device)."""
    return torch.cat([p.to(device) for p in parts], dim)


def _on(t: torch.Tensor, device) -> nn.Parameter:
    """A contiguous copy of ``t`` on ``device`` as a parameter that trains
    where ``t`` did."""
    return nn.Parameter(
        t.detach().to(device, copy=True,
                      memory_format=torch.contiguous_format),
        requires_grad=t.requires_grad)


class SplitParameter(nn.Module):
    """A parameter held as slices along ``dim``, one on each device of the
    group; ``module(device)`` is the whole tensor gathered there."""

    def __init__(self, t: torch.Tensor, dim: int, devices: Sequence):
        super().__init__()
        self.dim = dim
        self.shards = nn.ParameterList(
            _on(part, dev)
            for part, dev in zip(split_leaf(t, dim, len(devices)), devices))

    def forward(self, device) -> torch.Tensor:
        return gather_leaf(list(self.shards), self.dim, device)


def _narrowed(module: nn.Module, width: int) -> nn.Module:
    """A module of ``module``'s kind and geometry with ``width`` outputs,
    its parameters on the meta device."""
    bias = getattr(module, "bias", None) is not None
    with torch.device("meta"):
        if isinstance(module, nn.Linear):
            return nn.Linear(module.in_features, width, bias=bias)
        if isinstance(module, nn.Embedding):
            return nn.Embedding(module.num_embeddings, width)
        if isinstance(module, nn.ConvTranspose1d):
            return nn.ConvTranspose1d(
                module.in_channels, width, module.kernel_size, module.stride,
                module.padding, module.output_padding, bias=bias,
                dilation=module.dilation)
        return nn.Conv1d(module.in_channels, width, module.kernel_size,
                         module.stride, module.padding, module.dilation,
                         bias=bias)


def _column_kind(module: nn.Module, dims: Dict[str, int]) -> bool:
    """Whether ``module`` computes column-parallel with ``dims`` split:
    a Linear, an Embedding or a dense conv whose parameters all split."""
    if set(dims) != {name for name, _ in module.named_parameters()}:
        return False
    if isinstance(module, (nn.Linear, nn.Embedding)):
        return True
    return isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)) and (
        module.groups == 1)


class ColumnParallel(nn.Module):
    """``module`` (a Linear, an Embedding, or a Conv1d/ConvTranspose1d with
    ``groups == 1``) with its outputs split over the group: ``shards[i]``,
    a module of the same kind on device ``i``, computes output channels
    ``[i C / n, (i + 1) C / n)`` from the whole input, and the forward
    concatenates them on the input's device (channels last for a Linear or
    an Embedding, dimension 1 for a conv). ``dims``: parameter -> the port
    dimension it splits along."""

    def __init__(self, module: nn.Module, dims: Dict[str, int],
                 devices: Sequence):
        super().__init__()
        n = len(devices)
        parts = {name: split_leaf(getattr(module, name), dim, n)
                 for name, dim in dims.items()}
        width = parts["weight"][0].shape[dims["weight"]]
        self.out_dim = -1 if isinstance(module, (nn.Linear,
                                                 nn.Embedding)) else 1
        self.shards = nn.ModuleList()
        for i, dev in enumerate(devices):
            shard = _narrowed(module, width)
            for name in dims:
                setattr(shard, name, _on(parts[name][i], dev))
            self.shards.append(shard.train(module.training))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gather_leaf([s(x.to(s.weight.device)) for s in self.shards],
                           self.out_dim, x.device)


class Gathered(nn.Module):
    """``module`` (a LayerNorm, a depthwise ConvTranspose1d, or a one-layer
    batch-first nn.LSTM) with its split parameters held as
    ``SplitParameter``s in ``split`` and concatenated onto the input's
    device at every call; ``module`` keeps its other parameters (an LSTM's
    ``bias_hh_l0``). The LSTM runs as ``nn.LSTM.forward`` runs it, on the
    gathered weights."""

    def __init__(self, module: nn.Module, dims: Dict[str, int],
                 devices: Sequence):
        super().__init__()
        self.split = nn.ModuleDict()
        for name, dim in dims.items():
            self.split[name] = SplitParameter(getattr(module, name), dim,
                                              devices)
            delattr(module, name)
        if isinstance(module, nn.LSTM):
            # drop its references to the whole weights (they are now None)
            module._init_flat_weights()
        self.module = module

    def forward(self, x: torch.Tensor):
        m = self.module
        p = {name: s(x.device) for name, s in self.split.items()}
        if isinstance(m, nn.LayerNorm):
            return F.layer_norm(x, m.normalized_shape, p["weight"],
                                p["bias"], m.eps)
        if isinstance(m, nn.ConvTranspose1d):
            return F.conv_transpose1d(x, p["weight"], p["bias"], m.stride,
                                      m.padding, m.output_padding, m.groups,
                                      m.dilation)
        weights = [p[n] if n in p else getattr(m, n) for n in _LSTM_WEIGHTS]
        h0 = x.new_zeros(1, x.shape[0], m.hidden_size)
        out, h, c = torch.lstm(x, (h0, h0), weights, True, 1, 0.0,
                               self.training, False, True)
        return out, (h, c)


def _gathered_kind(module: nn.Module) -> bool:
    if isinstance(module, nn.LSTM):
        return (module.num_layers == 1 and not module.bidirectional
                and module.batch_first and module.proj_size == 0)
    if isinstance(module, nn.ConvTranspose1d):
        return module.groups == module.in_channels == module.out_channels
    return isinstance(module, nn.LayerNorm)


def split_plan(model: nn.Module, n_model: int
               ) -> Dict[str, Tuple[Tuple[str, ...], Optional[tuple], int]]:
    """Port parameter name -> (flax path, perm, port dimension) of every
    leaf of ``model`` that ``param_spec`` splits over 'model'. Raises
    ValueError for a split dimension that ``n_model`` does not divide."""
    from .mesh import param_spec  # mesh.py imports this module

    params = dict(model.named_parameters())
    plan = {}
    for name, path, perm in _leaf_specs(model)[0]:
        shape = _flax_shape(tuple(params[name].shape), perm)
        if "model" not in param_spec("/".join(("params",) + path), shape):
            continue
        if shape[-1] % n_model:
            raise ValueError(
                f"{'/'.join(path)}: the {n_model}-way 'model' axis implies "
                f"that the global size of its dimension {len(shape) - 1} "
                f"should be divisible by {n_model}, but it is equal to "
                f"{shape[-1]} (full shape: {shape})")
        plan[name] = (path, perm, split_dim(perm, len(shape)))
    return plan


def tensor_parallel(model: nn.Module, devices: Sequence) -> nn.Module:
    """``model`` (a ``KokoroModel`` on ``devices[0]``) made the compute
    model of one tensor-parallel group, in place: every leaf ``param_spec``
    splits is held as ``len(devices)`` shards, shard ``i`` on
    ``devices[i]``, in the column-parallel or gathered form above; the
    other parameters stay on ``devices[0]``. ``model.split_leaves`` maps
    each split leaf's port name to its ``SplitLeaf``. One device: ``model``
    as it is. Raises ValueError (an indivisible split) or
    NotImplementedError (a split leaf of a layer with neither form) before
    anything changes."""
    devices = [torch.device(d) for d in devices]
    model.split_leaves = {}
    if len(devices) == 1:
        return model
    plan = split_plan(model, len(devices))
    owners: Dict[str, Dict[str, int]] = {}
    for name, (_, _, dim) in plan.items():
        owner, _, attr = name.rpartition(".")
        owners.setdefault(owner, {})[attr] = dim
    forms = {}
    for owner, dims in owners.items():
        module = model.get_submodule(owner)
        if _column_kind(module, dims):
            forms[owner] = ColumnParallel
        elif _gathered_kind(module):
            forms[owner] = Gathered
        elif isinstance(module, AdaSnakeResBlock) and all(
                re.fullmatch(r"alpha[12]_\d+", a) for a in dims):
            forms[owner] = SplitParameter
        else:
            raise NotImplementedError(
                f"{owner} ({type(module).__name__}): split leaves "
                f"{sorted(dims)} have no tensor-parallel form")
    shards: Dict[str, List[nn.Parameter]] = {}
    for owner, dims in owners.items():
        module, form = model.get_submodule(owner), forms[owner]
        if form is SplitParameter:
            for attr, dim in dims.items():
                split = SplitParameter(getattr(module, attr), dim, devices)
                delattr(module, attr)
                module.add_module(attr, split)
                shards[f"{owner}.{attr}"] = list(split.shards)
            continue
        new = form(module, dims, devices)
        parent, _, child = owner.rpartition(".")
        setattr(model.get_submodule(parent), child, new)
        for attr in dims:
            shards[f"{owner}.{attr}"] = (
                [getattr(s, attr) for s in new.shards]
                if form is ColumnParallel else list(new.split[attr].shards))
    model.split_leaves = {
        name: SplitLeaf(path, perm, dim, shards[name])
        for name, (path, perm, dim) in plan.items()}
    for block in model.modules():
        if isinstance(block, AdaSnakeResBlock):
            block._packed.clear()  # keyed by the convs, now shards
    return model
