# -*- coding: utf-8 -*-
"""Float32 master weights and the compute replicas that train on them.

The JAX trainer holds one float32 parameter tree: a bfloat16 model casts
it at every use (flax's ``param_dtype`` float32, ``dtype`` bfloat16), and
under a mesh GSPMD runs the step over the batch's shards and reduces the
gradients. The port's counterpart is ``Replicas``:

- ``master``: a float32 ``KokoroModel``, whole on the mesh's first device:
  the weights the optimizer steps, the clip reads and checkpoints hold. The
  optimizer's state is whole too (JAX splits adamw's ``mu``/``nu`` as it
  splits the parameters: memory only, the same function);
- ``models``: one compute model per 'data' index of the mesh (one without
  a mesh), in the config's dtype, tensor-parallel over the index's group
  where the 'model' axis exceeds 1 (``parallel/tensor.py``). A float32
  model on one device is its own master and only replica: nothing is
  copied and the step is the plain one. A bfloat16 model is the first
  replica on a 'data'-only mesh, and its master float32: filled from the
  float32 weights where the caller gives them (``master=``, as the JAX
  trainer steps its float32 ``params``), else a copy of the model's own
  (rounded to bfloat16 but for its float32 islands);
- ``map``: a function of (model, batch) run on each replica's rows of the
  batch, its outputs gathered row-wise onto the master's device, so that a
  loss computed on them is the whole batch's and one ``backward`` reaches
  every replica;
- ``reduce_grads``: each replica's gradients summed into the master's, in
  float32, a split leaf's shard gradients concatenated first; ``sync``: the
  master's weights copied back into every replica (each shard its slice,
  rounded to bfloat16 where the replica computes in it), and into
  ``model`` where it is neither master nor replica (a bfloat16 model on a
  'model' axis).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..model.params import load_flax_params, trainable_parameters
from .mesh import (
    Mesh,
    batch_sharding,
    compute_copy,
    gather,
    make_mesh,
)
from .tensor import (
    SplitLeaf,
    gather_leaf,
    split_leaf,
    tensor_parallel,
)


class Replicas:
    def __init__(self, model, mesh: Optional[Mesh] = None, master=None):
        """``model``: a ``KokoroModel`` (float32 or bfloat16) on the mesh's
        first device; ``mesh``: None for ``model``'s device alone.
        ``master``: the float32 weights a bfloat16 model's master starts
        from, a float32 ``KokoroModel`` (copied) or a flax-layout tree;
        every replica, ``model`` among them, then computes on them rounded.
        None: the master is a copy of ``model``'s own weights. A float32
        model is its own master and takes none (ValueError)."""
        home = next(model.parameters()).device
        self.mesh = mesh if mesh is not None else make_mesh(
            n_data=1, devices=[home])
        self.config = model.config
        self.dtype = model.config.dtype
        if self.dtype == torch.float32:
            if master is not None:
                raise ValueError("a float32 model is its own master: load "
                                 "the weights into it instead")
            self.master = model
        elif isinstance(master, torch.nn.Module):
            self.master = compute_copy(master, torch.float32, home)
        else:
            self.master = compute_copy(model, torch.float32, home)
            if master is not None:
                load_flax_params(self.master, master)
        self.devices = self.mesh.data_devices
        self.models: List[torch.nn.Module] = [
            model if i == 0 and group == [home]
            else tensor_parallel(compute_copy(self.master, self.dtype,
                                              group[0]), group)
            for i, group in enumerate(self.mesh.groups)]
        # the caller's model, kept in step where it is no replica
        self._own = (model if model is not self.master
                     and model not in self.models else None)
        self.params = trainable_parameters(self.master)
        names = {id(p): name for name, p in self.master.named_parameters()}
        self._replica_params = [
            None if m is self.master else self._leaves(
                m, [names[id(p)] for p in self.params])
            for m in self.models]
        if master is not None:
            self.sync()

    @staticmethod
    def _leaves(net, names) -> list:
        """Per trainable name: ``net``'s parameter, or its ``SplitLeaf``
        where ``net`` is tensor-parallel; each set to train."""
        split = getattr(net, "split_leaves", {})
        if not split:
            params = trainable_parameters(net)
        else:
            own = dict(net.named_parameters())
            params = [split.get(name) or own[name] for name in names]
        for leaf in params:
            for p in (leaf.shards if isinstance(leaf, SplitLeaf) else [leaf]):
                p.requires_grad_(True)
        return params

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def train(self, mode: bool = True) -> None:
        for m in self.models:
            m.train(mode)

    def map(self, fn: Callable, batch):
        """``fn(model, batch)`` on each replica's shard of ``batch`` (a
        tuple of tensors with the batch leading), each output gathered
        row-wise onto the master's device."""
        if len(self.models) == 1:
            return fn(self.models[0], batch.to(self.device))
        shards = zip(*(batch_sharding(self.mesh).place(t) for t in batch))
        outs = [fn(m, type(batch)(*shard))
                for m, shard in zip(self.models, shards)]
        home = next(self.master.parameters()).device
        return tuple(gather(parts, home) for parts in zip(*outs))

    def zero_grad(self) -> None:
        for m in self.models:
            m.zero_grad(set_to_none=True)
        self.master.zero_grad(set_to_none=True)

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """The master's gradient of each trainable parameter: the sum of
        the replicas' (float32, on the master's device), a split leaf's
        being the concatenation of its shards'. A parameter no replica
        reached keeps none."""
        for i, p in enumerate(self.params):
            total = p.grad
            for leaves in self._replica_params:
                if leaves is None:
                    continue
                leaf = leaves[i]
                split = isinstance(leaf, SplitLeaf)
                parts = leaf.shards if split else [leaf]
                if parts[0].grad is None:
                    continue
                g = (gather_leaf([s.grad for s in parts], leaf.dim, p.device)
                     if split else leaf.grad).to(p.device, torch.float32)
                total = g if total is None else total + g
                for s in parts:
                    s.grad = None
            p.grad = total

    @torch.no_grad()
    def sync(self) -> None:
        """Copy the master's trainable weights into every other replica
        (each shard of a split leaf its slice) and into the caller's model
        where it is no replica. The bridge's zeros (``bias_hh_l0``) stay
        as they are."""
        for leaves in self._replica_params:
            if leaves is None:
                continue
            for src, leaf in zip(self.params, leaves):
                if isinstance(leaf, SplitLeaf):
                    for part, dst in zip(split_leaf(
                            src, leaf.dim, len(leaf.shards)), leaf.shards):
                        dst.copy_(part)
                else:
                    leaf.copy_(src)
        if self._own is not None:
            for dst, src in zip(self._own.parameters(),
                                self.master.parameters()):
                dst.copy_(src)
