# -*- coding: utf-8 -*-
"""Float32 master weights and the compute replicas that train on them.

The JAX trainer holds one float32 parameter tree: a bfloat16 model casts
it at every use (flax's ``param_dtype`` float32, ``dtype`` bfloat16), and
under a mesh GSPMD runs the step over the batch's shards and reduces the
gradients. The port's counterpart is ``Replicas``:

- ``master``: a float32 ``KokoroModel``, the weights the optimizer steps,
  the clip reads and checkpoints hold;
- ``models``: one compute model per 'data' device of the mesh (one without
  a mesh), in the config's dtype. A float32 model on one device is its own
  master and only replica: nothing is copied and the step is the plain one.
  A bfloat16 model is the first replica, and its master a float32 copy;
- ``map``: a function of (model, batch) run on each replica's rows of the
  batch, its outputs gathered row-wise onto the master's device, so that a
  loss computed on them is the whole batch's and one ``backward`` reaches
  every replica;
- ``reduce_grads``: each replica's gradients summed into the master's, in
  float32; ``sync``: the master's weights copied back into every replica
  (rounded to bfloat16 where the replica computes in it).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..model.params import trainable_parameters
from .mesh import (
    Mesh,
    batch_sharding,
    check_data_mesh,
    compute_copy,
    gather,
    make_mesh,
)


class Replicas:
    def __init__(self, model, mesh: Optional[Mesh] = None):
        """``model``: a ``KokoroModel`` (float32 or bfloat16) on the mesh's
        first device; ``mesh``: None for ``model``'s device alone."""
        home = next(model.parameters()).device
        self.mesh = mesh if mesh is not None else make_mesh(
            n_data=1, devices=[home])
        check_data_mesh(self.mesh)
        self.config = model.config
        self.dtype = model.config.dtype
        if self.dtype == torch.float32:
            self.master = model
        else:
            self.master = compute_copy(model, torch.float32, home)
        self.devices = self.mesh.data_devices
        self.models: List[torch.nn.Module] = [
            model if i == 0 and dev == home
            else compute_copy(self.master, self.dtype, dev)
            for i, dev in enumerate(self.devices)]
        self.params = trainable_parameters(self.master)
        self._replica_params = [
            None if m is self.master else trainable_parameters(m)
            for m in self.models]

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
        the replicas' (float32, on the master's device). A parameter no
        replica reached keeps none."""
        for i, p in enumerate(self.params):
            total = p.grad
            for rp in self._replica_params:
                if rp is None or rp[i].grad is None:
                    continue
                g = rp[i].grad.to(p.device, torch.float32)
                total = g if total is None else total + g
                rp[i].grad = None
            p.grad = total

    @torch.no_grad()
    def sync(self) -> None:
        """Copy the master's weights into every other replica."""
        for m in self.models:
            if m is self.master:
                continue
            for dst, src in zip(m.parameters(), self.master.parameters()):
                dst.copy_(src)
