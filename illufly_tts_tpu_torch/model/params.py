# -*- coding: utf-8 -*-
"""Weight bridge between a flax parameter tree and the PyTorch port.

The port names its submodules after the flax modules, so every flax leaf
maps to one port parameter by the module type alone, with a layout
transform:

| flax                                    | port                          |
|-----------------------------------------|-------------------------------|
| Conv kernel ``[k, in/g, out]``          | ``[out, in/g, k]``            |
| Dense kernel ``[in, out]``              | ``[out, in]``                 |
| LSTM ``{d}_ih`` Dense + ``{d}_hh``      | ``{d}.weight_ih_l0`` / ``weight_hh_l0`` / ``bias_ih_l0``; ``bias_hh_l0 = 0`` (gates i, f, g, o) |
| ConvTranspose ``[k, in/g, out]``        | ``[in, out/g, k]``            |
| alphas ``[1, 1, C]``                    | ``[1, C, 1]``                 |
| Embed ``embedding``, LayerNorm ``scale``| ``weight``                    |

``load_flax_params`` raises on any flax leaf it cannot place and on any
port parameter it cannot fill. ``random_flax_params`` is the counterpart
of the JAX ``Synthesizer._random_init``: it draws the same numbers in the
same leaf order, so a seed gives the JAX parameters bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .layers import LSTM, ConvTranspose1d

Path = Tuple[str, ...]
# (port parameter name, flax path under "params", permutation with
#  port = flax.transpose(perm); None = same layout)
Spec = Tuple[str, Path, Tuple[int, ...] | None]

_T = (1, 0)


def _leaf_specs(model: nn.Module) -> Tuple[List[Spec], List[str]]:
    """-> (specs, port parameters the bridge sets to zero)."""
    specs: List[Spec] = []
    zeros: List[str] = []
    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        pre = f"{name}." if name else ""
        if isinstance(mod, LSTM):
            dirs = ("fwd", "bwd") if mod.bidirectional else ("fwd",)
            for d in dirs:
                specs += [
                    (f"{pre}{d}.weight_ih_l0", path + (f"{d}_ih", "kernel"),
                     _T),
                    (f"{pre}{d}.bias_ih_l0", path + (f"{d}_ih", "bias"),
                     None),
                    (f"{pre}{d}.weight_hh_l0", path + (f"{d}_hh",), _T),
                ]
                zeros.append(f"{pre}{d}.bias_hh_l0")
        elif isinstance(mod, nn.LSTM):
            continue  # owned by the LSTM above
        elif isinstance(mod, ConvTranspose1d):
            if mod.groups == 1:
                perm = (1, 2, 0)
            elif mod.groups == mod.in_channels == mod.out_channels:
                perm = (2, 1, 0)  # depthwise
            else:
                raise NotImplementedError(f"{name}: groups={mod.groups}")
            specs += [(f"{pre}weight", path + ("kernel",), perm),
                      (f"{pre}bias", path + ("bias",), None)]
        elif isinstance(mod, nn.Conv1d):
            specs += [(f"{pre}weight", path + ("conv", "kernel"), (2, 1, 0)),
                      (f"{pre}bias", path + ("conv", "bias"), None)]
        elif isinstance(mod, nn.Linear):
            specs += [(f"{pre}weight", path + ("kernel",), _T),
                      (f"{pre}bias", path + ("bias",), None)]
        elif isinstance(mod, nn.Embedding):
            specs.append((f"{pre}weight", path + ("embedding",), None))
        elif isinstance(mod, nn.LayerNorm):
            specs += [(f"{pre}weight", path + ("scale",), None),
                      (f"{pre}bias", path + ("bias",), None)]
        else:
            for pname, p in mod.named_parameters(recurse=False):
                perm = (0, 2, 1) if pname.startswith("alpha") else None
                specs.append((f"{pre}{pname}", path + (pname,), perm))
    return specs, zeros


def _flax_shape(shape: Tuple[int, ...], perm) -> Tuple[int, ...]:
    if perm is None:
        return tuple(shape)
    out = [0] * len(shape)
    for i, p in enumerate(perm):
        out[p] = shape[i]
    return tuple(out)


def flax_shapes(model: nn.Module) -> Dict[Path, Tuple[int, ...]]:
    """Flax path (under "params") -> flax shape, for every leaf."""
    params = dict(model.named_parameters())
    specs, _ = _leaf_specs(model)
    return {path: _flax_shape(params[name].shape, perm)
            for name, path, perm in specs}


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    flat: Dict[Path, np.ndarray] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(_flatten(value, prefix + (str(key),)))
        else:
            flat[prefix + (str(key),)] = np.asarray(value)
    return flat


def _nest(flat: Mapping[Path, np.ndarray]) -> dict:
    root: dict = {}
    for path, value in flat.items():
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return root


def random_flax_params(model: nn.Module, seed: int) -> dict:
    """``{"params": ...}`` tree of numpy arrays, equal to the JAX
    ``Synthesizer(config, seed=seed).params``: alpha/scale -> 1; bias or
    rank <= 1 -> 0; else ``RandomState(seed).randn / sqrt(fan_in)``, drawn
    in flax leaf order (keys sorted at every level)."""
    rng = np.random.RandomState(seed)
    flat: Dict[Path, np.ndarray] = {}
    for path, shape in sorted(flax_shapes(model).items()):
        name = "/".join(("params",) + path).lower()
        if "alpha" in name or name.endswith("scale"):
            flat[path] = np.ones(shape, np.float32)
        elif name.endswith("bias") or len(shape) <= 1:
            flat[path] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1])) or 1
            std = 1.0 / np.sqrt(fan_in)
            # the product in float64, as NumPy 2 computes f32 * np.float64
            draw = rng.randn(*shape).astype(np.float32).astype(np.float64)
            flat[path] = (draw * std).astype(np.float32)
    return {"params": _nest(flat)}


def load_flax_params(model: nn.Module, tree: Mapping) -> None:
    """Fill ``model`` from a flax tree (``{"params": ...}`` or its inner
    dict) of array-likes. Raises ValueError on any unmapped flax leaf, any
    missing leaf, any shape mismatch, or any port parameter left unfilled."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    specs, zeros = _leaf_specs(model)
    params = dict(model.named_parameters())
    wanted = {path for _, path, _ in specs}
    unmapped = sorted("/".join(p) for p in set(flat) - wanted)
    missing = sorted("/".join(p) for p in wanted - set(flat))
    unfilled = sorted(
        set(params) - {name for name, _, _ in specs} - set(zeros))
    if unmapped or missing or unfilled:
        raise ValueError(
            f"flax tree does not fit the port: unmapped leaves {unmapped}, "
            f"missing leaves {missing}, unfilled parameters {unfilled}"
        )
    with torch.no_grad():
        for name, path, perm in specs:
            arr = flat[path]
            if perm is not None:
                arr = arr.transpose(perm)
            dst = params[name]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} does "
                                 f"not fit {name} {tuple(dst.shape)}")
            dst.copy_(torch.tensor(arr, dtype=torch.float32))
        for name in zeros:
            params[name].zero_()


def export_flax_params(model: nn.Module) -> dict:
    """The port's parameters as a ``{"params": ...}`` flax-layout tree of
    numpy arrays (the inverse of ``load_flax_params``)."""
    params = dict(model.named_parameters())
    flat = {}
    for name, path, perm in _leaf_specs(model)[0]:
        arr = params[name].detach().cpu().float().numpy()
        if perm is not None:
            arr = arr.transpose(np.argsort(perm))
        flat[path] = np.ascontiguousarray(arr)
    return {"params": _nest(flat)}
