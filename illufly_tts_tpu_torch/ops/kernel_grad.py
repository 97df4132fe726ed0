# -*- coding: utf-8 -*-
"""Gradients through the CUDA kernels.

A kernel wrapper calls its kernel through ctypes, so on a CUDA tensor its
output carries no ``grad_fn`` of its own. ``kernel_call`` wraps the launch in
a ``torch.autograd.Function`` whenever autograd is recording and an input
needs a gradient:

- forward: the launch, exactly as without autograd (one launch, one count);
- backward: the function recomputed through its plain PyTorch version under
  ``torch.enable_grad()`` and differentiated by autograd, for the inputs
  whose gradient is asked for. The recompute launches no kernel.

The TPU kernels have no VJP either (no ``custom_vjp`` under
``illufly_tts_tpu/ops/pallas/``): the JAX package trains through plain ops.
So the backward here computes what ``jax.grad`` computes there, while the
forward stays the kernel. Under ``torch.no_grad()`` or
``torch.inference_mode()``, or when no input needs a gradient, the launch
runs bare and no graph is built.

``launch`` and ``plain`` are passed in, so a test can run the Function on
the CPU with the plain version standing in for the kernel.
"""
from __future__ import annotations

from typing import Callable

import torch


class KernelFunction(torch.autograd.Function):
    """``launch(*tensors)`` forward, ``plain(*tensors)`` recomputed and
    differentiated backward."""

    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return launch(*tensors)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        wanted = [t for t, need in zip(inputs, needs) if need]
        with torch.enable_grad():
            out = ctx.plain(*inputs)
        grads = iter(torch.autograd.grad(out, wanted, grad_out,
                                         allow_unused=True))
        return (None, None, *(next(grads) if need else None
                              for need in needs))


def kernel_call(launch: Callable, plain: Callable, *tensors: torch.Tensor):
    """``launch(*tensors)``, differentiable through ``plain`` when autograd
    records and some input requires a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return KernelFunction.apply(launch, plain, *tensors)
    return launch(*tensors)
