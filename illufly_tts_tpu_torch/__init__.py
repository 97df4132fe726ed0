# -*- coding: utf-8 -*-
"""illufly-tts PyTorch/CUDA port: the JAX package ``illufly_tts_tpu`` ported
to PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

Top-level exports resolve lazily (PEP 562), so importing the package loads
no model code until a symbol is touched. The port imports nothing from the
JAX package."""

__version__ = "0.1.0"

_LAZY = {
    "Synthesizer": ("illufly_tts_tpu_torch.engine.synthesizer", "Synthesizer"),
    "KokoroConfig": ("illufly_tts_tpu_torch.model.config", "KokoroConfig"),
    "KokoroModel": ("illufly_tts_tpu_torch.model.kokoro", "KokoroModel"),
    "TTSPipeline": ("illufly_tts_tpu_torch.pipeline", "TTSPipeline"),
    "CachedTTSPipeline": ("illufly_tts_tpu_torch.pipeline",
                          "CachedTTSPipeline"),
    "TTSServiceManager": ("illufly_tts_tpu_torch.runtime.scheduler",
                          "TTSServiceManager"),
}

__all__ = ["__version__", *_LAZY]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(
        f"module 'illufly_tts_tpu_torch' has no attribute {name!r}")
