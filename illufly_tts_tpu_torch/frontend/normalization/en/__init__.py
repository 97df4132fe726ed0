from .normalizer import EnTextNormalizer

__all__ = ["EnTextNormalizer"]
