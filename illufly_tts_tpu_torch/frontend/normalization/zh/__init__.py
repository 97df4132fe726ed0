from .normalizer import ZhTextNormalizer

__all__ = ["ZhTextNormalizer"]
