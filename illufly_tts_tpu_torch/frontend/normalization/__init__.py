from .en import EnTextNormalizer
from .zh import ZhTextNormalizer

__all__ = ["ZhTextNormalizer", "EnTextNormalizer"]
