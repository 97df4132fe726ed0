"""The published peaks that a model family's operations and bytes
(``perfbench/families/<name>.py``) are held to."""
from __future__ import annotations

# one NVIDIA H100 SXM (NVIDIA's data sheet; dense, without sparsity)
PEAK_BF16 = 989e12     # operations/s, bf16 tensor cores
PEAK_TF32 = 495e12     # operations/s, TF32: the fastest rate for float32
                       # inputs (the float32 convs run as 3xTF32 products)
PEAK_BYTES = 3.35e12   # bytes/s, HBM3
ESIZE = {"float32": 4, "bfloat16": 2}


def peak_ops(dtype: str) -> float:
    return PEAK_BF16 if dtype == "bfloat16" else PEAK_TF32
