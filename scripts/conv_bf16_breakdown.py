# -*- coding: utf-8 -*-
"""Where the time of the bf16 conv kernels goes, on a CUDA card.

    python3 scripts/conv_bf16_breakdown.py [--out breakdown.json]

Builds variants of ``illufly_tts_tpu_torch/csrc/adain_snake_conv.cu`` with
parts of the bf16 form switched off (a copy of the source with ``#ifdef``
hooks put in by text substitution, compiled into ``build/breakdown/``):
the MMAs (``NO_MMA``), the producers' weight copies by the copy engine
(``NO_W``), their raw input loads (``NO_RAW``), their activation
(``NO_ACT``) and the consumers' epilogue stores (``NO_EPI``). Each variant
of both forms, the halo tile at d=1 and the walking carry at d=5, is timed
with CUDA events after an L2 flush at B=8, C=128, L=61440, k=11 (the
Generator's last stage at frame bucket 512), beside the kernel as it is. A variant with a part off computes garbage;
only its time means anything. A substitution that no longer matches the
source raises. Prints one JSON line (and writes it to ``--out``) with each
variant's ms by form and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "illufly_tts_tpu_torch", "csrc",
                      "adain_snake_conv.cu")
OUT_DIR = os.path.join(HERE, "build", "breakdown")
SHAPE = (8, 128, 61440, 11)  # B, C, L, k
FORMS = {"adain_snake_conv_bf16": 1, "adain_snake_conv_carry_bf16": 5}  # d

# (text in the source, the same text with a hook) for each part
HOOKS = (
    ("        wgmma_bf16<TL>(acc, ad, bd);\n",
     "#ifndef NO_MMA\n        wgmma_bf16<TL>(acc, ad, bd);\n#endif\n"),
    ("  mbar_expect_tx(bar, a.k * TAP_BYTES);\n"
     "  for (int t = 0; t < a.k; ++t)\n"
     "    bulk_copy(dst + t * W_TAP_WORDS, src + t * TAP_BYTES, TAP_BYTES, "
     "bar);\n",
     "#ifndef NO_W\n  mbar_expect_tx(bar, a.k * TAP_BYTES);\n"
     "  for (int t = 0; t < a.k; ++t)\n"
     "    bulk_copy(dst + t * W_TAP_WORDS, src + t * TAP_BYTES, TAP_BYTES, "
     "bar);\n#endif\n"),
    ("  constexpr int PER_CHANNEL = PRODUCERS_B / CKB;\n",
     "  constexpr int PER_CHANNEL = PRODUCERS_B / CKB;\n#ifdef NO_RAW\n"
     "  commit_group();\n  return;\n#endif\n"),
    ("  const __nv_bfloat16* x_s = "
     "reinterpret_cast<const __nv_bfloat16*>(raw);\n",
     "#ifdef NO_ACT\n  return;\n#endif\n  const __nv_bfloat16* x_s = "
     "reinterpret_cast<const __nv_bfloat16*>(raw);\n"),
    ("    const int o0 = co_tile * TN + 64 * g + 16 * ((threadIdx.x % 128) / "
     "32) +\n",
     "#ifdef NO_EPI\n    continue;\n#endif\n"
     "    const int o0 = co_tile * TN + 64 * g + 16 * ((threadIdx.x % 128) / "
     "32) +\n"),
)
VARIANTS = {
    "kernel": (),
    "no MMAs (producers alone)": ("NO_MMA",),
    "producers: weights only": ("NO_MMA", "NO_RAW", "NO_ACT"),
    "producers: activation only": ("NO_MMA", "NO_RAW", "NO_W"),
    "producers: weights + raw": ("NO_MMA", "NO_ACT"),
    "producers: activation + raw": ("NO_MMA", "NO_W"),
    "MMAs alone": ("NO_W", "NO_RAW", "NO_ACT"),
    "neither (barriers, epilogue)": ("NO_MMA", "NO_W", "NO_RAW", "NO_ACT"),
    "barriers alone (no epilogue stores)": ("NO_MMA", "NO_W", "NO_RAW",
                                            "NO_ACT", "NO_EPI"),
}


def hooked_source() -> str:
    with open(SOURCE) as f:
        text = f.read()
    for old, new in HOOKS:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer has, once: {old!r}")
        text = text.replace(old, new)
    return text


def build() -> dict:
    sys.path.insert(0, HERE)
    from illufly_tts_tpu_torch.ops import cuda_build

    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, "hooked.cu")
    with open(src, "w") as f:
        f.write(hooked_source())
    procs = {}
    for i, (name, flags) in enumerate(VARIANTS.items()):
        lib = os.path.join(OUT_DIR, f"lib_{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
             *(f"-D{flag}" for flag in flags), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
        for form in FORMS:
            fn = getattr(libs[name], form)
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return libs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the breakdown times the kernel on one")
    sys.path.insert(0, HERE)
    from illufly_tts_tpu_torch.ops import adain_snake_conv as asc

    libs = build()
    batch, channels, length, k = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    inputs = ((randn(batch, channels, length) * 0.5).bfloat16(),
              torch.ones(batch, length, device="cuda"),
              1.0 + 0.1 * randn(batch, channels), 0.1 * randn(batch, channels),
              randn(channels).abs() + 0.5,
              asc.pack_weights(randn(k, channels, channels)
                               / math.sqrt(channels * k)),
              0.1 * randn(channels))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile_len = asc.column_tile(batch, channels, length, sms, bf16=True)
    per_cta = {
        "adain_snake_conv_bf16": asc.tiles_per_cta(
            batch, channels, length, sms, tile_len),
        "adain_snake_conv_carry_bf16": asc.carry_tiles_per_chunk(
            batch, channels, channels, length, k, FORMS[
                "adain_snake_conv_carry_bf16"], sms, tile_len, bf16=True)}
    flush = torch.empty(64 * 2 ** 20, device="cuda")

    def device_ms(fn, reps=30):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    out = {"shape": list(SHAPE), "dilation": FORMS, "tile_len": tile_len,
           "tiles_per_cta": per_cta, "ms": {form: {} for form in FORMS}}
    for form, d in FORMS.items():
        for name, lib in libs.items():
            fn = getattr(lib, form)
            out["ms"][form][name] = device_ms(lambda: asc._launch(
                fn, *inputs, k, d, tile_len, per_cta[form]))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
