# -*- coding: utf-8 -*-
"""torch (Kokoro/StyleTTS2) checkpoint -> flax-layout parameter tree
(PyTorch port of ``illufly_tts_tpu/model/convert.py``).

A copy of the JAX converter, numpy throughout: it builds the same
``{"params": ...}`` tree the JAX ``convert_checkpoint`` builds (leaf for
leaf, bit for bit), which ``model/params.py::load_flax_params`` places on
the port's modules. Two changes: ``flax.traverse_util`` becomes
``model/params.py``'s ``_flatten``/``_nest``, and the leaves stay numpy
(no ``jnp.asarray``). ``template(model)`` builds a template tree from the
port model's own flax shapes. The name map below covers the full
Kokoro-82M naming convention (submodules per the reference call surface,
src/illufly_tts/core/kmodel.py:70-144):

  bert.*                 transformers AlbertModel (shared-layer ALBERT)
  bert_encoder.*         Linear
  predictor.*            StyleTTS2 ProsodyPredictor (DurationEncoder
                         'text_encoder.lstms.{0,2,4}' LSTMs interleaved with
                         AdaLayerNorms, 'lstm', 'duration_proj.linear_layer',
                         'shared', F0/N AdainResBlk1d towers, F0/N_proj)
  text_encoder.*         embedding + weight-normed convs + BiLSTM
  decoder.*              iSTFTNet decoder (encode/decode AdainResBlk1d,
                         F0/N_conv, asr_res, generator ups/noise/resblocks/
                         conv_post/m_source)

Layout conventions handled:
- torch Conv1d weight [out, in, k]        -> flax Conv kernel [k, in, out]
- torch Linear weight [out, in]           -> flax Dense kernel [in, out]
- torch LSTM weight_ih_l0 [4H, D]         -> fused Dense kernel [D, 4H]
  (gate order i, f, g, o matches torch; b_ih + b_hh folded into one bias)
- weight-norm (weight_g, weight_v)        -> folded plain kernel
- torch ConvTranspose1d [in, out/g, k]    -> flax kernel [k, in/g, out]
  (layers.ConvTranspose1d consumes the UNflipped kernel and flips inside)
- ALBERT q/k/v Linears                    -> one fused qkv kernel
- token_type_embeddings row 0             -> folded into pos_emb
- generator alphas [1, C, 1]              -> [1, 1, C]

Held to the JAX converter on torch twins with kokoro naming
(tests/torch_twin.py, tests/test_torch_convert.py): the same tree, and zero
unmapped tensors at the full config.
"""
from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .params import _flatten, _nest, flax_shapes

logger = logging.getLogger(__name__)


class ConversionError(ValueError):
    pass


def fold_weight_norm(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Fold torch weight-norm (weight_g, weight_v) pairs into plain weights.

    Accepts both the classic names and the parametrize-style
    ``parametrizations.weight.original{0,1}``."""
    out: Dict[str, np.ndarray] = {}
    done = set()
    for name in list(state):
        if name.endswith("weight_g"):
            base, gname, vname = name[: -len("weight_g")], name, None
            vname = base + "weight_v"
        elif name.endswith("parametrizations.weight.original0"):
            base = name[: -len("parametrizations.weight.original0")]
            gname, vname = name, base + "parametrizations.weight.original1"
        else:
            continue
        g = np.asarray(state[gname], np.float32)
        v = np.asarray(state[vname], np.float32)
        norm = np.sqrt(
            (v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True)
        )
        out[base + "weight"] = g * v / np.maximum(norm, 1e-12)
        done.add(gname)
        done.add(vname)
    for name, tensor in state.items():
        if name not in done and name not in out:
            out[name] = np.asarray(tensor, np.float32)
    return out


def conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch Conv1d [out, in, k] -> flax [k, in, out]."""
    return np.transpose(w, (2, 1, 0))


def dense_kernel(w: np.ndarray) -> np.ndarray:
    """torch Linear [out, in] -> flax [in, out]."""
    return np.transpose(w, (1, 0))


def convtranspose_kernel(w: np.ndarray, groups: int = 1) -> np.ndarray:
    """torch ConvTranspose1d [in, out/groups, k] -> flax [k, in/groups, out].

    layers.ConvTranspose1d flips the kernel internally, so the map is a pure
    transpose: groups=1 -> (2,0,1); depthwise (groups=in) -> (2,1,0)."""
    if groups == 1:
        return np.transpose(w, (2, 0, 1))
    in_ch, out_per_group, k = w.shape
    assert out_per_group == 1 and groups == in_ch, (w.shape, groups)
    return np.transpose(w, (2, 1, 0))


def lstm_params(prefix: str, state: Dict[str, np.ndarray], direction: str):
    """torch LSTM tensors -> our fused-projection LSTM params.

    Returns dict with '{direction}_ih' Dense {kernel, bias} and
    '{direction}_hh' kernel [H, 4H].
    """
    suffix = "" if direction == "fwd" else "_reverse"
    w_ih = state[f"{prefix}.weight_ih_l0{suffix}"]      # [4H, D]
    w_hh = state[f"{prefix}.weight_hh_l0{suffix}"]      # [4H, H]
    b_ih = state[f"{prefix}.bias_ih_l0{suffix}"]
    b_hh = state[f"{prefix}.bias_hh_l0{suffix}"]
    return {
        f"{direction}_ih": {
            "kernel": dense_kernel(w_ih),
            "bias": np.asarray(b_ih) + np.asarray(b_hh),
        },
        f"{direction}_hh": dense_kernel(w_hh),
    }


def _flatten_torch_state(torch_state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Accept flat dotted dicts or the kokoro layout {'bert': {...}, ...};
    strip DataParallel 'module.' prefixes; drop torch buffers."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in torch_state.items():
        if isinstance(value, dict):
            for sub, tensor in value.items():
                flat[f"{key}.{sub}"] = tensor
        else:
            flat[key] = value
    out = {}
    for key, tensor in flat.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.endswith(("position_ids", "num_batches_tracked")):
            continue
        if hasattr(tensor, "detach"):
            tensor = tensor.detach().cpu().numpy()
        out[key] = np.asarray(tensor)
    return out


_DROP = re.compile(
    r"^(bert\.pooler\.|decoder\.generator\.stft\.|"
    r"decoder\.generator\.f0_upsamp)"
)

# LSTM torch prefix -> flax path (under params/)
_LSTM_MAP: List[Tuple[re.Pattern, Any]] = [
    (re.compile(r"^predictor\.text_encoder\.lstms\.(\d+)$"),
     lambda m: ("predictor", "duration_encoder", f"lstm_{int(m.group(1)) // 2}")),
    (re.compile(r"^predictor\.lstm$"), lambda m: ("predictor", "lstm")),
    (re.compile(r"^predictor\.shared$"), lambda m: ("predictor", "shared")),
    (re.compile(r"^text_encoder\.lstm$"), lambda m: ("text_encoder", "lstm")),
]

# AdainResBlk1d torch prefix -> flax module path
_RESBLK_MAP: List[Tuple[re.Pattern, Any]] = [
    (re.compile(r"^predictor\.F0\.(\d+)\."),
     lambda m: ("predictor", f"f0_{m.group(1)}")),
    (re.compile(r"^predictor\.N\.(\d+)\."),
     lambda m: ("predictor", f"n_{m.group(1)}")),
    (re.compile(r"^decoder\.encode\."), lambda m: ("decoder", "encode")),
    (re.compile(r"^decoder\.decode\.(\d+)\."),
     lambda m: ("decoder", f"decode_{m.group(1)}")),
]


def _map_simple(key: str, arr: np.ndarray, num_res_kernels: int):
    """Map one non-LSTM torch tensor. Returns (flax_path_tuple, array) or
    None when the key is handled elsewhere / intentionally dropped."""
    p = ("params",)

    # ---- bert (transformers ALBERT) ----------------------------------------
    if key == "bert.embeddings.word_embeddings.weight":
        return p + ("bert", "tok_emb", "embedding"), arr
    if key == "bert.embeddings.position_embeddings.weight":
        return p + ("bert", "pos_emb"), arr  # token_type folded by caller
    if key.startswith("bert.embeddings.LayerNorm."):
        leaf = "scale" if key.endswith("weight") else "bias"
        return p + ("bert", "ln_emb", leaf), arr
    if key.startswith("bert.encoder.embedding_hidden_mapping_in."):
        if key.endswith("weight"):
            return p + ("bert", "emb_proj", "kernel"), dense_kernel(arr)
        return p + ("bert", "emb_proj", "bias"), arr
    layer = "bert.encoder.albert_layer_groups.0.albert_layers.0."
    if key.startswith(layer):
        rest = key[len(layer):]
        if rest.startswith("attention.LayerNorm."):
            leaf = "scale" if rest.endswith("weight") else "bias"
            return p + ("bert", "shared_layer", "ln_attn", leaf), arr
        if rest.startswith("attention.dense."):
            if rest.endswith("weight"):
                return (p + ("bert", "shared_layer", "attn_out", "kernel"),
                        dense_kernel(arr))
            return p + ("bert", "shared_layer", "attn_out", "bias"), arr
        if rest.startswith("ffn."):
            if rest.endswith("weight"):
                return (p + ("bert", "shared_layer", "ffn_in", "kernel"),
                        dense_kernel(arr))
            return p + ("bert", "shared_layer", "ffn_in", "bias"), arr
        if rest.startswith("ffn_output."):
            if rest.endswith("weight"):
                return (p + ("bert", "shared_layer", "ffn_out", "kernel"),
                        dense_kernel(arr))
            return p + ("bert", "shared_layer", "ffn_out", "bias"), arr
        if rest.startswith("full_layer_layer_norm."):
            leaf = "scale" if rest.endswith("weight") else "bias"
            return p + ("bert", "shared_layer", "ln_ffn", leaf), arr
        return None  # q/k/v handled by the fused-qkv pass

    # ---- bert_encoder --------------------------------------------------------
    if key == "bert_encoder.weight":
        return p + ("bert_encoder", "kernel"), dense_kernel(arr)
    if key == "bert_encoder.bias":
        return p + ("bert_encoder", "bias"), arr

    # ---- predictor non-LSTM --------------------------------------------------
    m = re.match(r"^predictor\.text_encoder\.lstms\.(\d+)\.fc\.(weight|bias)$",
                 key)
    if m:
        idx = (int(m.group(1)) - 1) // 2
        if m.group(2) == "weight":
            return (p + ("predictor", "duration_encoder", f"adaln_{idx}",
                         "fc", "kernel"), dense_kernel(arr))
        return (p + ("predictor", "duration_encoder", f"adaln_{idx}",
                     "fc", "bias"), arr)
    m = re.match(
        r"^predictor\.duration_proj\.(?:linear_layer\.)?(weight|bias)$", key
    )
    if m:
        if m.group(1) == "weight":
            return (p + ("predictor", "duration_proj", "kernel"),
                    dense_kernel(arr))
        return p + ("predictor", "duration_proj", "bias"), arr
    m = re.match(r"^predictor\.(F0|N)_proj\.(weight|bias)$", key)
    if m:
        name = "f0_proj" if m.group(1) == "F0" else "n_proj"
        if m.group(2) == "weight":
            return (p + ("predictor", name, "conv", "kernel"),
                    conv_kernel(arr))
        return p + ("predictor", name, "conv", "bias"), arr

    # ---- AdainResBlk1d (predictor towers + decoder encode/decode) -----------
    for pat, to_path in _RESBLK_MAP:
        m = pat.match(key)
        if not m:
            continue
        rest = key[m.end():]
        base = p + to_path(m)
        mm = re.match(r"^(norm1|norm2)\.fc\.(weight|bias)$", rest)
        if mm:
            leaf = ("kernel" if mm.group(2) == "weight" else "bias")
            arr2 = dense_kernel(arr) if leaf == "kernel" else arr
            return base + (mm.group(1), "fc", leaf), arr2
        mm = re.match(r"^(conv1|conv2|conv1x1)\.(weight|bias)$", rest)
        if mm:
            leaf = "kernel" if mm.group(2) == "weight" else "bias"
            arr2 = conv_kernel(arr) if leaf == "kernel" else arr
            return base + (mm.group(1), "conv", leaf), arr2
        mm = re.match(r"^pool\.(weight|bias)$", rest)
        if mm:
            if mm.group(1) == "weight":
                return base + ("pool", "kernel"), convtranspose_kernel(
                    arr, groups=arr.shape[0]
                )
            return base + ("pool", "bias"), arr
        return None

    # ---- text encoder --------------------------------------------------------
    if key == "text_encoder.embedding.weight":
        return p + ("text_encoder", "embed", "embedding"), arr
    m = re.match(r"^text_encoder\.cnn\.(\d+)\.0\.(weight|bias)$", key)
    if m:
        i = m.group(1)
        if m.group(2) == "weight":
            return (p + ("text_encoder", f"conv_{i}", "conv", "kernel"),
                    conv_kernel(arr))
        return p + ("text_encoder", f"conv_{i}", "conv", "bias"), arr
    m = re.match(r"^text_encoder\.cnn\.(\d+)\.1\.(gamma|beta|weight|bias)$",
                 key)
    if m:
        leaf = "scale" if m.group(2) in ("gamma", "weight") else "bias"
        return p + ("text_encoder", f"ln_{m.group(1)}", leaf), arr

    # ---- decoder glue ----------------------------------------------------------
    m = re.match(r"^decoder\.(F0|N)_conv\.(weight|bias)$", key)
    if m:
        name = "f0_conv" if m.group(1) == "F0" else "n_conv"
        if m.group(2) == "weight":
            return p + ("decoder", name, "conv", "kernel"), conv_kernel(arr)
        return p + ("decoder", name, "conv", "bias"), arr
    m = re.match(r"^decoder\.asr_res\.0\.(weight|bias)$", key)
    if m:
        if m.group(1) == "weight":
            return (p + ("decoder", "asr_res", "conv", "kernel"),
                    conv_kernel(arr))
        return p + ("decoder", "asr_res", "conv", "bias"), arr

    # ---- generator -------------------------------------------------------------
    g = ("decoder", "generator")
    m = re.match(r"^decoder\.generator\.ups\.(\d+)\.(weight|bias)$", key)
    if m:
        if m.group(2) == "weight":
            return (p + g + (f"up_{m.group(1)}", "kernel"),
                    convtranspose_kernel(arr, groups=1))
        return p + g + (f"up_{m.group(1)}", "bias"), arr
    m = re.match(r"^decoder\.generator\.noise_convs\.(\d+)\.(weight|bias)$",
                 key)
    if m:
        if m.group(2) == "weight":
            return (p + g + (f"noise_conv_{m.group(1)}", "conv", "kernel"),
                    conv_kernel(arr))
        return p + g + (f"noise_conv_{m.group(1)}", "conv", "bias"), arr
    m = re.match(r"^decoder\.generator\.conv_post\.(weight|bias)$", key)
    if m:
        if m.group(1) == "weight":
            return (p + g + ("conv_post", "conv", "kernel"),
                    conv_kernel(arr))
        return p + g + ("conv_post", "conv", "bias"), arr
    m = re.match(r"^decoder\.generator\.m_source\.l_linear\.(weight|bias)$",
                 key)
    if m:
        if m.group(1) == "weight":
            return (p + g + ("source", "merge", "kernel"),
                    dense_kernel(arr))
        return p + g + ("source", "merge", "bias"), arr

    # AdaINResBlock1 inside the generator
    m = re.match(
        r"^decoder\.generator\.(resblocks|noise_res)\.(\d+)\.(.+)$", key
    )
    if m:
        kind, idx, rest = m.group(1), int(m.group(2)), m.group(3)
        if kind == "resblocks":
            blk = f"res_{idx // num_res_kernels}_{idx % num_res_kernels}"
        else:
            blk = f"noise_res_{idx}"
        base = p + g + (blk,)
        mm = re.match(r"^(convs1|convs2)\.(\d+)\.(weight|bias)$", rest)
        if mm:
            name = ("conv1" if mm.group(1) == "convs1" else "conv2")
            leaf = "kernel" if mm.group(3) == "weight" else "bias"
            arr2 = conv_kernel(arr) if leaf == "kernel" else arr
            return base + (f"{name}_{mm.group(2)}", "conv", leaf), arr2
        mm = re.match(r"^(adain1|adain2)\.(\d+)\.fc\.(weight|bias)$", rest)
        if mm:
            leaf = "kernel" if mm.group(3) == "weight" else "bias"
            arr2 = dense_kernel(arr) if leaf == "kernel" else arr
            return base + (f"{mm.group(1)}_{mm.group(2)}", "fc", leaf), arr2
        mm = re.match(r"^(alpha1|alpha2)\.(\d+)$", rest)
        if mm:
            return (base + (f"{mm.group(1)}_{mm.group(2)}",),
                    np.transpose(arr, (0, 2, 1)))
        return None
    return None


_TOKEN_EMB_PATHS = (
    ("params", "bert", "tok_emb", "embedding"),
    ("params", "text_encoder", "embed", "embedding"),
)


def _remap_vocab_rows(src: np.ndarray, template: np.ndarray,
                      src_vocab: Dict[str, int]):
    """Reorder token-embedding rows from the source checkpoint's vocab
    (symbol -> row, e.g. Kokoro-82M config.json 'vocab', 178 entries)
    into THIS repo's vocab ordering (the port's model/vocab.py, a copy of
    the JAX package's, frontend-emission order). Rows for symbols absent
    from the source keep the template's init. -> (remapped [n_ours, dim],
    copied-row count)."""
    from .vocab import VOCAB

    new = np.array(template, np.float32, copy=True)
    hits = 0
    for sym, src_row in src_vocab.items():
        dst = VOCAB.get(sym)
        if dst is not None and 0 <= int(src_row) < src.shape[0] \
                and dst < new.shape[0]:
            new[dst] = src[int(src_row)]
            hits += 1
    return new, hits


def convert_checkpoint(torch_state: Dict[str, Any], flax_params,
                       src_vocab: Optional[Dict[str, int]] = None) -> Any:
    """Convert a Kokoro torch state_dict (flat or nested) to a Flax param
    tree matching ``flax_params``'s structure. Raises ConversionError with
    the exact lists of unmapped torch tensors / unfilled flax leaves.

    ``src_vocab`` (symbol -> row id, the checkpoint repo's config.json
    'vocab' table): remaps BOTH token-embedding matrices into this
    repo's vocab ordering — without it a real Kokoro-82M checkpoint
    (178-row vocab in kokoro's own id order) cannot line up with the
    template's rows. Leaves of ``flax_params`` need only a ``shape``,
    except the two token embeddings under ``src_vocab``, whose values fill
    the rows the source lacks (``template(model)`` gives zeros)."""
    state = fold_weight_norm(_flatten_torch_state(torch_state))

    template = _flatten(
        flax_params["params"] if "params" in flax_params else flax_params
    )
    template = {("params",) + k: v for k, v in template.items()}
    num_res_kernels = len({
        c for k in template for c in k
        if isinstance(c, str) and re.match(r"^res_0_\d+$", c)
    }) or 3

    out: Dict[tuple, np.ndarray] = {}
    unmapped: List[str] = []

    # fused qkv: collect per-tensor then concatenate along the output axis
    layer = "bert.encoder.albert_layer_groups.0.albert_layers.0.attention."
    qkv_w = [state.pop(layer + n + ".weight", None) for n in ("query", "key", "value")]
    qkv_b = [state.pop(layer + n + ".bias", None) for n in ("query", "key", "value")]
    if all(w is not None for w in qkv_w):
        out[("params", "bert", "shared_layer", "qkv", "kernel")] = (
            np.concatenate([dense_kernel(w) for w in qkv_w], axis=1)
        )
        out[("params", "bert", "shared_layer", "qkv", "bias")] = (
            np.concatenate(qkv_b, axis=0)
        )

    # token_type row 0 folds into the position embedding (always-zero ids)
    tt = state.pop("bert.embeddings.token_type_embeddings.weight", None)

    # LSTMs: find prefixes and consume their 8 tensors
    lstm_prefixes = sorted({
        k[: -len(".weight_ih_l0")] for k in state if k.endswith(".weight_ih_l0")
    })
    for prefix in lstm_prefixes:
        target = None
        for pat, to_path in _LSTM_MAP:
            m = pat.match(prefix)
            if m:
                target = ("params",) + to_path(m)
                break
        if target is None:
            continue  # fc of an AdaLayerNorm etc. won't match *_ih_l0 anyway
        for direction in ("fwd", "bwd"):
            suffix = "" if direction == "fwd" else "_reverse"
            if f"{prefix}.weight_ih_l0{suffix}" not in state:
                continue
            params = lstm_params(prefix, state, direction)
            out[target + (f"{direction}_ih", "kernel")] = (
                params[f"{direction}_ih"]["kernel"]
            )
            out[target + (f"{direction}_ih", "bias")] = (
                params[f"{direction}_ih"]["bias"]
            )
            out[target + (f"{direction}_hh",)] = params[f"{direction}_hh"]
            for n in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                      "bias_hh_l0"):
                state.pop(f"{prefix}.{n}{suffix}", None)

    for key in sorted(state):
        if _DROP.match(key):
            continue
        mapped = _map_simple(key, state[key], num_res_kernels)
        if mapped is None:
            unmapped.append(key)
            continue
        path, arr = mapped
        if path == ("params", "bert", "pos_emb") and tt is not None:
            arr = arr + tt[0:1]
        out[path] = np.asarray(arr, np.float32)

    if src_vocab is not None:
        for p in _TOKEN_EMB_PATHS:
            if p in out and p in template:
                out[p], hits = _remap_vocab_rows(
                    out[p], np.asarray(template[p]), src_vocab
                )
                logger.info(
                    "vocab remap %s: %d/%d source rows copied",
                    "/".join(p[1:]), hits, len(src_vocab),
                )

    missing = [k for k in template if k not in out]
    # known structural gaps filled with exact-zero defaults:
    # - conv1x1 has no bias in StyleTTS2 (bias=False); flax Conv carries one
    fill = [k for k in missing
            if k[-2:] == ("conv", "bias") and "conv1x1" in k]
    for k in fill:
        out[k] = np.zeros(template[k].shape, np.float32)
        missing.remove(k)

    extra = [k for k in out if k not in template]
    shape_errors = [
        (k, out[k].shape, template[k].shape)
        for k in out
        if k in template and tuple(out[k].shape) != tuple(template[k].shape)
    ]
    if unmapped or missing or extra or shape_errors:
        raise ConversionError(
            f"unmapped torch tensors ({len(unmapped)}): {unmapped[:8]}; "
            f"unfilled flax leaves ({len(missing)}): "
            f"{['/'.join(map(str, k)) for k in missing[:8]]}; "
            f"unknown flax paths ({len(extra)}): "
            f"{['/'.join(map(str, k)) for k in extra[:8]]}; "
            f"shape mismatches: {shape_errors[:4]}"
        )
    logger.info("converted %d tensors (%d zero-filled)", len(out), len(fill))
    converted = _nest(out)
    if "params" not in flax_params:
        converted = converted["params"]
    return converted


def load_torch_checkpoint(path: str, flax_params,
                          src_vocab: Optional[Dict[str, int]] = None) -> Any:
    """Load a .pt/.pth Kokoro checkpoint from disk and convert it.

    A ``config.json`` sitting next to the checkpoint (the HF repo
    layout) is auto-discovered for its 'vocab' table when ``src_vocab``
    isn't given — real Kokoro weights need the row remap."""
    import json
    import os

    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "net" in state:
        state = state["net"]  # StyleTTS2 training-checkpoint wrapper
    if src_vocab is None:
        cfg_path = os.path.join(os.path.dirname(path) or ".", "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                src_vocab = json.load(f).get("vocab")
            if src_vocab:
                logger.info(
                    "using vocab table from %s (%d symbols)",
                    cfg_path, len(src_vocab),
                )
    return convert_checkpoint(state, flax_params, src_vocab=src_vocab)


def template(model) -> dict:
    """``{"params": ...}`` of zero arrays (broadcast views: no memory) in
    the port model's flax shapes, a ``convert_checkpoint`` template."""
    zero = np.zeros((), np.float32)
    return {"params": _nest({
        path: np.broadcast_to(zero, shape)
        for path, shape in flax_shapes(model).items()})}
