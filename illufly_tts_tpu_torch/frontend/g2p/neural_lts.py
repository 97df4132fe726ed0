# -*- coding: utf-8 -*-
"""Neural letter-to-sound: a small transformer encoder-decoder trained on
the package's own lexicon (scripts/train_neural_lts.py, JAX on TPU),
served here as a dependency-light numpy forward pass.

Why a second LTS: the joint n-gram chunk model (lts_model.py) tops out
around 53% word accuracy on rare-vocabulary OOV because its context window
cannot capture long-range vowel/stress patterns (Latinate stress shifts,
vowel quality conditioned on syllable count). A character transformer
learns those globally. The reference never solves this problem — it ships
a 12.6 MB silver lexicon instead and spells unknown words letter by letter
(reference: src/illufly_tts/core/g2p/english_g2p.py:160-170, 778-789);
this model is the TPU-era replacement for that data mass.

Serving path: inference is pure numpy (the frontend runs on host CPU while
the TPU renders audio; pulling jax into the frontend would trade ms of
decode for whole-process jit churn). The decoder is recomputed per step
without a KV cache — at d_model 256 and <=28 steps that is ~1 ms/word,
and predictions are memoized (OOV words repeat heavily across requests).

Decode constraints mirror lts_model.LTSModel: exactly one primary stress
per word (beam states track it) and the phonotactic sanity gate from the
n-gram model is reused verbatim, with the n-gram + hand rules as the
fallback chain (en_g2p._lts_word).
"""
from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

_MISS = object()

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# ILLUFLY_NEURAL_LTS overrides the weights path (used by the trainer /
# oracle eval to A/B candidate checkpoints without touching the package)
MODEL_PATH = os.environ.get(
    "ILLUFLY_NEURAL_LTS",
    os.path.join(_DATA_DIR, "neural_lts.npz"),
)

# token ids shared with the trainer (kept in the npz's config JSON too)
PAD, BOS, EOS = 0, 1, 2


def _gelu(x: np.ndarray) -> np.ndarray:
    return 0.5 * x * (1.0 + np.tanh(0.7978845608028654
                                    * (x + 0.044715 * x * x * x)))


def _layernorm(x: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    m = x.mean(-1, keepdims=True)
    v = x.var(-1, keepdims=True)
    return (x - m) / np.sqrt(v + 1e-6) * g + b


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


class NeuralLTS:
    """Numpy mirror of the trainer's transformer (train_neural_lts.py
    holds the authoritative shape spec; tests assert jax==numpy)."""

    def __init__(self, weights: Dict[str, np.ndarray], config: Dict):
        self.w = {k: np.asarray(v, dtype=np.float32)
                  for k, v in weights.items()}
        self.cfg = config
        self.d = config["d_model"]
        self.h = config["n_heads"]
        # ids 0..2 are PAD/BOS/EOS in both vocabs (trainer's encode_batch)
        self.in_vocab: Dict[str, int] = {
            c: i + 3 for i, c in enumerate(config["in_vocab"])
        }
        self.out_syms: List[str] = config["out_vocab"]
        self.max_in = config["max_in"]
        self.max_out = config["max_out"]
        self._memo: "OrderedDict[str, Optional[str]]" = OrderedDict()
        self._memo_cap = 50_000
        self._memo_lock = threading.Lock()

    # ---- loading -----------------------------------------------------------

    @classmethod
    def load(cls, path: str = MODEL_PATH) -> Optional["NeuralLTS"]:
        if not os.path.exists(path):
            return None
        with np.load(path, allow_pickle=False) as z:
            weights = {k: z[k] for k in z.files if k != "__config__"}
            config = json.loads(bytes(z["__config__"]).decode("utf-8"))
        return cls(weights, config)

    # ---- transformer forward (numpy) ----------------------------------------

    def _mha(self, prefix: str, q_in: np.ndarray, kv_in: np.ndarray,
             mask: Optional[np.ndarray]) -> np.ndarray:
        """Multi-head attention. q_in: [B,Tq,d], kv_in: [B,Tk,d],
        mask: [Tq,Tk] or [B,1,Tq,Tk] additive."""
        w = self.w
        B, Tq, d = q_in.shape
        Tk = kv_in.shape[1]
        h, dh = self.h, d // self.h
        q = q_in @ w[f"{prefix}/q/w"] + w[f"{prefix}/q/b"]
        k = kv_in @ w[f"{prefix}/k/w"] + w[f"{prefix}/k/b"]
        v = kv_in @ w[f"{prefix}/v/w"] + w[f"{prefix}/v/b"]
        q = q.reshape(B, Tq, h, dh).transpose(0, 2, 1, 3)
        k = k.reshape(B, Tk, h, dh).transpose(0, 2, 1, 3)
        v = v.reshape(B, Tk, h, dh).transpose(0, 2, 1, 3)
        att = q @ k.transpose(0, 1, 3, 2) / np.sqrt(dh)
        if mask is not None:
            att = att + mask
        att = _softmax(att)
        out = (att @ v).transpose(0, 2, 1, 3).reshape(B, Tq, d)
        return out @ w[f"{prefix}/o/w"] + w[f"{prefix}/o/b"]

    def _ffn(self, prefix: str, x: np.ndarray) -> np.ndarray:
        w = self.w
        return _gelu(x @ w[f"{prefix}/fc1/w"] + w[f"{prefix}/fc1/b"]) \
            @ w[f"{prefix}/fc2/w"] + w[f"{prefix}/fc2/b"]

    def _ln(self, prefix: str, x: np.ndarray) -> np.ndarray:
        return _layernorm(x, self.w[f"{prefix}/g"], self.w[f"{prefix}/b"])

    def encode(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """ids: [B,Tin] int32 -> (memory [B,Tin,d], pad additive mask
        [B,1,1,Tin])."""
        w = self.w
        B, T = ids.shape
        x = w["enc/emb"][ids] + w["enc/pos"][:T][None]
        pad = np.where(ids == PAD, -1e9, 0.0)[:, None, None, :]
        for i in range(self.cfg["enc_layers"]):
            p = f"enc/l{i}"
            x = x + self._mha(f"{p}/attn", self._ln(f"{p}/ln1", x),
                              self._ln(f"{p}/ln1", x), pad)
            x = x + self._ffn(f"{p}/ffn", self._ln(f"{p}/ln2", x))
        return self._ln("enc/lnf", x), pad

    def decode_logits(self, out_ids: np.ndarray, memory: np.ndarray,
                      src_pad: np.ndarray) -> np.ndarray:
        """out_ids: [B,Tout] -> logits [B,Tout,V]."""
        w = self.w
        B, T = out_ids.shape
        x = w["dec/emb"][out_ids] + w["dec/pos"][:T][None]
        causal = np.triu(np.full((T, T), -1e9, dtype=np.float32), 1)
        for i in range(self.cfg["dec_layers"]):
            p = f"dec/l{i}"
            y = self._ln(f"{p}/ln1", x)
            x = x + self._mha(f"{p}/self", y, y, causal)
            x = x + self._mha(f"{p}/cross", self._ln(f"{p}/ln2", x),
                              memory, src_pad)
            x = x + self._ffn(f"{p}/ffn", self._ln(f"{p}/ln3", x))
        x = self._ln("dec/lnf", x)
        return x @ w["dec/emb"].T * self.cfg.get("logit_scale", 1.0) \
            + w["dec/out_b"]

    # ---- decoding ------------------------------------------------------------

    def _encode_word(self, word: str) -> Optional[np.ndarray]:
        ids = [self.in_vocab.get(c) for c in word]
        if None in ids or not ids or len(ids) > self.max_in:
            return None
        return np.asarray(ids, dtype=np.int32)[None]

    def _beam(self, word: str, beam: int) -> Optional[str]:
        """Beam search with the one-primary-stress constraint enforced
        in-path (states carry a stressed flag; a second ˈ is masked)."""
        ids = self._encode_word(word)
        if ids is None:
            return None
        memory, src_pad = self.encode(ids)
        V = len(self.out_syms)
        stress_id = self.out_syms.index("ˈ")
        # hypotheses: (score, tokens, stressed)
        hyps: List[Tuple[float, List[int], bool]] = [(0.0, [BOS], False)]
        done: List[Tuple[float, List[int]]] = []
        for _ in range(self.max_out - 1):
            if not hyps:
                break
            B = len(hyps)
            T = max(len(t) for _, t, _ in hyps)
            batch = np.full((B, T), PAD, dtype=np.int32)
            for bi, (_, toks, _) in enumerate(hyps):
                batch[bi, :len(toks)] = toks
            mem = np.repeat(memory, B, axis=0)
            pad = np.repeat(src_pad, B, axis=0)
            logits = self.decode_logits(batch, mem, pad)
            nxt: List[Tuple[float, List[int], bool]] = []
            for bi, (score, toks, stressed) in enumerate(hyps):
                logp = logits[bi, len(toks) - 1]
                logp = logp - logp.max()
                logp = logp - np.log(np.exp(logp).sum())
                if stressed:
                    logp[stress_id] = -1e9
                logp[PAD] = -1e9
                logp[BOS] = -1e9
                for t in np.argsort(-logp)[:beam]:
                    s = score + float(logp[t])
                    if t == EOS:
                        # unstressed completions are kept too —
                        # en_g2p._stress_lts backstops missing stress
                        done.append((s, toks[1:]))
                    else:
                        nxt.append(
                            (s, toks + [int(t)],
                             stressed or t == stress_id)
                        )
            # length-bucketed prune
            nxt.sort(key=lambda x: -x[0])
            hyps = nxt[:beam]
            if done and len(done) >= beam:
                best_done = max(done, key=lambda x: x[0])[0]
                if all(h[0] < best_done for h in hyps):
                    break
        if not done:
            return None
        done.sort(key=lambda x: -x[0])
        toks = done[0][1]
        return "".join(self.out_syms[t] for t in toks)

    def predict(self, word: str, beam: int = 4) -> Optional[str]:
        """Best decode passing the shared phonotactic gate, or None
        (caller falls back to the n-gram model / hand rules)."""
        word = word.lower()
        with self._memo_lock:
            hit = self._memo.get(word, _MISS)
            if hit is not _MISS:
                self._memo.move_to_end(word)
                return hit
        from .lts_model import LTSModel

        raw = self._beam(word, beam)
        out = LTSModel._sane(self, word, raw)  # shares the gate verbatim
        with self._memo_lock:
            self._memo[word] = out
            if len(self._memo) > self._memo_cap:
                self._memo.popitem(last=False)
        return out

    # the gate calls self._VOWEL_CHARS
    _VOWEL_CHARS = frozenset("aeiouæɑɒɔəɚɛɝɪʊʌ")


_MODEL: Optional[NeuralLTS] = None
_MODEL_LOADED = False
_LOAD_LOCK = threading.Lock()


def get_neural_model() -> Optional[NeuralLTS]:
    global _MODEL, _MODEL_LOADED
    if not _MODEL_LOADED:
        with _LOAD_LOCK:
            if not _MODEL_LOADED:
                _MODEL = NeuralLTS.load()
                _MODEL_LOADED = True
    return _MODEL
