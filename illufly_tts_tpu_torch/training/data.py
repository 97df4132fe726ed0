# -*- coding: utf-8 -*-
"""Dataset loader: wav+transcript directory -> teacher-forced TrainBatch
(PyTorch port of ``illufly_tts_tpu/training/data.py``: numpy throughout,
batches as CPU tensors that the training loop moves to its device;
transcripts go through the port's ``TTSPipeline`` frontend).

The reference ships no training code (SURVEY §0). This makes `train
--data DIR` work on real speech data:

Layouts accepted (auto-detected):
- LJSpeech style: ``metadata.csv`` lines ``utt_id|transcript`` (or
  ``utt_id|raw|normalized``) + ``wavs/utt_id.wav`` (or ``utt_id.wav``)
- paired files: every ``x.wav`` with a sibling ``x.txt`` transcript

Pipeline per utterance:
- transcript -> frontend (normalize + G2P + IPA) -> token ids
- wav -> float32 mono at the model sample rate (linear resample if needed)
- teacher durations: without an external aligner, total frames are
  distributed uniformly across real tokens (rate-matched teacher). The
  duration head then learns utterance-level rate while the waveform losses
  (mel L1 + multi-res STFT, training/step.py) carry the spectral detail.
- style vector: deterministic per-utterance acoustic summary (pooled
  log-mel statistics through a fixed random projection) standing in for
  the StyleTTS2 style encoder, which is out of scope (the inference path
  takes styles from voice packs, engine/synthesizer.py).
"""
from __future__ import annotations

import logging
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..audio.mel import mel_spectrogram
from ..audio.wav import load_wav
from ..model.vocab import encode as encode_phonemes
from .step import TrainBatch

logger = logging.getLogger(__name__)


def scan_dataset(root: str) -> List[Tuple[str, str]]:
    """-> [(wav_path, transcript)], auto-detecting the layout."""
    items: List[Tuple[str, str]] = []
    meta = os.path.join(root, "metadata.csv")
    if os.path.exists(meta):
        with open(meta, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split("|")
                utt = parts[0].strip()
                text = parts[-1].strip()  # normalized column if present
                for cand in (
                    os.path.join(root, "wavs", f"{utt}.wav"),
                    os.path.join(root, f"{utt}.wav"),
                ):
                    if os.path.exists(cand):
                        items.append((cand, text))
                        break
        return items
    for name in sorted(os.listdir(root)):
        if not name.endswith(".wav"):
            continue
        txt = os.path.join(root, name[:-4] + ".txt")
        if os.path.exists(txt):
            with open(txt, encoding="utf-8") as f:
                items.append((os.path.join(root, name), f.read().strip()))
    return items


def _resample_linear(audio: np.ndarray, src: int, dst: int) -> np.ndarray:
    if src == dst:
        return audio
    n_out = int(round(audio.size * dst / src))
    x_out = np.linspace(0.0, audio.size - 1, n_out)
    return np.interp(x_out, np.arange(audio.size), audio).astype(np.float32)


def _style_vector(audio: np.ndarray, dim: int, sample_rate: int,
                  seed: int = 1234) -> np.ndarray:
    """Deterministic acoustic summary -> [dim] style proxy."""
    mel = mel_spectrogram(audio, sample_rate=sample_rate)  # [80, F]
    stats = np.concatenate([mel.mean(axis=1), mel.std(axis=1)])  # [160]
    rng = np.random.RandomState(seed)  # FIXED projection, not per-call
    proj = rng.randn(stats.size, dim).astype(np.float32) / np.sqrt(
        stats.size
    )
    vec = stats.astype(np.float32) @ proj
    return (vec / (np.linalg.norm(vec) + 1e-6)).astype(np.float32)


class _LazyItems:
    """Sequence facade over on-demand utterance loading with a bounded
    LRU — an LJSpeech-scale corpus (~13k utts, ~8 GB of float32 audio)
    must not materialize in RAM at init. Accessed from the single
    prefetch producer thread; the decode cost hides behind the device
    step (see ``prefetch``)."""

    def __init__(self, dataset: "SpeechDataset", cache_items: int):
        from collections import OrderedDict

        self._ds = dataset
        self._cache: "OrderedDict[int, dict]" = OrderedDict()
        self._max = max(1, cache_items)

    def __len__(self) -> int:
        return len(self._ds.pairs)

    def __getitem__(self, i) -> dict:
        i = int(i)
        item = self._cache.get(i)
        if item is None:
            item = self._ds.load_item(i)
            self._cache[i] = item
            if len(self._cache) > self._max:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(i)
        return item


class SpeechDataset:
    """Utterances ready for batching.

    Small corpora (<= ``eager_threshold`` items, the overfit/test regime)
    are materialized up front; larger ones load lazily per access with a
    bounded LRU (``cache_items``) so memory stays flat at any corpus
    size. Force either mode with ``eager=``."""

    def __init__(self, root: str, pipeline=None, sample_rate: int = 24000,
                 style_dim: int = 256, samples_per_frame: int = 600,
                 max_items: Optional[int] = None,
                 eager: Optional[bool] = None,
                 eager_threshold: int = 64,
                 cache_items: int = 256):
        if pipeline is None:
            from ..pipeline import TTSPipeline

            pipeline = TTSPipeline.__new__(TTSPipeline)  # frontend only
            pipeline._init_frontend_only()
        self._pipeline = pipeline
        self._sample_rate = sample_rate
        self._style_dim = style_dim
        self._samples_per_frame = samples_per_frame
        pairs = scan_dataset(root)
        if max_items:
            pairs = pairs[:max_items]
        if not pairs:
            raise ValueError(f"no (wav, transcript) pairs under {root}")
        self.pairs = pairs
        if eager is None:
            eager = len(pairs) <= eager_threshold
        if eager:
            self.items = [self.load_item(i) for i in range(len(pairs))]
        else:
            self.items = _LazyItems(self, cache_items)
        logger.info(
            "dataset: %d utterances from %s (%s)", len(pairs), root,
            "eager" if eager else f"lazy, lru={cache_items}",
        )

    def load_item(self, i: int) -> dict:
        wav_path, text = self.pairs[i]
        audio, sr = load_wav(wav_path)
        audio = _resample_linear(
            np.asarray(audio, np.float32), sr, self._sample_rate
        )
        p = self._pipeline
        phonemes = p.phonemes_to_ipa(
            p.text_to_phonemes(p.preprocess_text(text))
        )
        ids = encode_phonemes(phonemes, max_len=512)
        frames = max(1, audio.size // self._samples_per_frame)
        return {
            "ids": ids,
            "audio": audio[: frames * self._samples_per_frame],
            "frames": frames,
            "style": _style_vector(
                audio, self._style_dim, self._sample_rate
            ),
        }


def dataset_batches(
    dataset: SpeechDataset,
    batch_size: int,
    tokens: int,
    frames: int,
    samples_per_frame: int,
    seed: int = 0,
    shuffle: bool = True,
    vocab_size: Optional[int] = None,
) -> Iterator[TrainBatch]:
    """Endless TrainBatch stream at static (tokens, frames) shapes.

    Audio is padded/truncated to the frame budget; teacher durations
    distribute each utterance's frame count uniformly over its real
    tokens (see module docstring)."""
    rng = np.random.RandomState(seed)
    n = len(dataset.items)
    order = np.arange(n)
    pos = n  # trigger reshuffle on first pull
    while True:
        ids = np.zeros((batch_size, tokens), np.int32)
        mask = np.zeros((batch_size, tokens), np.float32)
        styles = []
        target_dur = np.zeros((batch_size, tokens), np.float32)
        target_audio = np.zeros(
            (batch_size, frames * samples_per_frame), np.float32
        )
        for b in range(batch_size):
            if pos >= n:
                if shuffle:
                    rng.shuffle(order)
                pos = 0
            item = dataset.items[order[pos]]
            pos += 1
            utt_ids = item["ids"][:tokens]
            ln = len(utt_ids)
            ids[b, :ln] = utt_ids
            mask[b, :ln] = 1.0
            utt_frames = min(item["frames"], frames)
            # integer frame distribution summing EXACTLY to utt_frames:
            # the loss teacher-forces round(target_dur), and a uniform
            # utt_frames/ln float can round to 0 everywhere (short clip,
            # long transcript: 8 frames / 16 tokens -> round(0.5) = 0),
            # silently dropping every audio frame from the objective
            base, rem = divmod(utt_frames, max(ln, 1))
            target_dur[b, :ln] = base
            target_dur[b, :rem] += 1.0
            samples = utt_frames * samples_per_frame
            target_audio[b, :samples] = item["audio"][:samples]
            styles.append(item["style"])
        if vocab_size:
            # ids beyond the model's vocab read as unk=0 (an OOB
            # embedding gather is NaN — same guard as the serving path,
            # engine/synthesizer.py dispatch)
            np.putmask(ids, ids >= vocab_size, 0)
        yield TrainBatch(
            input_ids=torch.from_numpy(ids),
            mask=torch.from_numpy(mask),
            ref_s=torch.from_numpy(np.stack(styles)),
            target_dur=torch.from_numpy(target_dur),
            target_audio=torch.from_numpy(target_audio),
        )


def prefetch(batches: Iterator[TrainBatch], depth: int = 2):
    """Wrap a batch iterator with a background producer thread.

    Dataset batches are host-built (wav decode + the Python frontend +
    numpy packing) — run synchronously they serialize with the device
    step and starve the card. A daemon thread keeps up to ``depth``
    batches ready in a bounded queue, so host prep of batch k+1 overlaps
    the device's step k (the training-side analogue of the serving
    scheduler's decode-ahead). Producer exceptions re-raise at the
    consumer's next pull; ordering is preserved."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    _END = object()

    def put(item) -> bool:
        # bounded put that notices consumer shutdown: a plain q.put would
        # block forever once the consumer abandons the generator (train()
        # stops after `steps`), pinning the thread + `depth` device-memory
        # batches per call
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for b in batches:
                if not put(b):
                    return
        except BaseException as exc:  # re-raise in the consumer
            put((_END, exc))
            return
        put((_END, None))

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is _END:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
