# -*- coding: utf-8 -*-
"""TTSPipeline: text -> normalized text -> phonemes -> IPA -> waveform
(PyTorch port of ``illufly_tts_tpu/pipeline.py``).

The same method surface as the JAX pipeline (process / batch_process /
batch_process_texts / stream_process / stream_batch_process / segment_text /
preprocess_text / text_to_phonemes / phonemes_to_ipa / generate_from_phonemes
/ load_voice / list_voices, word timestamps, the split-phase serving surface
and the caches of ``CachedTTSPipeline``), over the port's bucketed two-stage
``Synthesizer``. The text frontend is the JAX package's, copied byte for
byte. The model runs on CUDA unless ``device="cpu"`` is passed; without a
CUDA device and without that argument the constructor raises.
"""
from __future__ import annotations

import logging
import os
import re
import threading
from typing import Dict, Generator, List, Optional, Sequence

import numpy as np

from .audio.wav import save_audio
from .engine.synthesizer import MAX_PHONEMES, Synthesizer
from .frontend.normalization.en import EnTextNormalizer
from .frontend.normalization.zh import ZhTextNormalizer
from .frontend.normalization.en.chronology import verbalize_ordinal

logger = logging.getLogger(__name__)

_CHUNK_PATTERN = re.compile(
    r"([一-鿿㐀-䶿豈-﫿]+)|"          # Chinese
    r"([a-zA-Z]+(?:[\s\-\'\"][a-zA-Z]+)*)|"                   # English words
    # NB no hanzi prefix here: 气温 etc. is always consumed by the Chinese
    # alternative first; temperature context is inferred from prev_type
    r"(-?\d+(?:\.\d+)?(?:°C|℃|度|摄氏度)?)|"                    # numbers
    r"([ -⁯⸀-⹿\'!\"#$%&\(\)*+,\-.\/:;<=>?@\[\]^_`{|}~]+)"
)
_CURRENCY_SYMBOLS = ("￥", "¥", "$", "€", "£", "₽", "₹")


class TTSPipeline:
    def __init__(
        self,
        repo_id: str = "",
        voices_dir: Optional[str] = None,
        device: Optional[str] = None,
        default_language: str = "zh",
        synthesizer: Optional[Synthesizer] = None,
        params_path: Optional[str] = None,
        fail_silent: bool = False,
        mesh=None,
        wire_format: Optional[str] = None,
        british: bool = False,
        frontend_workers: Optional[int] = None,
    ):
        # wire_format='mulaw24k': deployment knob trading audio word depth
        # for device->host bandwidth — PCM-format requests ('f32'/'pcm16')
        # run stage B with the uint8 G.711@24k wire codec (half the pcm16
        # device->host transfer; the serving loop is transfer-bound at b32,
        # docs/ARCHITECTURE.md) and the host expands back to the requested
        # PCM type. Explicit opt-in: audio lands on the 8-bit mu-law grid
        # (G.711 speech quality at 24 kHz). Constant per pipeline, so the
        # audio cache stays consistent.
        if wire_format not in (None, "mulaw24k"):
            raise ValueError(f"unknown wire_format: {wire_format!r}")
        self.wire_format = wire_format
        self.repo_id = repo_id
        self.voices_dir = voices_dir
        self.default_language = default_language
        self.sample_rate = 24000
        # "never crash the server" posture: on model failure return 1 s of
        # silence per item instead of raising (reference kmodel.py:28-30,
        # 147-150). Off by default so errors surface in development.
        self.fail_silent = fail_silent

        # the synthesizer first: without CUDA and without device='cpu' it
        # raises before the frontend loads its lexicons. With a mesh
        # (data- and tensor-parallel serving, parallel/mesh.py) the mesh's
        # devices decide where it runs.
        self.synthesizer = synthesizer or Synthesizer(
            voices_dir=voices_dir, device=device if mesh is None else None,
            mesh=mesh,
            repo_id="" if os.path.isfile(repo_id or "") else repo_id,
        )
        self.device = self.synthesizer.device
        if params_path and os.path.exists(params_path):
            self.synthesizer.load_params(params_path)
        elif repo_id and os.path.isfile(repo_id):
            self.synthesizer.load_params(repo_id)
        # GB English output (reference EnglishG2P(british=True) surface,
        # english_g2p.py:579-597)
        self._init_frontend(british)

        # GIL-bound frontend sharded across worker processes so big-batch
        # G2P overlaps the host dispatch/collect loop (frontend/pool.py;
        # VERDICT r3 next-7). Off by default; serving turns it on via
        # --frontend-workers / TTS_FRONTEND_WORKERS.
        if frontend_workers is None:
            frontend_workers = int(
                os.environ.get("TTS_FRONTEND_WORKERS", "0") or 0
            )
        self._frontend_pool = None
        # pooling needs spare cores: on a single-CPU host the workers
        # timeshare the one core with the dispatch/collect loop and a
        # 32-row batch measured ~860 ms pooled vs ~60 ms serial-warm
        # (the serial path's memoization caches do the heavy lifting) —
        # strictly worse, so the pool self-disables there
        pool_force = os.environ.get("TTS_FRONTEND_POOL_FORCE") == "1"
        n_cpu = os.cpu_count() or 1
        if frontend_workers > 0 and (n_cpu >= 2 or pool_force):
            from .frontend.pool import FrontendPool

            self._frontend_pool = FrontendPool(
                frontend_workers if pool_force
                else min(frontend_workers, max(1, n_cpu - 1)),
                default_language=default_language,
                british=british,
            )
        elif frontend_workers > 0:
            logger.info(
                "frontend pool disabled: single-CPU host (serial path "
                "with memoization is faster)"
            )

        self.sample_rate = self.synthesizer.sample_rate
        logger.info("TTSPipeline ready (device=%s)", self.device)

    def _init_frontend(self, british: bool) -> None:
        """Build the text frontend: the normalizers and the G2P. The G2P
        imports here, not at module top: its Chinese side needs ``jieba``,
        so this module imports without it."""
        from .frontend.g2p.chinese_g2p import ChineseG2P
        from .frontend.g2p.en_g2p import EnglishG2P

        self.british = british
        self.en_g2p = EnglishG2P(british=british)
        self.en_callback = self.en_g2p.text_to_ipa
        self.g2p = ChineseG2P(en_callable=self.en_callback)
        self.zh_normalizer = ZhTextNormalizer()
        self.en_normalizer = EnTextNormalizer()

    def _init_frontend_only(self, default_language: str = "zh",
                            british: bool = False) -> None:
        """Construct ONLY the text frontend (no synthesizer, no device
        state). Used by frontend.pool workers (one frontend per process),
        which must never touch CUDA."""
        self.repo_id = ""
        self.voices_dir = None
        self.device = None
        self.default_language = default_language
        self.sample_rate = 24000
        self.fail_silent = False
        self._init_frontend(british)
        self.synthesizer = None
        self.wire_format = None
        self._frontend_pool = None

    # --- voices ---------------------------------------------------------------

    def load_voice(self, voice_id: str):
        return self.synthesizer.load_voice(voice_id)

    def list_voices(self) -> List[str]:
        return self.synthesizer.list_voices()

    # --- text processing --------------------------------------------------------

    def _ipa_within_budget(self, segment: str, _depth: int = 0) -> List[str]:
        """IPA for one text segment, split so every piece fits the
        510-phoneme model budget.

        ``segment_text`` packs by CHARACTER count (reference
        pipeline.py:111-146), but phoneme counts per char vary ~1-4x, so
        a dense 400-char segment can exceed 510 phonemes — the reference
        then silently TRUNCATES, dropping words (pipeline.py:191-193).
        Here an over-budget segment re-splits at the punctuation boundary
        nearest its middle (hard midpoint as last resort) and recurses,
        so long-text synthesis renders every word."""
        ipa = self.phonemes_to_ipa(self.text_to_phonemes(segment))
        if len(ipa) <= MAX_PHONEMES or len(segment) < 2 or _depth > 8:
            return [ipa]
        mid = len(segment) // 2
        cut = None
        for m in re.finditer(r"[。！？.!?，,、；;：:\s]+", segment):
            if m.end() >= len(segment):
                continue
            if cut is None or abs(m.end() - mid) < abs(cut - mid):
                cut = m.end()
        if cut is None or cut == 0:
            cut = mid
        return (
            self._ipa_within_budget(segment[:cut], _depth + 1)
            + self._ipa_within_budget(segment[cut:], _depth + 1)
        )

    def segment_text(self, text: str, max_len: int = 400) -> List[str]:
        """Sentence-pack segments of <= max_len chars
        (reference pipeline.py:111-146 semantics)."""
        sentences = re.split(r"([。！？.!?]+)", text)
        chunks: List[str] = []
        current = ""
        for i in range(0, len(sentences), 2):
            sentence = sentences[i]
            if i + 1 < len(sentences):
                sentence += sentences[i + 1]
            if len(current) + len(sentence) <= max_len:
                current += sentence
            else:
                if current:
                    chunks.append(current)
                current = sentence
        if current:
            chunks.append(current)
        if not chunks:
            chunks = [text[i:i + max_len] for i in range(0, len(text), max_len)]
        return chunks

    def preprocess_text(self, text: str) -> str:
        """Split into zh/en/number/punct chunks, infer number language from
        context, normalize per language (reference pipeline.py:208-374)."""
        chunks = []
        last_end = 0
        for match in _CHUNK_PATTERN.finditer(text):
            if match.start() > last_end:
                unmatched = text[last_end:match.start()]
                if unmatched.strip():
                    chunks.append((None, unmatched))
                elif unmatched and chunks:
                    # whitespace gap: keep it attached to the previous chunk
                    # so the en normalizer sees real word boundaries
                    chunks.append((chunks[-1][0], unmatched))
            if match.group(1):
                chunks.append(("zh", match.group(1)))
            elif match.group(2):
                chunks.append(("en", match.group(2)))
            elif match.group(3):
                number_text = match.group(3)
                has_temp = any(
                    u in number_text
                    for u in ("°C", "℃", "度", "摄氏度")
                )
                prev_type = chunks[-1][0] if chunks else None
                prev_char = text[match.start() - 1:match.start()]
                next_char = text[match.end():match.end() + 1]
                is_zh = (
                    has_temp
                    or (next_char and "一" <= next_char <= "鿿")
                    or prev_type == "zh"
                    or (prev_char and "一" <= prev_char <= "鿿")
                )
                is_en = prev_type == "en" or (
                    next_char.isalpha()
                    and not "一" <= next_char <= "鿿"
                )
                lang = "zh" if is_zh else ("en" if is_en else None)
                if lang is None:
                    lang = self.default_language
                chunks.append((lang, number_text))
            else:
                prev_type = chunks[-1][0] if chunks else None
                chunks.append((prev_type or "zh", match.group(4)))
            last_end = match.end()
        if last_end < len(text):
            unmatched = text[last_end:]
            if unmatched.strip():
                chunks.append((None, unmatched))

        # merge adjacent same-type chunks
        merged = []
        cur_type, cur_text = None, ""
        for ctype, ctext in chunks:
            if ctype == cur_type:
                cur_text += ctext
            else:
                if cur_text:
                    merged.append((cur_type, cur_text))
                cur_type, cur_text = ctype, ctext
        if cur_text:
            merged.append((cur_type, cur_text))

        segments: List[str] = []
        for ctype, ctext in merged:
            if ctype == "zh":
                normalized = "".join(self.zh_normalizer.normalize(ctext))
            else:
                normalized = self.en_normalizer.normalize(ctext)
                normalized = re.sub(
                    r"(\w+)(\d+|ten|twenty|thirty|forty|fifty|sixty|seventy"
                    r"|eighty|ninety)",
                    r"\1 \2",
                    normalized,
                )
            if (
                segments
                and ctype == "en"
                and not normalized.startswith(" ")
                and not segments[-1].endswith(" ")
            ):
                segments.append(" ")
            segments.append(normalized)
        result = "".join(segments)

        # zh-context currency amounts (reference pipeline.py:324-340)
        zh_currency = re.compile(
            r"([一-鿿])?([￥¥$€£₽₹])?\s*(\d+(?:\.\d+)?)"
            r"([一-鿿])?"
        )

        def fix_currency(match: re.Match) -> str:
            prev_cn, currency, amount, next_cn = match.groups()
            if (prev_cn or next_cn or currency in ("￥", "¥")) and amount:
                amount_zh = "".join(self.zh_normalizer.normalize(amount))
                return (
                    f"{prev_cn or ''}{currency or ''}{amount_zh}"
                    f"{next_cn or ''}"
                )
            return match.group(0)

        result = zh_currency.sub(fix_currency, result)

        # English ordinal dates left as "June 1st" (reference pipeline.py:343-371)
        month_pattern = re.compile(
            r"(January|February|March|April|May|June|July|August|September"
            r"|October|November|December)\s+(\d{1,2})(st|nd|rd|th)",
            re.IGNORECASE,
        )
        result = month_pattern.sub(
            lambda m: f"{m.group(1)} {verbalize_ordinal(int(m.group(2)))}",
            result,
        )
        return result

    def text_to_phonemes(self, text: str) -> str:
        return self.g2p.text_to_phonemes(text)

    def phonemes_to_ipa(self, phonemes: str) -> str:
        return self.g2p.convert_to_ipa(phonemes)

    def arpa_to_ipa(self, arpa_phonemes: str) -> str:
        """ARPAbet -> IPA (reference pipeline.py:515-550; here with CMU
        stress-digit handling, see frontend/g2p/arpa.py)."""
        from .frontend.g2p.arpa import arpa_to_ipa

        return arpa_to_ipa(arpa_phonemes)

    # --- synthesis ---------------------------------------------------------------

    def generate_from_phonemes(
        self, phonemes: str, voice_id: str = "zf_001", speed: float = 1.0,
        pitch: float = 1.0,
    ) -> np.ndarray:
        if len(phonemes) > MAX_PHONEMES:
            logger.warning(
                "phoneme sequence too long (%d), truncating to %d",
                len(phonemes), MAX_PHONEMES,
            )
            phonemes = phonemes[:MAX_PHONEMES]
        return self.synthesizer.synthesize_batch(
            [phonemes], [voice_id], [speed], pitches=[pitch]
        )[0]

    def process(
        self,
        text: str,
        voice_id: str,
        speed: float = 1.0,
        output_path: Optional[str] = None,
        segment_text: bool = False,
        pitch: float = 1.0,
    ) -> np.ndarray:
        normalized = self.preprocess_text(text)
        if segment_text:
            segments = self.segment_text(normalized)
            parts = []
            for seg in segments:
                for ipa in self._ipa_within_budget(seg):
                    parts.append(self.generate_from_phonemes(
                        ipa, voice_id, speed, pitch=pitch
                    ))
            audio = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        else:
            ipa = self.phonemes_to_ipa(self.text_to_phonemes(normalized))
            audio = self.generate_from_phonemes(ipa, voice_id, speed,
                                                pitch=pitch)
        if output_path:
            os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
            save_audio(output_path, audio, self.sample_rate)
        return audio

    def process_with_timestamps(
        self,
        text: str,
        voice_id: str,
        speed: float = 1.0,
        output_path: Optional[str] = None,
        pitch: float = 1.0,
    ):
        """Synthesize and return ``(audio, words)`` where ``words`` is
        ``[{"text", "phonemes", "start_s", "end_s"}, ...]`` — word-level
        timestamps derived from the duration predictor's quantized
        per-phoneme frame counts (the exact alignment stage B renders,
        engine/synthesizer.py::rendered_durations), not a post-hoc
        forced alignment. Beyond-reference: the reference's MToken
        start_ts/end_ts fields exist but are never populated
        (english_g2p.py:640,698). Surfaces: this method, the
        ``return_timestamps`` HTTP/scheduler flag, and `synth --timestamps`."""
        normalized = self.preprocess_text(text)
        ipa = self.phonemes_to_ipa(self.text_to_phonemes(normalized))
        ipa = ipa[:MAX_PHONEMES]
        handle = self.synthesizer.dispatch(
            [ipa], [voice_id], [speed], keep_durations=True,
            pitches=[pitch],
        )
        audio = self.synthesizer.collect(handle)[0]
        fitted = self.synthesizer.rendered_durations(handle)[0]
        words = self._word_timestamps(normalized, ipa, fitted, handle.t_bucket)
        if output_path:
            os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
            save_audio(output_path, audio, self.sample_rate)
        return audio, words

    def _word_timestamps(self, normalized: str, ipa: str, fitted, t_bucket):
        """Map per-token rendered frame counts to word spans.

        The encoded sequence is BOS + kept-vocab chars of ``ipa`` + EOS
        (model/vocab.py::encode drops unknown chars and truncates), so
        phoneme char k sits at token position k+1; a word's span is the
        prefix-sum window over its chars' tokens. Words come from
        ``ChineseG2P.text_to_ipa_words`` and are located in ``ipa`` by
        monotone substring search — a word that fails to locate (exotic
        normalization edge) is skipped rather than guessed."""
        from .model.vocab import VOCAB

        spf = self.synthesizer.config.samples_per_frame
        sec = spf / float(self.sample_rate)
        kept_pos = {}
        k = 0
        max_kept = t_bucket - 2
        for i, c in enumerate(ipa):
            if c in VOCAB:
                if k >= max_kept:
                    break
                kept_pos[i] = k
                k += 1
        prefix = np.concatenate(
            [[0], np.cumsum(np.asarray(fitted, np.int64))]
        )
        words = []
        cursor = 0
        for surface, wipa in self.g2p.text_to_ipa_words(normalized):
            if not wipa:
                continue
            idx = ipa.find(wipa, cursor)
            if idx < 0:
                continue
            cursor = idx + len(wipa)
            ks = [
                kept_pos[i]
                for i in range(idx, idx + len(wipa))
                if i in kept_pos
            ]
            if not ks:
                continue
            words.append({
                "text": surface,
                "phonemes": wipa,
                "start_s": round(float(prefix[ks[0] + 1]) * sec, 4),
                "end_s": round(float(prefix[ks[-1] + 2]) * sec, 4),
            })
        return words

    def stream_process(
        self,
        text: str,
        voice_id: str = "zf_001",
        speed: float = 1.0,
        window_frames: int = 64,
        halo_frames: int = 16,
        pitch: float = 1.0,
        exact: bool = True,
    ):
        """Yield waveform chunks for ONE utterance (intra-utterance
        streaming, one level deeper than the reference's chunk-synchronous
        stream_batch_process, reference pipeline.py:616-663).

        ``exact=True`` (default): the streamed concatenation is bitwise
        equal to ``process()`` — the batch stage-B program renders once
        and chunks are incremental device→host slices; first audio after
        the full render (~batch-1 latency). ``exact=False``: low-TTFA
        windowed decode — first audio after ONE window
        (~window_frames/40 s of content), crossfaded at window seams
        (engine/synthesizer.py stream_decode)."""
        normalized = self.preprocess_text(text)
        ipa = self.phonemes_to_ipa(self.text_to_phonemes(normalized))
        ipa = ipa[:MAX_PHONEMES]
        handle = self.synthesizer.dispatch([ipa], [voice_id], [speed],
                                           pitches=[pitch])
        yield from self._stream_chunks(handle, window_frames, halo_frames,
                                       exact)

    def _stream_chunks(self, handle, window_frames: int, halo_frames: int,
                       exact: bool = True):
        total = None
        emitted = 0
        for chunk in self.synthesizer.stream_decode(
            handle, window_frames=window_frames, halo_frames=halo_frames,
            exact=exact,
        ):
            if total is None:
                total = int(handle.fitted_totals[0]) * (
                    self.synthesizer.config.samples_per_frame
                )
            take = min(chunk.shape[1], max(total - emitted, 0))
            if take > 0:
                yield chunk[0, :take]
            emitted += chunk.shape[1]

    def stream_process_with_timestamps(
        self,
        text: str,
        voice_id: str = "zf_001",
        speed: float = 1.0,
        window_frames: int = 64,
        halo_frames: int = 16,
        pitch: float = 1.0,
        exact: bool = True,
    ):
        """``(words, chunk_generator)`` for one utterance: intra-utterance
        streaming (``stream_process``, same ``exact`` semantics) plus word
        timestamps. The stamps come from stage A's quantized durations,
        which are known at dispatch — BEFORE any audio has rendered — so a
        caller (karaoke captions, avatar lip-sync) has the full word
        timeline in hand when the first chunk arrives."""
        normalized = self.preprocess_text(text)
        ipa = self.phonemes_to_ipa(self.text_to_phonemes(normalized))
        ipa = ipa[:MAX_PHONEMES]
        handle = self.synthesizer.dispatch(
            [ipa], [voice_id], [speed], keep_durations=True,
            pitches=[pitch],
        )
        fitted = self.synthesizer.rendered_durations(handle)[0]
        words = self._word_timestamps(normalized, ipa, fitted, handle.t_bucket)
        return words, self._stream_chunks(handle, window_frames,
                                          halo_frames, exact)

    def batch_process(
        self,
        texts: Sequence[str],
        voice_id: str,
        speed: float = 1.0,
        output_dir: Optional[str] = None,
        output_prefix: str = "tts_output",
    ) -> List[np.ndarray]:
        results = []
        for i, text in enumerate(texts):
            path = (
                os.path.join(output_dir, f"{output_prefix}_{i + 1}.wav")
                if output_dir else None
            )
            results.append(self.process(text, voice_id, speed, path))
        return results

    def batch_process_texts(
        self,
        texts: Sequence[str],
        voice_ids: Sequence[str],
        speeds: Optional[Sequence[float]] = None,
        output_format: str = "f32",
        pitches: Optional[Sequence[float]] = None,
    ) -> List[np.ndarray]:
        """One fused batched model call for many texts
        (reference pipeline.py:556-614).

        ``output_format``: 'f32' (float32 @24k, default), 'pcm16'
        (int16 @24k), 'mulaw8k' (uint8 G.711 @8k — the resample +
        companding run inside the decode program; audio/telephony.py),
        or 'mulaw24k' (int16 @24k delivered over a G.711 wire: the
        device ships 1 byte/sample and the host expands — half the
        pcm16 device->host transfer for 8-bit mu-law quality)."""
        if speeds is None:
            speeds = [1.0] * len(texts)
        if output_format not in ("f32", "pcm16", "mulaw8k", "mulaw24k"):
            raise ValueError(f"unknown output_format: {output_format!r}")
        try:
            ipa_list = self._texts_to_ipa(texts)
            fmt, pcm16 = self._device_fmt(output_format)
            return self.synthesizer.synthesize_batch(
                ipa_list, voice_ids, speeds, pcm16=pcm16, fmt=fmt,
                pitches=pitches,
            )
        except Exception:
            if not self.fail_silent:
                raise
            logger.exception("synthesis failed; returning silence")
            return [self._silence(output_format) for _ in texts]

    def batch_process_texts_with_timestamps(
        self,
        texts: Sequence[str],
        voice_ids: Sequence[str],
        speeds: Optional[Sequence[float]] = None,
        output_format: str = "f32",
        want: Optional[Sequence[bool]] = None,
        pitches: Optional[Sequence[float]] = None,
    ):
        """Like ``batch_process_texts`` but returns ``(audios, stamps)``
        where ``stamps[i]`` is the word-timestamp list for item i (see
        ``process_with_timestamps``), or None for items whose ``want[i]``
        is False (their frontend is not re-walked). One fused batched
        model call; the batch must fit the largest batch bucket (the
        scheduler's batch_size always does)."""
        if speeds is None:
            speeds = [1.0] * len(texts)
        if output_format not in ("f32", "pcm16", "mulaw8k", "mulaw24k"):
            raise ValueError(f"unknown output_format: {output_format!r}")
        from .utils.profiling import TIMERS

        try:
            with TIMERS.track("frontend"):
                normalized = [self.preprocess_text(t) for t in texts]
                ipa_list = [
                    self.phonemes_to_ipa(self.text_to_phonemes(n))[
                        :MAX_PHONEMES
                    ]
                    for n in normalized
                ]
            fmt, pcm16 = self._device_fmt(output_format)
            handle = self.synthesizer.dispatch(
                ipa_list, voice_ids, speeds, fmt=fmt,
                keep_durations=True, pitches=pitches,
            )
            audios = self.synthesizer.collect(handle, pcm16=pcm16)
            fitted = self.synthesizer.rendered_durations(handle)
        except Exception:
            if not self.fail_silent:
                raise
            logger.exception("synthesis failed; returning silence")
            return (
                [self._silence(output_format) for _ in texts],
                [None] * len(texts),
            )
        stamps = []
        for i, (n, ipa) in enumerate(zip(normalized, ipa_list)):
            if want is not None and not want[i]:
                stamps.append(None)
            else:
                stamps.append(
                    self._word_timestamps(n, ipa, fitted[i], handle.t_bucket)
                )
        return audios, stamps

    def _texts_to_ipa(self, texts: Sequence[str]) -> List[str]:
        from .utils.profiling import TIMERS

        with TIMERS.track("frontend"):
            if self._frontend_pool is not None:
                pooled = self._frontend_pool.texts_to_ipa(texts)
                if pooled is not None:
                    return pooled
            return [
                self.phonemes_to_ipa(
                    self.text_to_phonemes(self.preprocess_text(t))
                )[:MAX_PHONEMES]
                for t in texts
            ]

    # --- split-phase serving surface (decode-ahead pipelining) ------------------

    @property
    def supports_split_phase(self) -> bool:
        """True when a caller (the scheduler) may drive this pipeline
        through ``dispatch_texts``/``launch_decode``/``collect_batch``
        instead of the blocking ``batch_process_texts``. ``fail_silent``
        pipelines opt out (the silence fallback is a batch_process_texts
        behavior). The cached subclass PARTICIPATES: it overrides the
        split-phase surface with cache-hit pre-fill (see
        CachedTTSPipeline.dispatch_texts)."""
        return not self.fail_silent

    def dispatch_texts(
        self,
        texts: Sequence[str],
        voice_ids: Sequence[str],
        speeds: Optional[Sequence[float]] = None,
        output_format: str = "f32",
        want_timestamps: Optional[Sequence[bool]] = None,
        pitches: Optional[Sequence[float]] = None,
    ):
        """Frontend + stage A for one batch; returns an opaque handle for
        ``launch_decode``/``collect_batch``. Splitting the phases lets the
        scheduler keep batch k+1's stage B on the device while batch k's
        audio streams to host — the schedule that takes the device loop
        from ~sum(stages) to ~max(compute, transfer) per batch (bench.py
        pinned loop). The batch must fit the largest batch bucket (the
        scheduler's batch_size always does). ``want_timestamps[i]`` asks
        for word timestamps for row i (fetched after ``collect_batch``
        via ``collect_timestamps``) — the duration capture rides the same
        dispatch, so timestamped batches keep the decode-ahead overlap."""
        if output_format not in ("f32", "pcm16", "mulaw8k", "mulaw24k"):
            raise ValueError(f"unknown output_format: {output_format!r}")
        keep = want_timestamps is not None and any(want_timestamps)
        if keep:
            from .utils.profiling import TIMERS

            with TIMERS.track("frontend"):
                normalized = [self.preprocess_text(t) for t in texts]
                ipa_list = [
                    self.phonemes_to_ipa(self.text_to_phonemes(n))[
                        :MAX_PHONEMES
                    ]
                    for n in normalized
                ]
        else:
            normalized = None
            ipa_list = self._texts_to_ipa(texts)
        fmt, _ = self._device_fmt(output_format)
        handle = self.synthesizer.dispatch(
            ipa_list, voice_ids, speeds, fmt=fmt, keep_durations=keep,
            pitches=pitches,
        )
        if keep:
            handle.ts_ctx = (normalized, ipa_list, list(want_timestamps))
        return handle

    def collect_timestamps(self, handle):
        """Word timestamps for a split-phase batch dispatched with
        ``want_timestamps``: ``[stamps_or_None] * n`` aligned to the batch
        rows (None where the row didn't ask). Call after
        ``collect_batch`` — the host duration copy rides the same
        readback, so this is pure host work."""
        ctx = getattr(handle, "ts_ctx", None)
        if ctx is None:
            raise ValueError(
                "dispatch_texts(..., want_timestamps=...) required for "
                "collect_timestamps"
            )
        normalized, ipa_list, want = ctx
        fitted = self.synthesizer.rendered_durations(handle)
        return [
            self._word_timestamps(n, ipa, fitted[i], handle.t_bucket)
            if want[i] else None
            for i, (n, ipa) in enumerate(zip(normalized, ipa_list))
        ]

    def launch_decode(self, handle):
        """Launch stage B for a dispatched batch (async, idempotent)."""
        return self.synthesizer.launch_decode(handle)

    def collect_batch(self, handle, output_format: str = "f32"):
        """Fetch a dispatched batch's audio in the requested format."""
        return self.synthesizer.collect(
            handle, pcm16=(output_format in ("pcm16", "mulaw24k"))
        )

    def _device_fmt(self, output_format: str):
        """Map a requested output format to ``(device fmt, pcm16 flag)``
        for the synthesizer. PCM formats ('f32'/'pcm16') ride the G.711
        wire codec when ``wire_format='mulaw24k'`` is set — the device
        ships 1 byte/sample and ``collect`` expands back to the requested
        PCM type on the host."""
        if output_format == "mulaw8k":
            return "mulaw8k", False
        if output_format == "mulaw24k":
            return "mulaw24k", True
        if self.wire_format == "mulaw24k":
            return "mulaw24k", output_format == "pcm16"
        return "pcm16", output_format == "pcm16"

    def _silence(self, output_format: str) -> np.ndarray:
        """One second of silence in the requested format (0xFF is the
        mu-law code for 0)."""
        if output_format == "mulaw8k":
            from .audio.telephony import TELEPHONY_RATE

            return np.full(TELEPHONY_RATE, 0xFF, np.uint8)
        if output_format in ("pcm16", "mulaw24k"):
            return np.zeros(self.sample_rate, np.int16)
        return np.zeros(self.sample_rate, np.float32)

    def output_rate(self, output_format: str = "f32") -> int:
        """Sample rate of a given output format's waveform."""
        if output_format == "mulaw8k":
            from .audio.telephony import TELEPHONY_RATE

            return TELEPHONY_RATE
        return self.sample_rate

    async def async_batch_process_texts(self, texts, voice_ids, speeds=None):
        return self.batch_process_texts(texts, voice_ids, speeds)

    def stream_batch_process(
        self,
        long_texts: Sequence[str],
        voice_ids: Sequence[str],
        speeds: Optional[Sequence[float]] = None,
        chunk_size: int = 200,
    ) -> Generator[List[np.ndarray], None, None]:
        """Chunk-synchronous round-robin over long texts
        (reference pipeline.py:616-663)."""
        if speeds is None:
            speeds = [1.0] * len(long_texts)
        chunk_lists = [self.segment_text(t, chunk_size) for t in long_texts]
        max_chunks = max(len(c) for c in chunk_lists) if chunk_lists else 0
        for i in range(max_chunks):
            cur_texts, cur_voices, cur_speeds = [], [], []
            for idx, chunks in enumerate(chunk_lists):
                if i < len(chunks):
                    cur_texts.append(chunks[i])
                    cur_voices.append(voice_ids[idx])
                    cur_speeds.append(speeds[idx])
            if cur_texts:
                yield self.batch_process_texts(
                    cur_texts, cur_voices, cur_speeds
                )


class _CachedDispatch:
    """CachedTTSPipeline's split-phase handle: cache hits pre-filled at
    dispatch time; ``inner`` is the device handle for the deduped misses
    (None when every row hit)."""

    __slots__ = ("inner", "results", "uncached", "unique_row", "keys",
                 "want", "stamps")

    def __init__(self):
        self.inner = None
        self.results: List[Optional[np.ndarray]] = []
        self.uncached: List[int] = []
        self.unique_row: Dict[int, int] = {}
        self.keys: Dict[int, str] = {}
        self.want: Optional[List[bool]] = None
        self.stamps: Optional[List[Optional[list]]] = None


class CachedTTSPipeline(TTSPipeline):
    """Adds transparent caching of every frontend stage + audio results
    (reference pipeline.py:665-832)."""

    # memory bounds for long-running servers (oldest-inserted evicted first)
    TEXT_CACHE_LIMIT = 20000
    AUDIO_CACHE_LIMIT = 512
    # the frontend's three caches and the audio cache (rows served from it,
    # counted in ``_plan_audio_batch``)
    CACHE_KINDS = ("text", "phoneme", "ipa", "audio")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._cache: Dict[str, object] = {}
        self._audio_cache: Dict[str, np.ndarray] = {}
        # the scheduler runs dispatch_texts concurrently from worker
        # threads (pipeline_depth >= 2); unguarded check-then-pop
        # eviction races once a cache hits its limit
        self._cache_lock = threading.Lock()
        self.cache_stats = {
            f"{k}_{kind}": 0
            for k in self.CACHE_KINDS
            for kind in ("hits", "misses")
        }

    def _cached(self, kind: str, key: str, compute):
        cache_key = f"{kind}:{key}"
        with self._cache_lock:
            if cache_key in self._cache:
                self.cache_stats[f"{kind}_hits"] += 1
                return self._cache[cache_key]
        # compute outside the lock: concurrent misses on the same key do
        # duplicate work (benign) instead of serializing the frontend
        result = compute()
        with self._cache_lock:
            if len(self._cache) >= self.TEXT_CACHE_LIMIT:
                self._cache.pop(next(iter(self._cache)))
            self._cache[cache_key] = result
            self.cache_stats[f"{kind}_misses"] += 1
        return result

    def _audio_cache_get(self, key: str) -> Optional[np.ndarray]:
        with self._cache_lock:
            return self._audio_cache.get(key)

    def _audio_cache_put(self, key: str, audio: np.ndarray) -> None:
        with self._cache_lock:
            if len(self._audio_cache) >= self.AUDIO_CACHE_LIMIT:
                self._audio_cache.pop(next(iter(self._audio_cache)))
            self._audio_cache[key] = audio

    # cache keys are the full input string — Python's 64-bit hash() (the
    # reference's key, pipeline.py:706-754) can collide and silently serve
    # another request's result; dict interning makes the exact key free
    def preprocess_text(self, text: str) -> str:
        return self._cached(
            "text", text, lambda: super(
                CachedTTSPipeline, self
            ).preprocess_text(text)
        )

    def text_to_phonemes(self, text: str) -> str:
        return self._cached(
            "phoneme", text, lambda: super(
                CachedTTSPipeline, self
            ).text_to_phonemes(text)
        )

    def phonemes_to_ipa(self, phonemes: str) -> str:
        return self._cached(
            "ipa", phonemes, lambda: super(
                CachedTTSPipeline, self
            ).phonemes_to_ipa(phonemes)
        )

    def get_cache_stats(self) -> Dict[str, float]:
        with self._cache_lock:
            stats = dict(self.cache_stats)
        for kind in self.CACHE_KINDS:
            hits = stats[f"{kind}_hits"]
            misses = stats[f"{kind}_misses"]
            total = hits + misses
            stats[f"{kind}_hit_rate"] = hits / total if total else 0.0
        return stats

    def clear_caches(self) -> None:
        self._cache.clear()
        self._audio_cache.clear()

    def is_voice_loaded(self, voice_id: str) -> bool:
        return self.synthesizer.is_voice_loaded(voice_id)

    @staticmethod
    def _audio_key(fmt: str, voice: str, speed, text: str,
                   pitch=1.0) -> str:
        # the ONE place the audio-cache key format is spelled (reference
        # scheme pipeline.py:800-815 + fmt/pitch components). Fixed-form
        # components all come BEFORE the free text — text is the last
        # component so its embedded colons stay unambiguous — and the
        # pitch component is UNconditional: an optional tag collides a
        # neutral text that happens to start with 'p2.0:' with the real
        # pitched request
        return f"audio:{fmt}:{voice}:{speed}:p{pitch}:{text}"

    def _plan_audio_batch(self, texts, voice_ids, speeds, output_format,
                          want=None, stamps=None, pitches=None):
        """Shared hit/dedup plan for the split-phase and blocking paths:
        -> (results with hits pre-filled, uncached rows, row->unique-slot
        map, row->cache-key map, unique compute rows). A row that wants
        timestamps (``want[i]``) only counts as a hit when its stamps are
        cached too (filled into ``stamps[i]``); otherwise it recomputes."""
        if pitches is None:
            pitches = [1.0] * len(texts)
        results: List[Optional[np.ndarray]] = []
        uncached: List[int] = []
        for i, (text, voice, speed) in enumerate(
            zip(texts, voice_ids, speeds)
        ):
            key = self._audio_key(output_format, voice, speed, text,
                                  pitches[i])
            audio = self._audio_cache_get(key)
            if audio is not None and want is not None and want[i]:
                st = self._audio_cache_get("stamps:" + key)
                if st is None:
                    audio = None  # audio hit without stamps: recompute
                else:
                    stamps[i] = st
            results.append(audio)
            if audio is None:
                uncached.append(i)
        with self._cache_lock:
            self.cache_stats["audio_hits"] += len(texts) - len(uncached)
            self.cache_stats["audio_misses"] += len(uncached)
        # dedup identical (text, voice, speed, pitch) inside the batch
        # (reference pipeline.py:574-584)
        unique: Dict[tuple, int] = {}
        compute_idx: List[int] = []
        for i in uncached:
            sig = (texts[i], voice_ids[i], speeds[i], pitches[i])
            if sig not in unique:
                unique[sig] = len(compute_idx)
                compute_idx.append(i)
        unique_row = {
            i: unique[(texts[i], voice_ids[i], speeds[i], pitches[i])]
            for i in uncached
        }
        keys = {
            i: self._audio_key(
                output_format, voice_ids[i], speeds[i], texts[i],
                pitches[i],
            )
            for i in uncached
        }
        return results, uncached, unique_row, keys, compute_idx

    def dispatch_texts(self, texts, voice_ids, speeds=None,
                       output_format="f32", want_timestamps=None,
                       pitches=None):
        """Split-phase dispatch with the audio cache applied first: cached
        rows are pre-filled, only the deduped misses go to the device (the
        same hit/dedup scheme as batch_process_texts). Timestamped rows
        hit only when their stamps are cached alongside the audio."""
        if speeds is None:
            speeds = [1.0] * len(texts)
        if pitches is None:
            pitches = [1.0] * len(texts)
        if output_format not in ("f32", "pcm16", "mulaw8k", "mulaw24k"):
            raise ValueError(f"unknown output_format: {output_format!r}")
        h = _CachedDispatch()
        if want_timestamps is not None and any(want_timestamps):
            h.want = list(want_timestamps)
            h.stamps = [None] * len(texts)
        (h.results, h.uncached, h.unique_row, h.keys,
         compute_idx) = self._plan_audio_batch(
            texts, voice_ids, speeds, output_format,
            want=h.want, stamps=h.stamps, pitches=pitches,
        )
        if h.uncached:
            compute_want = None
            if h.want is not None:
                # a unique compute slot wants durations when ANY row
                # deduped onto it asks for timestamps
                slot_want = [False] * len(compute_idx)
                for i in h.uncached:
                    if h.want[i]:
                        slot_want[h.unique_row[i]] = True
                if any(slot_want):
                    compute_want = slot_want
            h.inner = super().dispatch_texts(
                [texts[i] for i in compute_idx],
                [voice_ids[i] for i in compute_idx],
                [speeds[i] for i in compute_idx],
                output_format=output_format,
                want_timestamps=compute_want,
                pitches=[pitches[i] for i in compute_idx],
            )
        return h

    def launch_decode(self, handle):
        if handle.inner is not None:
            self.synthesizer.launch_decode(handle.inner)
        return handle

    def collect_batch(self, handle, output_format="f32"):
        if handle.inner is not None:
            fresh = super().collect_batch(handle.inner, output_format)
            fresh_stamps = None
            if (handle.want is not None
                    and getattr(handle.inner, "ts_ctx", None) is not None):
                fresh_stamps = super().collect_timestamps(handle.inner)
            for i in handle.uncached:
                audio = fresh[handle.unique_row[i]]
                handle.results[i] = audio
                self._audio_cache_put(handle.keys[i], audio)
                if fresh_stamps is not None and handle.want[i]:
                    st = fresh_stamps[handle.unique_row[i]]
                    handle.stamps[i] = st
                    self._audio_cache_put("stamps:" + handle.keys[i], st)
        return handle.results

    def collect_timestamps(self, handle):
        """Stamps for a ``want_timestamps`` dispatch: cache hits were
        pre-filled at dispatch, fresh rows during ``collect_batch``."""
        if handle.want is None:
            raise ValueError(
                "dispatch_texts(..., want_timestamps=...) required for "
                "collect_timestamps"
            )
        return handle.stamps

    def batch_process_texts(self, texts, voice_ids, speeds=None,
                            output_format="f32", pitches=None):
        if speeds is None:
            speeds = [1.0] * len(texts)
        if pitches is None:
            pitches = [1.0] * len(texts)
        results, uncached, unique_row, keys, compute_idx = (
            self._plan_audio_batch(texts, voice_ids, speeds, output_format,
                                   pitches=pitches)
        )
        if uncached:
            fresh = super().batch_process_texts(
                [texts[i] for i in compute_idx],
                [voice_ids[i] for i in compute_idx],
                [speeds[i] for i in compute_idx],
                output_format=output_format,
                pitches=[pitches[i] for i in compute_idx],
            )
            for i in uncached:
                audio = fresh[unique_row[i]]
                results[i] = audio
                self._audio_cache_put(keys[i], audio)
        return results
