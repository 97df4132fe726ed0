# -*- coding: utf-8 -*-
"""Synthesizer: IPA phonemes -> waveform through bucketed stages (PyTorch
port of ``illufly_tts_tpu/engine/synthesizer.py``).

Stage A (token budget T) predicts durations; the host reads the frame
totals and picks a frame bucket F; stage B (T, F) fits the durations to F
and renders audio in one of ``FORMATS``: f32, int16 PCM, or uint8 G.711
mu-law at 8 kHz (``mulaw8k``) or at 24 kHz as a wire codec the host expands
back to PCM (``mulaw24k``), all encoded on the device. The bucket logic is
the JAX engine's: the frame budget decides ``_fit_durations``, so it is
part of the numerics.

The two device->host copies of the JAX engine (the frame totals after
stage A, the audio after stage B) are non-blocking copies into pinned host
memory, each with a CUDA event that ``_pick_f_bucket`` or ``collect`` waits
on. ``stream_decode`` streams one utterance batch chunk by chunk: exactly
(slices of the batch render, each copied alone) or windowed
(``decode_prepare`` once, then the Generator per window).

The engine runs on CUDA unless ``device="cpu"`` is passed; without a CUDA
device and without that argument it raises. Parameters are float32 and
the model computes in float32 (set ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` to False to keep the card's
matrix products and convolutions out of TF32).
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..model.config import KokoroConfig
from ..audio.telephony import (
    RATIO,
    design_decimation_fir,
    mulaw_encode,
    mulaw_lut,
    resample_to_8k,
)
from ..model import flax_msgpack
from ..model.convert import load_torch_checkpoint
from ..model.kokoro import KokoroModel, _fit_durations, peak_normalize
from ..model.params import (
    export_flax_params,
    load_flax_params,
    random_flax_params,
)
from ..model.vocab import encode as encode_phonemes
from .buckets import BATCH_BUCKETS, FRAME_BUCKETS, TOKEN_BUCKETS, pick

logger = logging.getLogger(__name__)

MAX_PHONEMES = 510  # hard cap on phonemes per item
FORMATS = ("f32", "pcm16", "mulaw8k", "mulaw24k")


class _HostCopy:
    """A device tensor copied to host without blocking: into pinned memory
    with an event on CUDA, as is on the CPU. ``numpy()`` waits."""

    __slots__ = ("host", "event")

    def __init__(self, tensor: torch.Tensor):
        if tensor.is_cuda:
            self.host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                    pin_memory=True)
            self.host.copy_(tensor, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(tensor.device))
        else:
            self.host, self.event = tensor, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class DispatchHandle:
    """In-flight batch: stage-A outputs + the non-blocking frame-total
    copy (and, with ``keep_durations``, the durations' copy). ``d``/
    ``pred_dur`` stay until stage B consumes them, so a fresh handle can be
    streamed windowed."""

    __slots__ = (
        "n", "b_bucket", "t_bucket", "ids", "mask", "ref", "d",
        "pred_dur", "totals", "f_bucket", "device_audio", "audio",
        "fitted_totals", "fmt", "keep_durations", "host_pred_dur", "pitch",
        "ts_ctx",
    )

    def __init__(self, n, b_bucket, t_bucket, ids, mask, ref, d,
                 pred_dur, totals, fmt="pcm16", pitch=None):
        self.n = n
        self.b_bucket = b_bucket
        self.t_bucket = t_bucket
        self.ids = ids
        self.mask = mask
        self.ref = ref
        self.d = d
        self.pred_dur = pred_dur
        self.totals = totals            # _HostCopy of [B] frame totals
        self.f_bucket = None
        self.device_audio = None        # stage-B output not yet copied
        self.audio = None               # _HostCopy of the stage-B output
        self.fitted_totals = None
        self.fmt = fmt
        self.pitch = pitch
        self.keep_durations = False
        self.host_pred_dur = None       # _HostCopy of pred_dur[:n]
        self.ts_ctx = None  # pipeline-owned frontend context for timestamps


def resolve_device(device=None) -> torch.device:
    """``device`` or CUDA; raises when CUDA is asked for and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run it on the CPU"
        )
    return dev


class Synthesizer:
    def __init__(
        self,
        config: Optional[KokoroConfig] = None,
        params=None,
        voices_dir: Optional[str] = None,
        seed: int = 0,
        device=None,
        token_buckets: Sequence[int] = TOKEN_BUCKETS,
        frame_buckets: Sequence[int] = FRAME_BUCKETS,
        batch_buckets: Sequence[int] = BATCH_BUCKETS,
        repo_id: str = "",
    ):
        """``params``: a flax-layout tree (``{"params": ...}``, numpy
        arrays), e.g. the JAX ``Synthesizer.params``; None draws the same
        random parameters the JAX engine draws for ``seed``. ``repo_id``
        enables the offline HF-cache voice search of ``load_voice``."""
        self.device = resolve_device(device)
        self.config = config or KokoroConfig()
        if self.config.dtype != torch.float32:
            raise NotImplementedError("the port computes in float32 only")
        with torch.device("meta"):
            model = KokoroModel(self.config)
        model = model.to_empty(device="cpu")
        if params is None:
            logger.info("initializing random model parameters (seed %d)", seed)
            params = random_flax_params(model, seed)
        load_flax_params(model, params)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.voices_dir = voices_dir
        self.repo_id = repo_id
        # pick() assumes ascending order
        self.token_buckets = tuple(sorted(token_buckets))
        self.frame_buckets = tuple(sorted(frame_buckets))
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.sample_rate = self.config.sample_rate
        self._fir_taps = torch.from_numpy(design_decimation_fir()).to(
            self.device)
        self._voices: Dict[str, np.ndarray] = {}  # host-side [L, 256]
        self._lock = threading.Lock()

    def save_params(self, path: str) -> None:
        """Write the weights as flax msgpack: the file the JAX
        ``Synthesizer.save_params`` writes, which its ``load_params``
        reads."""
        flax_msgpack.save(path, export_flax_params(self.model))

    def load_params(self, path: str) -> None:
        """Load model weights onto ``self.device``: flax msgpack
        (.msgpack/.bin, e.g. from the JAX ``save_params``) or a torch
        Kokoro checkpoint (.pt/.pth) through the converter — the reference
        user's migration path (their HF checkpoint works directly)."""
        if path.endswith((".pt", ".pth")):
            tree = load_torch_checkpoint(path,
                                         export_flax_params(self.model))
        else:
            tree = flax_msgpack.load(path)
        load_flax_params(self.model, tree)

    # --- voices ---------------------------------------------------------------

    def load_voice(self, voice_id: str) -> np.ndarray:
        """Voice pack [L, 256] (style embedding indexed by phoneme length),
        registered, or read as .npy/.npz/.pt from ``voices_dir`` and then,
        with ``repo_id`` set, from the offline HF snapshot cache
        ``$HF_HOME/hub/models--<org>--<name>/snapshots/*/voices/``. Kept on
        the host: each item's row ships with the batch upload.

        ``voice_id`` may also be a blend spec ``"a*0.6+b*0.4"`` (see
        ``blend_voices``); the blended pack is cached under the spec."""
        if voice_id in self._voices:
            return self._voices[voice_id]
        if "+" in voice_id or "*" in voice_id:
            self.register_voice(voice_id, self.blend_voices(voice_id))
            return self._voices[voice_id]

        def try_dir(directory: str):
            for ext in (".npy", ".npz", ".pt"):
                path = os.path.join(directory, f"{voice_id}{ext}")
                if not os.path.exists(path):
                    continue
                if ext == ".npy":
                    return np.load(path)
                if ext == ".npz":
                    with np.load(path) as z:
                        return z[list(z.keys())[0]]
                return torch.load(path, map_location="cpu",
                                  weights_only=True).numpy()
            return None

        pack = try_dir(self.voices_dir) if self.voices_dir else None
        searched = [self.voices_dir] if self.voices_dir else []
        if pack is None and self.repo_id:
            # the HF snapshot cache's voices/ dir, searched offline: the
            # on-disk layout snapshot_download uses, no network
            hub = os.path.join(
                os.environ.get(
                    "HF_HOME",
                    os.path.join(os.path.expanduser("~"), ".cache",
                                 "huggingface"),
                ),
                "hub",
                "models--" + self.repo_id.replace("/", "--"),
                "snapshots",
            )
            if os.path.isdir(hub):
                for rev in sorted(os.listdir(hub)):
                    vdir = os.path.join(hub, rev, "voices")
                    searched.append(vdir)
                    if os.path.isdir(vdir):
                        pack = try_dir(vdir)
                        if pack is not None:
                            break
            else:
                searched.append(hub)
        if pack is None:
            raise ValueError(
                f"voice not found: {voice_id} (searched {searched})"
            )
        pack = np.asarray(pack, np.float32)
        if pack.ndim == 3:  # [L, 1, 256] -> [L, 256]
            pack = pack[:, 0, :]
        self.register_voice(voice_id, pack)
        return self._voices[voice_id]

    def blend_voices(self, spec: str) -> np.ndarray:
        """Weighted mix of voice packs: ``"a+b"`` (equal), ``"a*0.7+b*0.3"``.
        Weights are normalized to sum to 1; packs of different lengths are
        aligned on the shortest (length-indexed rows stay consistent)."""
        comps = []
        for part in spec.split("+"):
            name, _, w = part.partition("*")
            name = name.strip()
            if not name or "+" in name:
                raise ValueError(f"bad voice blend component: {part!r}")
            try:
                weight = float(w) if w.strip() else 1.0
            except ValueError:
                raise ValueError(
                    f"bad weight in voice blend component: {part!r}"
                )
            if weight <= 0 or not np.isfinite(weight):
                raise ValueError(
                    f"voice blend weight must be positive: {part!r}"
                )
            comps.append((name, weight))
        total = sum(w for _, w in comps)
        packs = [self.load_voice(name) for name, _ in comps]
        min_len = min(p.shape[0] for p in packs)
        out = np.zeros((min_len, packs[0].shape[1]), np.float32)
        for (_, w), p in zip(comps, packs):
            if p.shape[1] != out.shape[1]:
                raise ValueError(
                    f"voice blend dim mismatch in {spec!r}: "
                    f"{p.shape[1]} vs {out.shape[1]}"
                )
            out += (w / total) * p[:min_len]
        return out

    def register_voice(self, voice_id: str, pack: np.ndarray) -> None:
        pack = np.asarray(pack, np.float32)
        if pack.ndim == 1:
            pack = np.tile(pack[None, :], (MAX_PHONEMES, 1))
        with self._lock:
            self._voices[voice_id] = pack

    def register_random_voice(self, voice_id: str, seed: int = 0) -> None:
        rng = np.random.RandomState(seed)
        pack = rng.randn(MAX_PHONEMES, 2 * self.config.style_dim).astype(
            np.float32
        ) * 0.1
        self.register_voice(voice_id, pack)

    def list_voices(self) -> List[str]:
        names = set(self._voices)
        if self.voices_dir and os.path.isdir(self.voices_dir):
            for f in os.listdir(self.voices_dir):
                base, ext = os.path.splitext(f)
                if ext in (".npy", ".npz", ".pt", ".pth"):
                    names.add(base)
        return sorted(names)

    def is_voice_loaded(self, voice_id: str) -> bool:
        if voice_id in self._voices:
            return True
        try:
            self.load_voice(voice_id)
            return True
        except Exception:
            return False

    # --- stages ----------------------------------------------------------------

    @staticmethod
    def _as_fmt(fmt) -> str:
        """Accept legacy pcm16 bools alongside format strings."""
        if fmt is True:
            return "pcm16"
        if fmt is False:
            return "f32"
        if fmt not in FORMATS:
            raise ValueError(f"unsupported audio format: {fmt!r} "
                             f"(the port renders {FORMATS})")
        return fmt

    def _stage_a(self, ids, mask, ref_s, speed):
        duration, d = self.model.encode_durations(ids, mask, ref_s, speed)
        pred_dur = KokoroModel.quantize_durations(duration, mask)
        return d, pred_dur, pred_dur.sum(dim=-1)

    def _stage_b(self, ids, mask, d, pred_dur, ref_s, pitch, frames, fmt):
        """-> (audio [B, F * 600] in ``fmt``'s type, or [B, F * 200] uint8
        for mulaw8k; fmask [B, F])."""
        fitted = _fit_durations(pred_dur, frames)
        audio, fmask = self.model.decode_frames(
            ids, mask, d, fitted, ref_s, frames, pcm16=(fmt == "pcm16"),
            pitch=pitch,
        )
        if fmt in ("mulaw8k", "mulaw24k"):
            # the pcm16 path's peak policy, then the decimating FIR (8 kHz
            # only), then G.711 companding, all on the device
            audio = peak_normalize(audio)
            if fmt == "mulaw8k":
                audio = resample_to_8k(audio, self._fir_taps)
            audio = mulaw_encode(audio)
        return audio, fmask

    # --- synthesis -------------------------------------------------------------

    @torch.inference_mode()
    def dispatch(
        self,
        phonemes_list: Sequence[str],
        voice_ids: Sequence[str],
        speeds: Optional[Sequence[float]] = None,
        fmt: str = "pcm16",
        keep_durations: bool = False,
        pitches: Optional[Sequence[float]] = None,
    ) -> DispatchHandle:
        """Stage the batch and launch stage A. Returns a handle for
        ``launch_decode``/``collect``. The per-item frame totals start a
        non-blocking copy to host at once, so ``launch_decode`` rarely
        waits for them."""
        n = len(phonemes_list)
        if n > self.batch_buckets[-1]:
            raise ValueError(
                f"batch of {n} exceeds the largest batch bucket "
                f"{self.batch_buckets[-1]}; split it (synthesize_batch "
                "does this automatically)"
            )
        fmt = self._as_fmt(fmt)
        speeds = [1.0] * n if speeds is None else speeds
        pitches = [1.0] * n if pitches is None else pitches

        id_lists = [encode_phonemes(p, max_len=MAX_PHONEMES + 2)
                    for p in phonemes_list]
        t_bucket = pick(self.token_buckets, max(len(i) for i in id_lists))
        # sequences longer than the largest bucket truncate (keep EOS=0)
        id_lists = [ids if len(ids) <= t_bucket else ids[: t_bucket - 1] + [0]
                    for ids in id_lists]
        b_bucket = pick(self.batch_buckets, n)

        ids = np.zeros((b_bucket, t_bucket), np.int64)
        mask = np.zeros((b_bucket, t_bucket), np.float32)
        ref_s = np.zeros((b_bucket, 2 * self.config.style_dim), np.float32)
        speed_arr = np.ones((b_bucket,), np.float32)
        pitch_arr = np.ones((b_bucket,), np.float32)
        for i, id_list in enumerate(id_lists):
            ids[i, : len(id_list)] = id_list
            mask[i, : len(id_list)] = 1.0
            pack = self.load_voice(voice_ids[i])
            row = min(len(phonemes_list[i]) - 1, pack.shape[0] - 1)
            ref_s[i] = pack[max(row, 0)]
            speed_arr[i] = speeds[i]
            pitch_arr[i] = pitches[i]
        # ids beyond the model's vocab (configs smaller than the phoneme
        # table) read as unk=0
        np.putmask(ids, ids >= self.config.albert.vocab_size, 0)

        def put(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(a)
            if self.device.type != "cuda":
                return t
            # pinned + non-blocking: does not wait for earlier batches
            return t.pin_memory().to(self.device, non_blocking=True)

        ids_d, mask_d, ref_d = put(ids), put(mask), put(ref_s)
        d, pred_dur, totals = self._stage_a(ids_d, mask_d, ref_d,
                                            put(speed_arr))
        handle = DispatchHandle(
            n=n, b_bucket=b_bucket, t_bucket=t_bucket, ids=ids_d,
            mask=mask_d, ref=ref_d, d=d, pred_dur=pred_dur,
            totals=_HostCopy(totals), fmt=fmt, pitch=put(pitch_arr),
        )
        handle.keep_durations = keep_durations
        if keep_durations:
            # a stage-A output: copied beside the totals, so reading it
            # later never queues behind this batch's stage B
            handle.host_pred_dur = _HostCopy(pred_dur[:n])
        return handle

    def _pick_f_bucket(self, handle: DispatchHandle) -> int:
        """Choose (and record on the handle) the frame bucket for this
        batch. Idempotent; waits only for the frame-total copy."""
        if handle.f_bucket is None:
            totals_np = handle.totals.numpy()
            handle.f_bucket = (
                self.frame_buckets[0] if len(self.frame_buckets) == 1
                else pick(self.frame_buckets,
                          int(totals_np[: handle.n].max()))
            )
            # stage B fits durations to the budget; the fitted per-item
            # total is exactly min(total, budget)
            handle.fitted_totals = np.minimum(totals_np, handle.f_bucket)
        return handle.f_bucket

    def _decode(self, handle: DispatchHandle) -> None:
        """Run stage B into ``handle.device_audio`` unless it ran already,
        and release the stage-A intermediates. Idempotent."""
        if handle.device_audio is not None or handle.audio is not None:
            return
        f_bucket = self._pick_f_bucket(handle)
        with torch.inference_mode():
            handle.device_audio, _ = self._stage_b(
                handle.ids, handle.mask, handle.d, handle.pred_dur,
                handle.ref, handle.pitch, f_bucket, handle.fmt,
            )
        # stage-A intermediates are no longer needed
        handle.d = handle.pred_dur = None

    def launch_decode(self, handle: DispatchHandle) -> DispatchHandle:
        """Pick the frame bucket, launch stage B and the non-blocking copy
        of its whole output to host. Idempotent."""
        if handle.audio is None:
            self._decode(handle)
            handle.audio = _HostCopy(handle.device_audio)
            handle.device_audio = None
        return handle

    def _frame_samples(self, fmt: str) -> int:
        """Output samples per model frame in ``fmt``."""
        spf = self.config.samples_per_frame
        return spf // RATIO if fmt == "mulaw8k" else spf

    @staticmethod
    def _expand(clip: np.ndarray, fmt: str, pcm16: bool) -> np.ndarray:
        """Host side of a format: mulaw24k codes -> PCM through the table,
        pcm16 <-> float32 as asked; mulaw8k codes and matching types pass
        through."""
        if fmt == "mulaw24k":
            return mulaw_lut(np.int16 if pcm16 else np.float32)[clip]
        if fmt == "pcm16" and not pcm16:
            return clip.astype(np.float32) / 32767.0
        if fmt == "f32" and pcm16:
            return np.round(np.clip(
                clip.astype(np.float32) * 32767.0, -32767, 32767
            )).astype(np.int16)
        return clip

    def collect(self, handle: DispatchHandle,
                pcm16: bool = False) -> List[np.ndarray]:
        """Wait for a dispatched batch's audio and trim it per item.
        Returns float32 @24k by default, int16 @24k with ``pcm16=True``,
        or uint8 G.711 mu-law @8k for a ``mulaw8k`` handle (``pcm16`` is
        ignored then). A ``mulaw24k`` handle shipped uint8 mu-law @24k and
        comes back as PCM @24k, quantized to the mu-law grid."""
        self.launch_decode(handle)
        audio_np = handle.audio.numpy()
        spf = self._frame_samples(handle.fmt)
        return [
            self._expand(audio_np[i, : int(handle.fitted_totals[i]) * spf],
                         handle.fmt, pcm16)
            for i in range(handle.n)
        ]

    def rendered_durations(self, handle: DispatchHandle) -> np.ndarray:
        """Per-token frame counts stage B renders: the stage-A durations
        clipped to the frame bucket as ``_fit_durations`` does. [n, T]
        int32; position 0 is BOS. Needs ``keep_durations=True``; callable
        before any decode."""
        if handle.host_pred_dur is None:
            raise ValueError(
                "dispatch(..., keep_durations=True) required for "
                "rendered_durations"
            )
        self._pick_f_bucket(handle)
        pd = handle.host_pred_dur.numpy().astype(np.int64)
        cum_prev = np.cumsum(pd, axis=-1) - pd
        return np.clip(handle.f_bucket - cum_prev, 0, pd).astype(np.int32)

    # --- streaming ----------------------------------------------------------

    def _stream_exact(self, handle: DispatchHandle, window_frames: int):
        """Slices of the batch render: the same stage B as ``collect``, so
        the chunks concatenate to its output bit for bit. Each chunk's
        slice is copied to host alone, the next one's copy starting before
        the current chunk is handed over."""
        if handle.audio is None:
            self._decode(handle)  # no whole copy: slices only
        spf = self._frame_samples(handle.fmt)
        max_total = int(handle.fitted_totals[: handle.n].max())
        spans = [(lo * spf, min(lo + window_frames, max_total) * spf)
                 for lo in range(0, max_total, window_frames)]

        def fetch(lo, hi):
            if handle.audio is not None:  # launched before: sliced on host
                return handle.audio.numpy()[: handle.n, lo:hi]
            return _HostCopy(handle.device_audio[: handle.n, lo:hi])

        pending = fetch(*spans[0]) if spans else None
        for k in range(len(spans)):
            chunk = pending
            pending = fetch(*spans[k + 1]) if k + 1 < len(spans) else None
            if isinstance(chunk, _HostCopy):
                chunk = chunk.numpy()
            yield self._expand(chunk, handle.fmt, False)

    def stream_decode(
        self,
        handle: DispatchHandle,
        window_frames: int = 64,
        halo_frames: int = 16,
        exact: bool = True,
    ):
        """Yield the batch's audio in chunks of ``window_frames`` model
        frames (np [n, <= window_frames * 600]).

        ``exact=True``: slices of the batch stage B's own output, so the
        chunks concatenate to ``collect()`` bit for bit: float32 for f32,
        pcm16 and mulaw24k handles, uint8 mu-law @8k for mulaw8k. The first
        chunk waits for the whole render (the Generator's AdaIN statistics
        span the whole utterance).

        ``exact=False``: ``decode_prepare`` once (prosody BiLSTM, decoder
        trunk, harmonic phase), then the Generator per window of
        ``window_frames`` with ``halo_frames`` of context on each side;
        neighbouring windows overlap by ``halo_frames`` and the seam is
        crossfaded with a linear ramp (as the JAX engine does). The first
        chunk comes after one window. Window-local AdaIN statistics make
        the audio an approximation of the batch render; chunks are float32
        in every format, and the last is trimmed to the fitted frame
        total. Needs a handle that stage B has not consumed."""
        if exact:
            yield from self._stream_exact(handle, window_frames)
            return
        if handle.d is None:
            raise ValueError(
                "handle was already decoded (launch_decode/collect "
                "release the stage-A intermediates); stream_decode needs "
                "a fresh dispatch() handle"
            )
        f_bucket = self._pick_f_bucket(handle)
        if f_bucket % window_frames:
            raise ValueError(
                f"window_frames {window_frames} must divide the frame "
                f"bucket {f_bucket}"
            )
        model = self.model
        with torch.inference_mode():
            prep = model.decode_prepare(
                handle.ids, handle.mask, handle.d,
                _fit_durations(handle.pred_dur, f_bucket), handle.ref,
                f_bucket, pitch=handle.pitch,
            )
        spf = self.config.samples_per_frame
        # windows work in generator frames (2 per model frame) of spf / 2
        # samples: the halo of 2 * halo_frames generator frames spans
        # halo_frames * spf samples shared by neighbouring windows
        overlap = halo_frames * spf
        ramp = np.linspace(0.0, 1.0, overlap, dtype=np.float32)[None, :]
        max_total = int(handle.fitted_totals[: handle.n].max())
        body = window_frames * spf
        prev_tail: Optional[np.ndarray] = None
        for emitted in range(0, max_total, window_frames):
            with torch.inference_mode():
                audio = model.decode_window(
                    *prep, handle.ref, 2 * emitted, 2 * window_frames,
                    2 * halo_frames,
                )
            chunk = audio.float().cpu().numpy()  # [B, (window + halo) * spf]
            out = chunk[:, :body].copy()
            if prev_tail is not None:
                out[:, :overlap] = (
                    prev_tail * (1.0 - ramp) + out[:, :overlap] * ramp
                )
            prev_tail = chunk[:, body: body + overlap]
            frames_here = min(window_frames, max_total - emitted)
            yield out[: handle.n, : frames_here * spf]

    def synthesize_batch(
        self,
        phonemes_list: Sequence[str],
        voice_ids: Sequence[str],
        speeds: Optional[Sequence[float]] = None,
        pcm16: bool = False,
        fmt: str = "pcm16",
        pitches: Optional[Sequence[float]] = None,
    ) -> List[np.ndarray]:
        """IPA phoneme strings -> list of waveforms. ``fmt='pcm16'``: the
        device emits 16-bit PCM and ``pcm16=False`` converts back to float32
        on the host; ``fmt='f32'``: raw float32. Batches larger than the
        biggest batch bucket are split, with chunk k+1's stage B launched
        before chunk k is collected."""
        if not phonemes_list:
            return []
        n = len(phonemes_list)
        speeds = [1.0] * n if speeds is None else speeds
        pitches = [1.0] * n if pitches is None else pitches
        max_b = self.batch_buckets[-1]
        handles = [
            self.dispatch(phonemes_list[s:s + max_b], voice_ids[s:s + max_b],
                          speeds[s:s + max_b], fmt=fmt,
                          pitches=pitches[s:s + max_b])
            for s in range(0, n, max_b)
        ]
        out: List[np.ndarray] = []
        for i, h in enumerate(handles):
            for nxt in handles[i:i + 2]:
                self.launch_decode(nxt)
            out.extend(self.collect(h, pcm16=pcm16))
        return out
