"""The system under test, as a deployment sets it up: the voices on the
engine the configuration's family built, the text pipeline on the
benchmark's frozen G2P and the program's own normalizers; and the recorder
that keeps what the engine was handed and what it decided, for the check
after the window."""
from __future__ import annotations

import threading
from typing import Callable, Dict, List

import torch

from .frontend import FrozenG2P


def register_voices(synth, packs: torch.Tensor) -> List[str]:
    names = []
    for i, pack in enumerate(packs.cpu().numpy()):
        names.append(f"bench_{i}")
        synth.register_voice(names[-1], pack)
    return names


def pipeline(synth, tables):
    """``CachedTTSPipeline`` on ``synth`` with the program's normalizers and
    the benchmark's ``FrozenG2P`` (the card's host has no ``jieba``, which
    the program's Chinese G2P imports)."""
    from illufly_tts_tpu_torch import pipeline as pmod

    class BenchPipeline(pmod.CachedTTSPipeline):
        def _init_frontend(self, british):
            self.british = british
            self.en_g2p = self.en_callback = None
            self.g2p = FrozenG2P(tables)
            self.zh_normalizer = pmod.ZhTextNormalizer()
            self.en_normalizer = pmod.EnTextNormalizer()

    return BenchPipeline(synthesizer=synth)


class Recorder:
    """Wraps the engine's ``dispatch`` and ``launch_decode`` on one engine:
    each dispatch's IPA, voices and the stage-A durations it computed (the
    tensor the engine made, kept alive, read after the window), each
    batch's frame bucket, and for each row what the family's
    ``row_extras(handle, i)`` keeps of it (such as noise the engine drew)
    while the handle lives. Nothing the engine computes changes."""

    def __init__(self, synth, row_extras: Callable[[object, int], dict]):
        self.row_extras = row_extras
        self.batches: List[dict] = []
        self._open: Dict[int, dict] = {}
        self._lock = threading.Lock()
        self.on = True
        dispatch, launch = synth.dispatch, synth.launch_decode

        def recorded_dispatch(phonemes_list, voice_ids, *args, **kwargs):
            handle = dispatch(phonemes_list, voice_ids, *args, **kwargs)
            if self.on:
                rec = {"ipa": list(phonemes_list), "voices": list(voice_ids),
                       "pred_dur": handle.pred_dur, "f_bucket": None,
                       "handle": handle}
                with self._lock:
                    self.batches.append(rec)
                    self._open[id(handle)] = rec
            return handle

        def recorded_launch(handle):
            out = launch(handle)
            self.close(handle)
            return out

        synth.dispatch = recorded_dispatch
        synth.launch_decode = recorded_launch

    def close(self, handle) -> None:
        """Note the frame bucket the engine picked for ``handle`` and each
        row's extras, and let the handle go."""
        with self._lock:
            rec = self._open.pop(id(handle), None)
        if rec is not None:
            rec["f_bucket"] = handle.f_bucket
            rec["extras"] = [self.row_extras(handle, i)
                             for i in range(len(rec["ipa"]))]
            rec["handle"] = None

    def close_all(self) -> None:
        """``close`` every handle still open (a stream's, once it ended)."""
        with self._lock:
            handles = [rec["handle"] for rec in self._open.values()]
        for handle in handles:
            self.close(handle)

    def rows(self) -> Dict[tuple, dict]:
        """(IPA, voice) -> {"ipa", "voice", "pred_dur" (host, the row's
        tokens), "frames", "extras"} for the first dispatch of each
        pair."""
        out = {}
        for rec in self.batches:
            if rec["f_bucket"] is None:
                continue
            pred = rec["pred_dur"].cpu().numpy()
            for i, (ipa, voice) in enumerate(zip(rec["ipa"], rec["voices"])):
                out.setdefault((ipa, voice), {
                    "ipa": ipa, "voice": voice, "pred_dur": pred[i],
                    "frames": rec["f_bucket"], "extras": rec["extras"][i]})
        return out

    def release(self) -> None:
        for rec in self.batches:
            rec["pred_dur"] = rec["handle"] = rec["extras"] = None

