# -*- coding: utf-8 -*-
"""PyTorch port: word timestamps (``tests/test_timestamps.py``).

Every case of that suite runs again on the port, its ``slow`` classes and
case among them: the IPA word split on the port's copy of the G2P, and
the stamps through the port's ``TTSPipeline``, ``CachedTTSPipeline``
(split phase, cache hits) and ``TTSServiceManager`` over the port's engine
on the CPU. The fixtures are the suite's own, built on the port: the same
buckets, voice and seed."""
import pytest
import torch

from illufly_tts_tpu_torch.frontend.g2p.chinese_g2p import ChineseG2P
from illufly_tts_tpu_torch.frontend.g2p.en_g2p import EnglishG2P
from illufly_tts_tpu_torch.pipeline import CachedTTSPipeline, TTSPipeline
from tests import test_timestamps as jax_cases
from tests import torch_port_cases as port_cases
from tests.test_torch_params import port_config

torch.set_num_threads(2)

CASES = port_cases.collect(jax_cases, include_slow=True)


def _synth():
    s = port_cases.cpu_synthesizer()(
        config=port_config(), token_buckets=(32, 64),
        frame_buckets=(64, 128, 256))
    s.register_random_voice("v", seed=3)
    return s


@pytest.fixture(scope="module")
def fixtures():
    """The suite's fixtures on the port: ``g2p``, and the classes'
    ``pipe`` and ``cached_pipe``."""
    return {"g2p": ChineseG2P(en_callable=EnglishG2P()),
            "pipe": TTSPipeline(synthesizer=_synth()),
            "cached_pipe": CachedTTSPipeline(synthesizer=_synth())}


def test_all_timestamp_cases_collected():
    assert len(CASES) == 12, sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_timestamp_case_on_the_port(case, fixtures, monkeypatch):
    port_cases.use_port_engine(monkeypatch)
    monkeypatch.setattr(jax_cases, "ChineseG2P", ChineseG2P)
    monkeypatch.setattr(jax_cases, "EnglishG2P", EnglishG2P)
    port_cases.run(jax_cases, CASES[case], **fixtures)
