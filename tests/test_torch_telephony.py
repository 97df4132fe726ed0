# -*- coding: utf-8 -*-
"""PyTorch port: the telephony formats through the engine
(``tests/test_telephony.py``, classes ``TestSynthesizerMulaw`` and
``TestMulaw24kWire``).

Their cases run again on the port's ``Synthesizer`` (on the CPU, with
``tiny_config`` as the port's config) and ``CachedTTSPipeline``: the
device's mulaw8k against the host path (an f32 render resampled and
companded by the suite's numpy references), the mulaw24k wire against the
pcm16 path, its f32 delivery, and the pipeline's ``wire_format="mulaw24k"``
knob. The suite's codec cases without an engine are the JAX package's own
(the port's copies are held to them bit for bit in
``tests/test_torch_streaming.py``)."""
import pytest
import torch

from tests import test_telephony as jax_cases
from tests import torch_port_cases as port_cases

torch.set_num_threads(2)

CLASSES = ("TestSynthesizerMulaw", "TestMulaw24kWire")
CASES = {case: spec for case, spec in
         port_cases.collect(jax_cases, include_slow=True).items()
         if case.split("::")[0] in CLASSES}


def test_all_telephony_cases_collected():
    assert len(CASES) == 4, sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_telephony_case_on_the_port(case, monkeypatch):
    port_cases.use_port_engine(monkeypatch, extra={
        "illufly_tts_tpu.audio.telephony":
            "illufly_tts_tpu_torch.audio.telephony"})
    port_cases.run(jax_cases, CASES[case])
