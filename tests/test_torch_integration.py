# -*- coding: utf-8 -*-
"""PyTorch port: text to wav end to end (``tests/test_integration.py``).

Every case of that suite runs again on the port's ``CachedTTSPipeline``
over the port's engine on the CPU, built as the suite's ``pipe`` fixture
is (the same buckets and voice), the caches under six threads at their
eviction limit and the within-batch dedup among them. Its bf16 case names
the dtype as JAX spells it (``jnp.bfloat16``); its port counterpart here
asks for ``torch.bfloat16``."""
import dataclasses

import numpy as np
import pytest
import torch

from illufly_tts_tpu_torch.pipeline import CachedTTSPipeline
from tests import test_integration as jax_cases
from tests import torch_port_cases as port_cases
from tests.test_torch_params import port_config

torch.set_num_threads(2)

DIRECT = ("test_bf16_forward_finite",)
CASES = port_cases.collect(jax_cases, exclude=DIRECT)


@pytest.fixture(scope="module")
def pipe():
    synth = port_cases.cpu_synthesizer()(
        config=port_config(), token_buckets=(32, 64),
        frame_buckets=(64, 128))
    synth.register_random_voice("zf_001", seed=11)
    return CachedTTSPipeline(synthesizer=synth)


def test_all_integration_cases_collected():
    assert len(CASES) == 12, sorted(CASES)
    assert {"test_cache_thread_safety", "test_within_batch_dedup"} <= set(
        CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_integration_case_on_the_port(case, pipe, monkeypatch, tmp_path):
    port_cases.use_port_engine(
        monkeypatch, jax_cases, ("Synthesizer", "tiny_config", "TTSPipeline",
                                 "CachedTTSPipeline", "TTSServiceManager"))
    port_cases.run(jax_cases, CASES[case], pipe=pipe, tmp_path=tmp_path)


def test_bf16_forward_finite():
    """``test_integration.py::test_bf16_forward_finite`` on the port:
    ``KokoroConfig(dtype=torch.bfloat16)`` renders finite float32 audio."""
    cfg = dataclasses.replace(port_config(), dtype=torch.bfloat16)
    synth = port_cases.cpu_synthesizer()(config=cfg, token_buckets=(32,),
                                         frame_buckets=(64,))
    synth.register_random_voice("v", seed=1)
    audio = synth.synthesize_batch(["ni→xau↓ma"], ["v"])[0]
    assert audio.dtype == np.float32
    assert np.all(np.isfinite(audio))
