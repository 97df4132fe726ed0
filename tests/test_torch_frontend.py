# -*- coding: utf-8 -*-
"""PyTorch port: the text frontend.

The port's ``frontend/`` is the JAX package's, byte for byte (sources and
lexicon data); the port's pipeline gives the JAX pipeline's normalized text,
phonemes and IPA on a battery of zh/en/mixed texts (the NSW cases of
``tests/test_preprocess.py`` and the first rows of the zh polyphone battery
among them); and ``chip_smoke.py``'s frozen frontend table, which stands in
for the G2P on a card machine without ``jieba``, is the JAX frontend's
output for its texts."""
import hashlib
import os
import re

import pytest

import chip_smoke
from illufly_tts_tpu.pipeline import TTSPipeline as JaxPipeline
from illufly_tts_tpu_torch.pipeline import TTSPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FRONTEND = os.path.join(REPO, "illufly_tts_tpu", "frontend")
PORT_FRONTEND = os.path.join(REPO, "illufly_tts_tpu_torch", "frontend")


def _digests(root):
    out = {}
    for base, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".pyc"):
                continue
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _nsw_texts():
    with open(os.path.join(REPO, "tests", "test_preprocess.py"),
              encoding="utf-8") as f:
        return re.findall(r'preprocess_text\(\s*"([^"]+)"', f.read())


def _polyphone_texts(rows=20):
    path = os.path.join(REPO, "tests", "data", "zh_polyphone_battery.tsv")
    with open(path, encoding="utf-8") as f:
        lines = [line.strip() for line in f
                 if line.strip() and not line.startswith("#")]
    return [re.sub(r"\{(.):[a-z]+\d\}", r"\1", line) for line in lines[:rows]]


BATTERY = [
    "你好，世界。",
    "今天天气真好，我们去公园散步。",
    "hello world",
    "The quick brown fox jumps over the lazy dog.",
    "这是一个 test case 混合文本。",
    "银行行长走在行人道上。",
    *_nsw_texts(),
    *_polyphone_texts(),
]


def _frontend_only(cls):
    pipe = cls.__new__(cls)
    pipe._init_frontend_only()
    return pipe


@pytest.fixture(scope="module")
def frontends():
    return _frontend_only(JaxPipeline), _frontend_only(TTSPipeline)


def test_frontend_files_byte_identical():
    jax_files, port_files = _digests(JAX_FRONTEND), _digests(PORT_FRONTEND)
    assert len(jax_files) >= 40
    assert any(name.startswith(os.path.join("g2p", "data"))
               for name in port_files)
    assert port_files == jax_files


def test_battery_covers_the_sources():
    assert len(_nsw_texts()) >= 30
    assert all("{" not in t for t in _polyphone_texts())


@pytest.mark.parametrize("text", BATTERY)
def test_port_frontend_matches_jax(frontends, text):
    jax_pipe, port = frontends
    normalized = port.preprocess_text(text)
    assert normalized == jax_pipe.preprocess_text(text)
    phonemes = port.text_to_phonemes(normalized)
    assert phonemes == jax_pipe.text_to_phonemes(normalized)
    assert port.phonemes_to_ipa(phonemes) == jax_pipe.phonemes_to_ipa(
        phonemes)
    assert port.g2p.text_to_ipa_words(normalized) == \
        jax_pipe.g2p.text_to_ipa_words(normalized)


def test_chip_smoke_frozen_table_is_the_jax_frontend(frontends):
    jax_pipe, port = frontends
    assert chip_smoke.frontend_table(jax_pipe) == chip_smoke.FRONTEND_TABLE
    assert chip_smoke.frontend_table(port) == chip_smoke.FRONTEND_TABLE


def test_frozen_g2p_reproduces_the_table(frontends):
    """The frozen G2P gives, for phase 7's texts, the JAX G2P's outputs;
    a text outside the table raises."""
    jax_pipe, _ = frontends
    frozen = chip_smoke.FrozenG2P(chip_smoke.FRONTEND_TABLE)
    for text in chip_smoke.FRONTEND_TABLE["g2p"]:
        phonemes = frozen.text_to_phonemes(text)
        assert phonemes == jax_pipe.g2p.text_to_phonemes(text)
        assert frozen.convert_to_ipa(phonemes) == \
            jax_pipe.g2p.convert_to_ipa(phonemes)
    for text in chip_smoke.FRONTEND_TABLE["words"]:
        assert frozen.text_to_ipa_words(text) == \
            jax_pipe.g2p.text_to_ipa_words(text)
    with pytest.raises(KeyError):
        frozen.text_to_phonemes("不在表里。")
