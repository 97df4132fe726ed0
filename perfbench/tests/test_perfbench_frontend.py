"""The frozen frontend tables against the live frontend (which needs
``jieba``): every character's and word's IPA is what the live G2P gives
for it alone, every number clause is what the live normalizers make of
it."""
import pytest

from perfbench.harness import frontend

TABLES = frontend.load_tables()


@pytest.fixture(scope="module")
def live():
    pytest.importorskip("jieba")
    from illufly_tts_tpu_torch.pipeline import TTSPipeline

    pipe = TTSPipeline.__new__(TTSPipeline)
    pipe._init_frontend_only()
    return pipe


def _ipa(live, text):
    return live.phonemes_to_ipa(live.text_to_phonemes(text))


def test_characters(live):
    bad = {c: ipa for c, ipa in TABLES["zh_chars"].items()
           if _ipa(live, c) != ipa}
    assert not bad


def test_words(live):
    bad = {w: ipa for w, ipa in TABLES["en_words"].items()
           if _ipa(live, w) != ipa}
    assert not bad
    assert all(live.preprocess_text(w) == w for w in TABLES["zh_words"])


def test_number_clauses(live):
    for lang in ("zh", "en"):
        for raw, norm in TABLES["numbers"][lang]:
            assert live.preprocess_text(raw) == norm


def test_tables_spell_every_normalized_form():
    for lang in ("zh", "en"):
        for _, norm in TABLES["numbers"][lang]:
            frontend.spell(norm, TABLES)
    for word in TABLES["zh_words"]:
        frontend.spell(word, TABLES)


def test_stand_in_g2p_interface():
    g2p = frontend.FrozenG2P(TABLES)
    text = "今天气温三十一摄氏度，" + " hello" if "hello" in \
        TABLES["en_words"] else "今天气温三十一摄氏度，"
    phonemes = g2p.text_to_phonemes(text)
    assert g2p.convert_to_ipa(phonemes) == frontend.spell(text, TABLES)
    with pytest.raises(KeyError):
        g2p.text_to_phonemes("ABC 123")


def test_tables_are_small():
    import os

    total = sum(os.path.getsize(os.path.join(frontend.DATA, f))
                for f in os.listdir(frontend.DATA))
    assert total < 150_000
