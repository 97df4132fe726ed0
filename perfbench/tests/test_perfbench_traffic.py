"""The traffic generator: the same seed gives the same requests, texts are
unique within a run, every seed gets the same amount of work, and the
program's normalizers make of each text the normalized text it was
composed with (so the IPA the check expects is the pipeline's)."""
import numpy as np
import pytest

from perfbench.harness import frontend, registry, traffic

TABLES = frontend.load_tables()
MIXES = registry.names("traffic")
SEEDS = (7, 2147483659)


def _generate(mix_name, seed, seconds=20.0):
    return traffic.generate(registry.load_json("traffic", mix_name), seed,
                            seconds, TABLES)


@pytest.mark.parametrize("mix_name", MIXES)
def test_deterministic_per_seed(mix_name):
    a, pa = _generate(mix_name, SEEDS[1])
    b, pb = _generate(mix_name, SEEDS[1])
    assert a == b and pa == pb
    c, _ = _generate(mix_name, SEEDS[0])
    assert [r["text"] for r in a] != [r["text"] for r in c]


@pytest.mark.parametrize("mix_name", MIXES)
def test_unique_texts_and_same_work_per_seed(mix_name):
    mix = registry.load_json("traffic", mix_name)
    runs = [_generate(mix_name, s)[0] for s in SEEDS]
    if "prompts" not in mix:
        for reqs in runs:
            assert len({r["text"] for r in reqs}) == len(reqs)
    assert len(runs[0]) == len(runs[1])
    if mix["kind"] == "open_poisson":
        # the same gaps between arrivals and the same requests per user
        gaps = [np.sort(np.diff([0.0] + [r["due"] for r in reqs] + [20.0]))
                for reqs in runs]
        assert np.allclose(gaps[0], gaps[1])
        per_user = [sorted(np.unique([r["user"] for r in reqs],
                                     return_counts=True)[1])
                    for reqs in runs]
        assert per_user[0] == per_user[1]
    law = mix.get("tokens") or mix["chars"]
    for reqs in runs:
        for r in reqs:
            assert r["ipa"] == frontend.expected_ipa(r["normalized"], TABLES)
            n = len(r["ipa"]) + 2 if "tokens" in mix else len(r["text"])
            if "tokens" in mix:
                assert law["min"] <= n <= law["max"]
            else:
                assert 4 <= n <= law["max"]


def test_open_loop_schedule():
    reqs, _ = _generate("serve-poisson", SEEDS[1], seconds=30.0)
    mix = registry.load_json("traffic", "serve-poisson")
    assert len(reqs) == round(mix["rate_per_s"] * 30.0)
    due = [r["due"] for r in reqs]
    assert due == sorted(due) and 0.0 <= due[0] and due[-1] < 30.0
    users = {r["user"] for r in reqs}
    assert len(users) <= mix["users"]
    share = max(sum(r["user"] == u for r in reqs) for u in users) / len(reqs)
    assert 0.15 < share < 0.45  # Zipf(1.1) over 32: the top user ~28%


def test_repeat_mix_draws_prompts():
    reqs, prefill = _generate("serve-repeat", SEEDS[1], seconds=30.0)
    mix = registry.load_json("traffic", "serve-repeat")
    prompts = {p["text"] for p in prefill}
    assert len(prefill) == mix["prompts"]["count"]
    fresh = sum(r["text"] not in prompts for r in reqs)
    assert fresh == round(mix["prompts"]["unique_share"] * len(reqs))
    assert len({r["text"] for r in reqs if r["text"] not in prompts}) == fresh


@pytest.fixture(scope="module")
def normalizer():
    from illufly_tts_tpu_torch import pipeline as pmod

    pipe = pmod.TTSPipeline.__new__(pmod.TTSPipeline)
    pipe.default_language = "zh"
    pipe.zh_normalizer = pmod.ZhTextNormalizer()
    pipe.en_normalizer = pmod.EnTextNormalizer()
    return pipe


@pytest.mark.parametrize("mix_name", MIXES)
@pytest.mark.parametrize("seed", range(6))
def test_program_normalizes_as_composed(normalizer, mix_name, seed):
    reqs, prefill = _generate(mix_name, 1000003 * seed + 11, seconds=10.0)
    for r in (reqs + prefill)[:300]:
        assert normalizer.preprocess_text(r["text"]) == r["normalized"]


def test_length_laws():
    reqs, _ = _generate("serve-poisson", SEEDS[1], seconds=60.0)
    chars = np.array([len(r["text"]) for r in reqs])
    assert 25 <= np.median(chars) <= 35
    numbers = np.mean([any(c.isdigit() for c in r["text"]) for r in reqs])
    assert 0.12 < numbers < 0.3
