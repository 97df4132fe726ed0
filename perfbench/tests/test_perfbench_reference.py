"""The plain reference against the served model on the CPU at a tiny
configuration (the port runs its kernels' plain versions there), and the
seeded weights against the served model's own parameters and init."""
import math

import numpy as np
import pytest
import torch

from perfbench.harness import check, configs, deploy, frontend, traffic
from perfbench.harness import registry
from perfbench.reference import vocab

TABLES = frontend.load_tables()
kokoro = registry.family("kokoro")


def _texts(seed, n=3):
    mix = registry.load_json("traffic", "serve-poisson")
    rng = np.random.default_rng(seed)
    return traffic._texts_at(rng, [12, 40, 90][:n], mix["languages"], mix,
                             TABLES, set(), "chars")


@pytest.fixture(scope="module")
def engine():
    torch.set_num_threads(2)
    cfg = kokoro.tiny()
    params = kokoro.make(cfg, 2147483659, "cpu")
    packs = kokoro.voices(cfg, 2147483659, 2, "cpu")
    synth = kokoro.engine(cfg, params, "cpu")
    names = deploy.register_voices(synth, packs)
    return cfg, params, packs, synth, names


def test_weights_fit_the_served_model():
    from illufly_tts_tpu_torch.model.kokoro import KokoroModel

    cfg = configs.load("kokoro82m-zh-f32")
    with torch.device("meta"):
        model = KokoroModel(kokoro.kokoro_config(cfg))
    want = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    got = {n: shape for n, shape, _, _ in kokoro.spec(cfg)}
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == 81_195_448


def test_weights_follow_the_served_init():
    """Per leaf, the served model's own random init (its numpy draw) and
    the benchmark's have the same scale, ones and zeros."""
    from illufly_tts_tpu_torch.model.kokoro import KokoroModel
    from illufly_tts_tpu_torch.model.params import (
        load_flax_params,
        random_flax_params,
    )

    cfg = kokoro.tiny()
    model = KokoroModel(kokoro.kokoro_config(cfg))
    load_flax_params(model, random_flax_params(model, 3))
    ours = kokoro.make({**cfg, "duration_bias": 0.0, "magnitude_gain": 1.0,
                        "f0_gain": 1.0}, 3, "cpu")
    rules = {n: rule for n, _, rule, _ in kokoro.spec(cfg)}
    for name, p in model.state_dict().items():
        q = ours[name]
        if rules[name] != "normal":
            assert torch.equal(p, q), name
        elif p.numel() >= 256:
            assert q.std() == pytest.approx(p.std().item(), rel=0.25), name


def test_same_seed_same_weights():
    cfg = kokoro.tiny()
    a, b = kokoro.make(cfg, 5, "cpu"), kokoro.make(cfg, 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["bert.qkv.weight" if "bert.qkv.weight" in a
                             else "bert.shared_layer.qkv.weight"],
                           kokoro.make(cfg, 6, "cpu")[
                               "bert.shared_layer.qkv.weight"])


def test_batch_render_matches(engine):
    cfg, params, packs, synth, names = engine
    items = _texts(1)
    h = synth.dispatch([r["ipa"] for r in items], [names[0], names[1],
                                                   names[0]],
                       keep_durations=True)
    served = synth.collect(h, pcm16=True)
    judge = kokoro.Judge(cfg, params, packs)
    for i, r in enumerate(items):
        voice = [0, 1, 0][i]
        n = len(vocab.encode(r["ipa"]))
        port = h.host_pred_dur.numpy()[i][:n]
        ref_f, d = judge.durations(r["ipa"], voice)
        ref = judge.ref.quantize(ref_f, torch.ones_like(ref_f))[0].numpy()
        assert np.array_equal(ref, port)
        want = judge.audio(r["ipa"], voice, port, h.f_bucket,
                           {"kind": "pcm16"}, d=d)
        assert want.shape == served[i].shape
        assert check.rel_rms(served[i], want) < 2e-3


def test_bf16_render_at_full_size():
    """The bfloat16 configuration against the float32 reference at its own
    widths (one short utterance at 128 frames): the log-mel distance the
    offline cell compares."""
    from perfbench.reference import mel

    torch.set_num_threads(4)
    cfg = configs.load("kokoro82m-zh-bf16")
    params = kokoro.make(cfg, 99, "cpu")
    packs = kokoro.voices(cfg, 99, 1, "cpu")
    synth = kokoro.engine(cfg, params, "cpu", token_buckets=(64,),
                          frame_buckets=(128,))
    names = deploy.register_voices(synth, packs)
    ipa = "ni↓xau↓ma, ʈʂɤ↘ʂɨ↘i→kɤ↘tsʰɤ↘ʂɨ↘."
    h = synth.dispatch([ipa], names, keep_durations=True)
    served = synth.collect(h, pcm16=True)[0]
    judge = kokoro.Judge(cfg, params, packs)
    port = h.host_pred_dur.numpy()[0][:len(vocab.encode(ipa))]
    want = judge.audio(ipa, 0, port, 128, {"kind": "pcm16"})
    assert mel.gain_matched_l1(served, want) < 0.1


def test_windowed_stream_matches(engine):
    cfg, params, packs, synth, names = engine
    r = _texts(2)[2]
    h = synth.dispatch([r["ipa"]], [names[1]], keep_durations=True)
    chunks = list(synth.stream_decode(h, window_frames=64, halo_frames=16,
                                      exact=False))
    port = h.host_pred_dur.numpy()[0][:len(vocab.encode(r["ipa"]))]
    served = np.concatenate([c[0] for c in chunks])[
        : int(h.fitted_totals[0]) * 600]
    judge = kokoro.Judge(cfg, params, packs)
    want = judge.audio(r["ipa"], 1, port, h.f_bucket,
                       {"kind": "stream", "window": 64, "halo": 16})
    assert check.rel_rms(served, want) < 1e-3


def test_reference_refuses_what_the_engine_refuses():
    """A stream of the 64-frame bucket: window 64 + halo 16 exceed it, in
    the engine and in the reference alike."""
    cfg = kokoro.tiny()
    params = kokoro.make(cfg, 9, "cpu")
    packs = kokoro.voices(cfg, 9, 1, "cpu")
    judge = kokoro.Judge(cfg, params, packs)
    dur = np.full(len(vocab.encode("ni↓xau↓")), 3)
    assert judge.audio("ni↓xau↓", 0, dur, 64,
                       {"kind": "stream", "window": 64, "halo": 16}) is None
