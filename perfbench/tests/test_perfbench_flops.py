"""The Kokoro family's operation and byte counts
(``perfbench/families/kokoro.py``) against counts made by hand at one
shape per kernel."""
import math

import pytest

from perfbench.harness import configs, registry

flops = registry.family("kokoro")

CFG = configs.load("kokoro82m-zh-f32")


def test_generator_launches_of_a_pass():
    launches = list(flops.generator_launches(CFG, 1, 192))
    assert len(launches) == 48
    # first stage: 10x upsampled, 256 channels; second: 60x, 128 channels
    assert {(c, n) for _, c, n, _ in launches} == {(256, 1920),
                                                   (128, 11520)}
    assert sorted({k for *_, k in launches}) == [3, 7, 11]
    # the noise blocks: k 7 in the first stage, 11 in the second, 6 each
    assert sum(1 for _, c, _, k in launches if (c, k) == (256, 7)) == 12
    assert sum(1 for _, c, _, k in launches if (c, k) == (128, 11)) == 12


def test_conv_bound_one_launch_by_hand():
    cfg = {**CFG, "istftnet": {**CFG["istftnet"], "upsample_rates": (1,),
                               "upsample_initial_channel": 256,
                               "resblock_kernel_sizes": (),
                               "resblock_dilation_sizes": ()}}
    # one noise block at k 11, 3 dilations x 2 convs, [B=8, C=128, L=6000]
    launches = list(flops.generator_launches(cfg, 8, 6000))
    assert launches == [(8, 128, 6000, 11)] * 6
    ops = 2 * 8 * 6000 * 128 * 128 * 11
    nbytes = 4 * (2 * 8 * 128 * 6000 + 11 * 128 * 128) + 8 * 6000 * 4 \
        + (2 * 8 * 128 + 2 * 128) * 4
    want = 6 * max(ops / 495e12, nbytes / 3.35e12)
    assert flops.conv_bound(cfg, 8, 6000, "float32") == pytest.approx(want)
    ops_bf16 = ops / 989e12
    nbytes_bf16 = 2 * (2 * 8 * 128 * 6000 + 11 * 128 * 128) + 8 * 6000 * 4 \
        + (2 * 8 * 128 + 2 * 128) * 4
    assert flops.conv_bound(cfg, 8, 6000, "bfloat16") == pytest.approx(
        6 * max(ops_bf16, nbytes_bf16 / 3.35e12))


def test_fold_bound_by_hand():
    launches = list(flops.fold_launches(CFG, 32, 512, 1024, True))
    assert len(launches) == 70
    assert sum(folded for *_, folded in launches) == 48
    b, c, n = 32, 1090, 512  # the first decode block's norm1
    assert (b, c, n, False) in launches
    one = (b * c * n * 2 + b * n * 4 + 2 * b * c * 4) / 3.35e12
    alone = {**CFG, "istftnet": {**CFG["istftnet"], "upsample_rates": ()}}
    front = flops.fold_bound(alone, 32, 512, 0, "bfloat16")
    assert front > one and front == pytest.approx(sum(
        (b * cc * nn * 2 + b * nn * 4 + 2 * b * cc * 4) / 3.35e12
        for b, cc, nn, _ in flops.fold_launches(alone, 32, 512, 0, True)))


def test_stage_a_by_hand():
    t = 100
    albert = 12 * (2 * t * 768 * 2304 + 4 * t * t * 768 + 2 * t * 768 * 768
                   + 4 * t * 768 * 2048)
    lstm = 2 * 2 * t * 4 * 256 * (640 + 256)
    want = 2 * t * 128 * 768 + albert + 2 * t * 768 * 512 + 4 * lstm \
        + 2 * t * 512 * 50
    assert flops.stage_a(CFG, t) == pytest.approx(want)


def test_an_audio_second():
    # 40 frames: about 50 GFLOP, most in the Generator's residual blocks
    ops = flops.utterance(CFG, 14, 40)
    assert 40e9 < ops < 60e9
    gen = sum(2.0 * n * c * c * k
              for _, c, n, k in flops.generator_launches(CFG, 1, 80))
    assert 0.8 < gen / ops < 0.95
    assert math.isclose(flops.peak_ops("bfloat16"), 989e12)
