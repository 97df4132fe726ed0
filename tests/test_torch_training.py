# -*- coding: utf-8 -*-
"""PyTorch port: gradients through the kernel wrappers, and the training
step against the JAX package on the CPU.

- The wrappers' autograd Functions (``ops/kernel_grad.py``) run here with
  the plain version standing in for each kernel's launch: gradcheck in
  float64 at tiny shapes, gradients equal to native autograd of the plain
  version, the mask without a gradient, no launch in the backward, and no
  graph under ``torch.inference_mode()``.
- Step 0 of the waveform objective on ``small_config`` (short upsampling),
  both packages on the same parameters (the JAX random init) and batch (a
  random target waveform): the loss and each metric within 1e-4 relative,
  every parameter leaf's gradient within 1e-3 relative L2; then one
  clipped AdamW step against optax's. The random init's F0 stays below the
  harmonic source's voiced threshold, so the source is silent and its
  STFT bins dead; pushed voiced (``f0_proj`` bias +100 to +3000), the
  random Generator is chaotic: in the port alone a 1e-7 relative change of
  F0 moves the audio by 0.21 rms/scale, and no two frameworks agree there
  (ROADMAP §3).
- ``bias_hh_l0`` stays 0 and out of the optimizer; resume equals an
  uninterrupted run exactly; ``dataset_batches`` equals JAX's."""
import re

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree
import optax
import pytest
import torch

from illufly_tts_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from illufly_tts_tpu.model.kokoro import KokoroModel as JaxModel
from illufly_tts_tpu.training import step as jax_step
from illufly_tts_tpu_torch.model.kokoro import KokoroModel
from illufly_tts_tpu_torch.model.params import (
    export_flax_params,
    load_flax_params,
    trainable_parameters,
)
from illufly_tts_tpu_torch.ops import adain_snake_conv as asc
from illufly_tts_tpu_torch.ops import istft_oa as oa
from illufly_tts_tpu_torch.training import loop
from illufly_tts_tpu_torch.training import step as port_step
from tests.test_parity_torch import small_config
from tests.test_torch_params import numpy_tree, port_config

torch.set_num_threads(2)

SEED = 5
B, T, FRAMES = 2, 12, 64
LR = 1e-3


# ---- the kernels' autograd Functions, plain versions standing in ---------

@pytest.fixture
def stand_ins(monkeypatch):
    """Route both wrappers' launches to their plain versions, counted."""
    calls = []

    def conv_launch(fn, x, mask, scale, shift, alpha, w, b, k, d, *extra):
        calls.append(fn)
        return asc.adain_snake_conv_plain(x, mask, scale, shift, alpha, w, b,
                                          k, d)

    def istft_launch(entry, inputs, batch, frames):
        calls.append(entry)
        plain = {"head": oa.istft_head_plain, "polar": oa.istft_oa_plain}
        return plain[entry](*inputs)

    monkeypatch.setattr(asc, "_launch", conv_launch)
    monkeypatch.setattr(oa, "_launch", istft_launch)
    return calls


def _conv_inputs(dtype, kernel=3, seed=0):
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, dtype=dtype)

    batch, c, length = 2, 3, 7
    mask = (torch.arange(length)[None] < torch.tensor([[7], [5]])).to(dtype)
    return (randn(batch, c, length), mask, 1 + 0.1 * randn(batch, c),
            0.1 * randn(batch, c), randn(c).abs() + 0.5,
            randn(kernel, c, c) / 3, 0.1 * randn(c))


def _conv_call(name, args, dilation=1):
    return asc._call(name, name, *args, 3, dilation, 128, 1)


@pytest.mark.parametrize("name", ["adain_snake_conv",
                                  "adain_snake_conv_carry"])
def test_conv_function_gradcheck_float64(stand_ins, name):
    args = [t.requires_grad_(i != 1)
            for i, t in enumerate(_conv_inputs(torch.float64))]
    assert torch.autograd.gradcheck(
        lambda x, sc, sh, al, w, b: _conv_call(
            name, (x, args[1], sc, sh, al, w, b), dilation=2),
        [args[i] for i in (0, 2, 3, 4, 5, 6)])


@pytest.mark.parametrize("name", ["adain_snake_conv",
                                  "adain_snake_conv_carry"])
def test_conv_function_grads_equal_native_autograd(stand_ins, name):
    ours = [t.requires_grad_() for t in _conv_inputs(torch.float32)]
    ref = [t.detach().clone().requires_grad_() for t in ours]
    before = asc.launches[name]
    out = _conv_call(name, ours)
    assert type(out.grad_fn).__name__ == "KernelFunctionBackward"
    assert len(stand_ins) == 1
    want = asc.adain_snake_conv_plain(*ref, 3, 1)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    grad = torch.randn_like(out)
    out.backward(grad)
    want.backward(grad)
    assert len(stand_ins) == 1  # the backward launched nothing
    assert asc.launches[name] == before + 1
    assert ours[1].grad is None  # the mask gets no gradient
    for i in (0, 2, 3, 4, 5, 6):
        torch.testing.assert_close(ours[i].grad, ref[i].grad, rtol=1e-6,
                                   atol=1e-6)


def _head_input(dtype):
    g = torch.Generator().manual_seed(3)
    return torch.randn(2, 22, 9, generator=g, dtype=dtype) * 2


def _polar_inputs(dtype):
    g = torch.Generator().manual_seed(4)
    return (torch.rand(2, 9, 11, generator=g, dtype=dtype) + 0.1,
            torch.randn(2, 9, 11, generator=g, dtype=dtype))


@pytest.mark.parametrize("entry", ["head", "polar"])
def test_istft_function_gradcheck_float64(stand_ins, entry):
    if entry == "head":
        x = _head_input(torch.float64).requires_grad_()
        assert torch.autograd.gradcheck(
            lambda x: oa._call("head", oa.istft_head_plain, 2, 9, x), [x])
    else:
        mag, phase = (t.requires_grad_() for t in
                      _polar_inputs(torch.float64))
        assert torch.autograd.gradcheck(
            lambda m, p: oa._call("polar", oa.istft_oa_plain, 2, 9, m, p),
            [mag, phase])


@pytest.mark.parametrize("entry", ["head", "polar"])
def test_istft_function_grads_equal_native_autograd(stand_ins, entry):
    inputs = ((_head_input(torch.float32),) if entry == "head"
              else _polar_inputs(torch.float32))
    plain = oa.istft_head_plain if entry == "head" else oa.istft_oa_plain
    ours = [t.requires_grad_() for t in inputs]
    ref = [t.detach().clone().requires_grad_() for t in ours]
    before = oa.launches
    out = oa._call(entry, plain, 2, 9, *ours)
    want = plain(*ref)
    assert type(out.grad_fn).__name__ == "KernelFunctionBackward"
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    grad = torch.randn_like(out)
    out.backward(grad)
    want.backward(grad)
    assert stand_ins == [entry] and oa.launches == before + 1
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


def test_no_graph_without_grad(stand_ins):
    """Serving (inference mode, no_grad) and inputs without
    ``requires_grad`` launch bare: no Function, no graph."""
    args = [t.requires_grad_(i != 1)
            for i, t in enumerate(_conv_inputs(torch.float32))]
    with torch.inference_mode():
        assert _conv_call("adain_snake_conv", args).grad_fn is None
        assert oa._call("head", oa.istft_head_plain, 2, 9,
                        _head_input(torch.float32)).grad_fn is None
    with torch.no_grad():
        assert _conv_call("adain_snake_conv_carry", args).grad_fn is None
    plain_args = [t.detach() for t in args]
    assert _conv_call("adain_snake_conv", plain_args).grad_fn is None
    assert len(stand_ins) == 4


# ---- step 0 against the JAX package --------------------------------------

def _batch(cfg, seed=0, frames=FRAMES):
    """Two rows (10 and 7 tokens between BOS/EOS), teacher durations 3-4
    frames a token, a random target waveform."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), np.float32)
    for i, n in enumerate((10, 7)):
        ids[i, 1:n + 1] = rng.randint(1, cfg.n_token, n)
        mask[i, :n + 2] = 1.0
    ref = (rng.randn(B, 2 * cfg.style_dim) * 0.1).astype(np.float32)
    dur = (mask * (3 + (rng.rand(B, T) > 0.5))).astype(np.float32)
    audio = (rng.randn(B, frames * cfg.samples_per_frame) * 0.1).astype(
        np.float32)
    return ids, mask, ref, dur, audio


def init_params(jcfg, seed=SEED):
    """The JAX engine's random init as a numpy tree."""
    return numpy_tree(JaxSynthesizer(jcfg, seed=seed).params)


def port_model(jcfg, params) -> KokoroModel:
    model = KokoroModel(port_config(jcfg))
    load_flax_params(model, params)
    return model


def port_batch(arrays) -> port_step.TrainBatch:
    ids, mask, ref, dur, audio = arrays
    return port_step.TrainBatch(torch.from_numpy(ids).long(),
                                *map(torch.from_numpy,
                                     (mask, ref, dur, audio)))


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# leaves whose gradient is no stable number (ROADMAP §3), held to 1e-3 of
# the global gradient norm instead: (1) the bias of every conv whose output
# goes through an instance norm (each AdainResBlk1d's conv1, each
# AdaSnakeResBlock's conv1_j), analytically zero, so both frameworks return
# rounding noise; (2) noise_conv_i, fed the harmonic spectrum of a silent
# source: its output is constant in time up to rounding, which the next
# AdaIN divides by sqrt(var + 1e-5)
DEGENERATE = re.compile(r"(/conv1(?:_\d)?/conv/bias$)|/noise_conv_\d/")


def assert_step0_matches(jcfg, params, arrays, spectral):
    """The port's loss, metrics and every leaf's gradient against JAX's
    ``make_loss_fn`` on the same parameters and batch."""
    jmodel = JaxModel(jcfg)
    jbatch = jax_step.TrainBatch(*map(jnp.asarray, arrays))
    loss_fn = jax_step.make_loss_fn(jmodel, FRAMES, spectral=spectral)
    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch)

    model = port_model(jcfg, params)
    trainable_parameters(model)
    loss, metrics = port_step.make_loss_fn(model, FRAMES,
                                           spectral=spectral)(
        port_batch(arrays))
    loss.backward()
    loss, metrics = loss.detach(), {k: v.detach() for k, v in
                                    metrics.items()}
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert metrics.keys() == jmetrics.keys()
    for key, value in jmetrics.items():
        assert abs(float(metrics[key]) - float(value)) <= 1e-4 * abs(
            float(value)), (key, float(metrics[key]), float(value))
    ours, ref = leaves(export_flax_params(model, grads=True)), leaves(jgrads)
    assert ours.keys() == ref.keys()
    total = np.sqrt(sum(float(np.sum(g ** 2)) for g in ref.values()))
    for key, g in ref.items():
        err = rel_l2(ours[key], g)
        degenerate = DEGENERATE.search(key)
        if degenerate and degenerate.group(1):  # analytically zero
            assert np.linalg.norm(g) <= 1e-5 * total, key
        if degenerate:
            assert np.linalg.norm(ours[key] - g) <= 1e-3 * total, (key, err)
        else:
            assert err <= 1e-3, (key, err)
    return model, jgrads


@pytest.fixture(scope="module")
def step0():
    jcfg = small_config()
    params = init_params(jcfg)
    arrays = _batch(jcfg)
    model, jgrads = assert_step0_matches(jcfg, params, arrays,
                                         spectral=False)
    return jcfg, params, arrays, jgrads


def test_step0_waveform_loss_and_grads_match_jax(step0):
    """The fixture holds the loss, metrics and gradients (see above)."""
    jcfg, params, arrays, jgrads = step0
    assert len(leaves(jgrads)) > 100


def test_one_adamw_step_matches_optax(step0):
    """One clipped AdamW step, in units of the learning rate. Adam's first
    step is g / (|g| + eps) with g clipped by the global norm (126 here),
    so an entry whose gradient is tiny against its leaf's rounding may
    flip: entries may differ by more than 1e-3 of lr only where JAX's
    gradient is below 1e-4, and at most 0.2% of all entries (measured on
    the CPU: 47709 of 30.0 M, all below 8e-5). ``DEGENERATE`` leaves, whose
    gradients are noise, are left out."""
    jcfg, params, arrays, jgrads = step0
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    # optax on the whole tree raveled to one vector: the same global norm
    # and the same per-entry update, in a few eager ops
    flat_g, unravel = ravel_pytree(jgrads)
    flat_p = ravel_pytree(params)[0]
    updates, _ = opt.update(flat_g, opt.init(flat_p), flat_p)
    want = leaves(unravel(updates))

    model = port_model(jcfg, params)
    optimizer = port_step.adamw(trainable_parameters(model), LR)
    port_step.make_train_step(model, optimizer, FRAMES)(port_batch(arrays))
    after = leaves(export_flax_params(model))
    before, grads = leaves(params), leaves(jgrads)
    n_total = n_off = 0
    for key, upd in want.items():
        if DEGENERATE.search(key):
            continue
        off = np.abs((after[key] - before[key]) / LR - upd / LR) > 1e-3
        assert not (off & (np.abs(grads[key]) >= 1e-4)).any(), key
        n_total += off.size
        n_off += int(off.sum())
    assert n_off <= 2e-3 * n_total, (n_off, n_total)


# ---- the loop ---------------------------------------------------------------

LOOP_FRAMES = 16  # the loop tests' frame budget


def _fixed_batches(jcfg, n):
    return [port_batch(_batch(jcfg, seed=10 + i, frames=LOOP_FRAMES))
            for i in range(n)]


def test_bias_hh_stays_zero_and_untrained(step0):
    jcfg, params, _, _ = step0
    model = port_model(jcfg, params)
    _, optimizer, _ = loop.train(model, steps=2, frames=LOOP_FRAMES,
                                 learning_rate=LR, log_every=0,
                                 batches=iter(_fixed_batches(jcfg, 2)))
    in_opt = {id(p) for g in optimizer.param_groups for p in g["params"]}
    names = [n for n, _ in model.named_parameters() if "bias_hh" in n]
    assert len(names) == 12  # 6 bidirectional LSTMs
    for name, p in model.named_parameters():
        if "bias_hh" in name:
            assert not p.requires_grad and not p.any(), name
            assert id(p) not in in_opt, name
        else:
            assert id(p) in in_opt, name


def test_resume_equals_an_uninterrupted_run(step0, tmp_path):
    """Steps 3 and 4 after a restore from step 2's checkpoint give the
    losses of one uninterrupted 4-step run, exactly."""
    jcfg, params, _, _ = step0
    batches = _fixed_batches(jcfg, 4)

    def run(steps, part, **kw):
        losses = []
        loop.train(port_model(jcfg, params), steps=steps,
                   frames=LOOP_FRAMES,
                   learning_rate=LR, log_every=1, batches=iter(part),
                   on_metrics=lambda step, m: losses.append((step,
                                                             m["loss"])),
                   **kw)
        return losses

    whole = run(4, batches)
    ckpt = str(tmp_path / "ckpt")
    run(2, batches[:2], checkpoint_dir=ckpt, checkpoint_every=2)
    resumed = run(2, batches[2:], checkpoint_dir=ckpt, resume=True,
                  checkpoint_every=0)
    assert resumed == whole[2:]
    assert whole[3][1] != whole[2][1]
    from illufly_tts_tpu_torch.training.checkpoint import latest_checkpoint

    assert latest_checkpoint(ckpt).endswith("step_00000004")


def test_dataset_batches_match_jax(tmp_path):
    from illufly_tts_tpu.audio.wav import save_wav
    from illufly_tts_tpu.training import data as jax_data
    from illufly_tts_tpu_torch.training import data as port_data

    rng = np.random.RandomState(0)
    for i, text in enumerate(("你好世界。", "今天天气很好。", "hello there.")):
        wave = (0.1 * np.sin(np.linspace(0, 80 + i, 5400 + 1300 * i))
                + 0.01 * rng.randn(5400 + 1300 * i)).astype(np.float32)
        save_wav(str(tmp_path / f"u{i}.wav"), wave, 22050)
        (tmp_path / f"u{i}.txt").write_text(text, encoding="utf-8")
    kw = dict(sample_rate=24000, style_dim=32, samples_per_frame=600)
    jds = jax_data.SpeechDataset(str(tmp_path), **kw)
    pds = port_data.SpeechDataset(str(tmp_path), **kw)
    assert pds.pairs == jds.pairs
    args = dict(batch_size=2, tokens=24, frames=10, samples_per_frame=600,
                seed=3, vocab_size=64)
    jb = jax_data.dataset_batches(jds, **args)
    pb = port_data.prefetch(port_data.dataset_batches(pds, **args))
    for _ in range(3):
        ours, ref = next(pb), next(jb)
        for key, a, b in zip(port_step.TrainBatch._fields, ours, ref):
            assert isinstance(a, torch.Tensor), key
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=key)


def test_tables_made_while_serving_enter_a_training_graph():
    """The STFT tables and the mel filterbank are cached per device; one
    first made under ``torch.inference_mode()`` (serving) must not be an
    inference tensor, or a training step in the same process raises."""
    from illufly_tts_tpu_torch.audio.mel_torch import mel_l1
    from illufly_tts_tpu_torch.ops.stft import stft_magphase

    with torch.inference_mode():
        stft_magphase(torch.randn(2, 100), 18, 6)
        mel_l1(torch.randn(1, 2048), torch.randn(1, 2048), 16000)
    x = torch.randn(2, 100, requires_grad=True)
    stft_magphase(x, 18, 6)[0].sum().backward()
    a = torch.randn(1, 2048, requires_grad=True)
    mel_l1(a, torch.randn(1, 2048), 16000).backward()
    assert x.grad.abs().sum() > 0 and a.grad.abs().sum() > 0


def test_train_with_a_mesh_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        loop.train(torch.nn.Linear(1, 1), steps=1, mesh=object())


def test_adversarial_train_checkpoints_and_resumes_both_players(step0,
                                                                tmp_path):
    """``train(adversarial=True)``: finite losses, the discriminator saved
    under ``{checkpoint_dir}/disc`` beside the generator, and a resume
    restores both (the resumed run's step count continues)."""
    jcfg, params, arrays, _ = step0
    from illufly_tts_tpu_torch.training.checkpoint import latest_checkpoint

    disc = dict(periods=(2,), resolutions=((128, 32),), base_channels=4,
                max_channels=8)
    ckpt = str(tmp_path / "gan")
    seen = []
    for resume in (False, True):
        loop.train(port_model(jcfg, params), steps=1, frames=FRAMES,
                   learning_rate=LR, log_every=1, adversarial=True,
                   disc_kwargs=disc, checkpoint_dir=ckpt, resume=resume,
                   batches=iter([port_batch(arrays)]),
                   on_metrics=lambda step, m: seen.append((step, m)))
    assert [step for step, _ in seen] == [1, 2]
    for _, m in seen:
        assert {"d_loss", "adv_loss", "fm_loss", "mel_l1"} <= m.keys()
        assert all(np.isfinite(v) for v in m.values()), m
    assert latest_checkpoint(ckpt).endswith("step_00000002")
    assert latest_checkpoint(ckpt + "/disc").endswith("step_00000002")
