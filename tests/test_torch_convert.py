# -*- coding: utf-8 -*-
"""PyTorch port: checkpoint conversion and flax msgpack, against the JAX
package on the CPU.

- ``convert_checkpoint`` builds the JAX converter's tree leaf for leaf, bit
  for bit, from ``tests/torch_twin.TwinKModel`` state_dicts at
  ``small_config`` and at the CLI's ``_tiny_cfg``, and with a ``src_vocab``
  row remap; its ``ConversionError`` says what the JAX one says; a full
  ``KokoroConfig()`` twin converts through the port alone with zero
  unmapped tensors.
- ``fold_weight_norm`` (both namings) equals torch's weight norm;
  ``load_torch_checkpoint`` unwraps ``"net"`` and finds ``config.json``.
- Flax msgpack moves both ways: the JAX engine's ``save_params`` file loads
  into the port with equal leaves, and the port's into the JAX engine.
- ``Synthesizer(device="cpu").load_params(x.pth)`` renders what the JAX
  engine renders from the same file (rms/scale < 5e-3, the golden gate),
  with the twin's harmonic source silent."""
import json

import jax
import numpy as np
import pytest
import torch

from illufly_tts_tpu.__main__ import _tiny_cfg as jax_tiny_cfg
from illufly_tts_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from illufly_tts_tpu.model import convert as jax_convert
from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
from illufly_tts_tpu_torch.model import config as pcfg
from illufly_tts_tpu_torch.model import convert
from illufly_tts_tpu_torch.model import flax_msgpack
from illufly_tts_tpu_torch.model.kokoro import KokoroModel
from illufly_tts_tpu_torch.model.params import export_flax_params
from tests.test_parity_torch import small_config
from tests.test_torch_params import numpy_tree, port_config
from tests.torch_twin import TwinKModel

torch.set_num_threads(2)

BUCKETS = dict(token_buckets=(16,), frame_buckets=(64,), batch_buckets=(2,))


def leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_same_tree(ours, ref):
    ours, ref = leaves(ours), leaves(ref)
    assert ours.keys() == ref.keys()
    for key, leaf in ref.items():
        assert ours[key].dtype == np.float32, key
        np.testing.assert_array_equal(ours[key], leaf, err_msg=key)


@pytest.fixture(scope="module")
def small():
    """(JAX config, twin state_dict, the JAX engine's initial params as a
    template, the JAX engine: tests load into it and read it back)."""
    cfg = small_config()
    torch.manual_seed(0)
    state = TwinKModel(cfg).state_dict()
    engine = JaxSynthesizer(cfg, seed=0, **BUCKETS)
    return cfg, state, numpy_tree(engine.params), engine


def test_small_config_converts_as_jax(small):
    cfg, state, template, _ = small
    ref = jax_convert.convert_checkpoint(state, template)
    assert_same_tree(convert.convert_checkpoint(state, template), ref)
    # the port's own zero template (the model's flax shapes) gives the same
    ours = convert.convert_checkpoint(
        state, convert.template(KokoroModel(port_config(cfg))))
    assert_same_tree(ours, ref)


def test_tiny_cli_config_converts_as_jax():
    cfg = jax_tiny_cfg()
    torch.manual_seed(1)
    state = TwinKModel(cfg).state_dict()
    # the port's zero template serves both converters (no vocab remap)
    inner = convert.template(KokoroModel(port_config(cfg)))["params"]
    assert_same_tree(convert.convert_checkpoint(state, inner),
                     jax_convert.convert_checkpoint(state, inner))


def test_vocab_remap_as_jax(small):
    cfg, state, template, _ = small
    from illufly_tts_tpu_torch.model.vocab import VOCAB

    symbols = sorted(VOCAB, key=VOCAB.get)[:40]
    # a source vocab in another order, with symbols this repo lacks
    src_vocab = {sym: (7 * i) % cfg.n_token for i, sym in enumerate(symbols)}
    src_vocab.update({"<absent-1>": 3, "<absent-2>": 5})
    ours = convert.convert_checkpoint(state, template, src_vocab=src_vocab)
    assert_same_tree(ours, jax_convert.convert_checkpoint(
        state, template, src_vocab=src_vocab))
    emb = ours["params"]["bert"]["tok_emb"]["embedding"]
    src = state["bert.embeddings.word_embeddings.weight"].numpy()
    np.testing.assert_array_equal(emb[VOCAB[symbols[3]]], src[21])


@pytest.mark.parametrize("change", ["extra", "missing"])
def test_conversion_error_lists_as_jax(small, change):
    cfg, state, template, _ = small
    state = dict(state)
    if change == "extra":
        state["decoder.bogus.weight"] = torch.zeros(3)
    else:
        del state["decoder.generator.conv_post.bias"]
    with pytest.raises(jax_convert.ConversionError) as ref:
        jax_convert.convert_checkpoint(state, template)
    with pytest.raises(convert.ConversionError) as ours:
        convert.convert_checkpoint(state, template)
    assert str(ours.value) == str(ref.value)
    want = ("unmapped torch tensors (1): ['decoder.bogus.weight']"
            if change == "extra" else
            "unfilled flax leaves (1): "
            "['params/decoder/generator/conv_post/conv/bias']")
    assert want in str(ours.value)


@pytest.mark.parametrize("naming", ["classic", "parametrize"])
def test_fold_weight_norm(naming):
    torch.manual_seed(2)
    conv = torch.nn.Conv1d(4, 6, 3)
    if naming == "classic":
        conv = torch.nn.utils.weight_norm(conv)
    else:
        conv = torch.nn.utils.parametrizations.weight_norm(conv)
    state = {f"m.{k}": v.detach() for k, v in conv.state_dict().items()}
    ours = convert.fold_weight_norm(state)
    assert_same_tree({"w": ours}, {"w": jax_convert.fold_weight_norm(state)})
    assert sorted(ours) == ["m.bias", "m.weight"]
    np.testing.assert_allclose(ours["m.weight"], conv.weight.detach().numpy(),
                               rtol=1e-6, atol=1e-7)


def test_load_torch_checkpoint_net_wrapper_and_config_json(small, tmp_path):
    cfg, state, template, _ = small
    vocab = {"a": 2, "b": 7, "ʃ": 11}
    (tmp_path / "config.json").write_text(json.dumps({"vocab": vocab}),
                                          encoding="utf-8")
    path = str(tmp_path / "kokoro.pth")
    torch.save({"net": state}, path)
    ours = convert.load_torch_checkpoint(path, template)
    assert_same_tree(ours, jax_convert.load_torch_checkpoint(path, template))
    assert_same_tree(ours, convert.convert_checkpoint(state, template,
                                                      src_vocab=vocab))


def test_full_size_twin_converts_with_nothing_unmapped():
    """The shape every real Kokoro checkpoint has, on the port alone."""
    cfg = pcfg.KokoroConfig()
    torch.manual_seed(3)
    state = TwinKModel(cfg).state_dict()
    with torch.device("meta"):
        model = KokoroModel(cfg)
    tree = convert.convert_checkpoint(state, convert.template(model))
    flat = leaves(tree)
    assert len(flat) == 447
    assert sum(v.size for v in flat.values()) == 81_183_160


def test_msgpack_moves_both_ways(small, tmp_path):
    jcfg, _, _, jax_engine = small
    jax_file = str(tmp_path / "jax.msgpack")
    jax_engine.save_params(jax_file)
    port = Synthesizer(port_config(jcfg), seed=9, device="cpu", **BUCKETS)
    port.load_params(jax_file)
    assert_same_tree(export_flax_params(port.model),
                     numpy_tree(jax_engine.params))
    assert_same_tree(flax_msgpack.load(jax_file),
                     numpy_tree(jax_engine.params))

    port2 = Synthesizer(port_config(jcfg), seed=5, device="cpu", **BUCKETS)
    port_file = str(tmp_path / "port.msgpack")
    port2.save_params(port_file)
    jax_engine.load_params(port_file)
    assert_same_tree(numpy_tree(jax_engine.params),
                     export_flax_params(port2.model))


def test_synthesizer_loads_pth_and_renders_as_jax(small, tmp_path):
    """The twin's source merge bias is zeroed: with any other value the
    unvoiced harmonic source is a nonzero constant, whose near-empty STFT
    bins hand the Generator atan2 of rounding noise, and no two frameworks
    agree (ROADMAP §3); at zero the source is silent, its bins dead."""
    cfg, state, _, jax_engine = small
    state = dict(state)
    merge = "decoder.generator.m_source.l_linear.bias"
    state[merge] = torch.zeros_like(state[merge])
    nested = {}
    for key, value in state.items():  # kokoro's {"bert": {...}, ...}
        top, rest = key.split(".", 1)
        nested.setdefault(top, {})[rest] = value
    path = str(tmp_path / "twin.pth")
    torch.save(nested, path)
    engines = (jax_engine,
               Synthesizer(port_config(cfg), device="cpu", **BUCKETS))
    outs = []
    for engine in engines:
        engine.load_params(path)
        engine.register_random_voice("v", seed=1)
        outs.append(engine.synthesize_batch(["ni→xau↓ma", "tʰa→"],
                                            ["v", "v"]))
    for ref, got in zip(*outs):
        assert got.shape == ref.shape and ref.size > 0
        rms = np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2))
        assert rms / np.sqrt(np.mean(ref.astype(np.float64) ** 2)) < 5e-3
