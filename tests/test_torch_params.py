# -*- coding: utf-8 -*-
"""PyTorch port: the flax <-> port weight bridge and the random init.

The JAX engine's parameters (host-side numpy init, nothing compiled) go
through ``load_flax_params`` into the port and back out unchanged; a leaf
the port does not have, or a missing one, raises; and the port's own
random init reproduces the JAX one bit for bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from illufly_tts_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from illufly_tts_tpu_torch.model import config as pcfg
from illufly_tts_tpu_torch.model.kokoro import KokoroModel
from illufly_tts_tpu_torch.model.params import (
    export_flax_params,
    load_flax_params,
    random_flax_params,
)
from tests.test_model import tiny_config

torch.set_num_threads(2)

SEED = 123


def port_config(jcfg=None) -> pcfg.KokoroConfig:
    """The port's KokoroConfig with the dimensions of a JAX KokoroConfig
    (default: ``tests.test_model.tiny_config``)."""
    jcfg = jcfg or tiny_config()
    fields = {
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(pcfg.KokoroConfig)
        if f.name not in ("albert", "istftnet", "dtype")
    }
    return pcfg.KokoroConfig(
        albert=pcfg.AlbertConfig(**dataclasses.asdict(jcfg.albert)),
        istftnet=pcfg.IstftNetConfig(**dataclasses.asdict(jcfg.istftnet)),
        **fields,
    )


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    return numpy_tree(JaxSynthesizer(tiny_config(), seed=SEED).params)


def _leaves(tree):
    return {
        "/".join(str(k.key) for k in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def test_round_trip_leaves_nothing_unmapped(jax_params):
    model = KokoroModel(port_config())
    load_flax_params(model, jax_params)
    back = _leaves(export_flax_params(model))
    ref = _leaves(jax_params)
    assert back.keys() == ref.keys()
    for key, leaf in ref.items():
        assert back[key].shape == leaf.shape, key
        np.testing.assert_array_equal(back[key], leaf, err_msg=key)
    # LSTM recurrent biases are folded into bias_ih by flax: zero here
    for name, p in model.named_parameters():
        if name.endswith("bias_hh_l0"):
            assert not p.any(), name


def test_extra_leaf_raises(jax_params):
    model = KokoroModel(port_config())
    tree = {"params": dict(jax_params["params"])}
    tree["params"]["bogus"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unmapped leaves.*bogus"):
        load_flax_params(model, tree)


def test_missing_leaf_raises(jax_params):
    model = KokoroModel(port_config())
    params = dict(jax_params["params"])
    params["bert_encoder"] = {"kernel": params["bert_encoder"]["kernel"]}
    with pytest.raises(ValueError, match="missing leaves.*bert_encoder/bias"):
        load_flax_params(model, {"params": params})


def test_shape_mismatch_raises(jax_params):
    model = KokoroModel(port_config())
    params = dict(jax_params["params"])
    params["bert_encoder"] = {
        "kernel": params["bert_encoder"]["kernel"][:, :-1],
        "bias": params["bert_encoder"]["bias"],
    }
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(model, {"params": params})


def test_random_init_equals_jax(jax_params):
    ours = _leaves(random_flax_params(KokoroModel(port_config()), SEED))
    ref = _leaves(jax_params)
    assert list(ours) == list(ref)  # same leaves in the same order
    for key, leaf in ref.items():
        assert ours[key].dtype == np.float32, key
        np.testing.assert_array_equal(ours[key], leaf, err_msg=key)


def test_full_config_leaf_count():
    with torch.device("meta"):
        model = KokoroModel(pcfg.KokoroConfig())
    from illufly_tts_tpu_torch.model.params import flax_shapes

    shapes = flax_shapes(model)
    assert len(shapes) == 447
    assert sum(int(np.prod(s)) for s in shapes.values()) == 81_183_160


def test_synthesizer_takes_flax_params(jax_params):
    """``Synthesizer(params=...)`` loads a flax tree; the JAX engine's tree
    for a seed equals the port's own draw for that seed."""
    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer

    given = Synthesizer(port_config(), params=jax_params, device="cpu")
    drawn = Synthesizer(port_config(), seed=SEED, device="cpu")
    drawn_state = drawn.model.state_dict()
    for name, value in given.model.state_dict().items():
        assert torch.equal(value, drawn_state[name]), name
