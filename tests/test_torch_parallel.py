# -*- coding: utf-8 -*-
"""PyTorch port: data parallelism (``parallel/mesh.py``, ``Synthesizer(mesh=)``,
``train(mesh=)``) against the JAX package on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's meshes repeat the CPU device (``make_mesh(devices=[cpu] * n)``),
one replica per 'data' index. Gates, each with its reason:

- ``param_spec``: equal to JAX's on every leaf of ``tiny_config`` (JAX's
  own tree) and of ``KokoroConfig()`` (the port's flax paths and shapes).
- Serving: the port's 8-way mesh engine against the JAX 8-way mesh engine
  on the same parameters, by the golden parity gate (rms/scale < 5e-3,
  ``tests/test_torch_synthesizer.py``), and against the port's one-device
  engine by ``tests/test_sharding.py``'s gate (atol 5e-4 of max(peak, 1));
  JAX's four serving cases of ``tests/test_sharding.py`` run on the port
  through ``tests/torch_port_cases.py``.
- Streams: a one-request windowed stream on the mesh engine is bitwise the
  one-device engine's (each replica renders one row, as the one-device
  engine does); an exact stream concatenates bitwise to the mesh engine's
  own ``collect``.
- Training (``small_config``, 4 rows whose mask sums differ): the 4-way
  mesh step's loss equals the one-device step's within 1e-6 relative (the
  loss is computed on the gathered outputs) and every gradient leaf within
  the rule of ``tests/test_torch_training.py`` (1e-3 relative L2,
  ``DEGENERATE`` leaves 1e-3 of the global norm); the mean of per-shard
  losses misses it (what a per-shard reduction would give); against the
  JAX step on a (4 x 1) mesh, the loss within 1e-4 relative, the gradients
  by the same rule, and one clipped AdamW step: the entries whose update
  differs from optax's by more than 1e-3 of lr, none where |g| >= 2e-4 and
  at most twice as many as between JAX's own mesh and one-device steps
  (``SMALL_GRAD`` says why this batch needs that form).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from illufly_tts_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from illufly_tts_tpu.model.kokoro import KokoroModel as JaxKokoro
from illufly_tts_tpu.parallel import mesh as jax_mesh
from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
from illufly_tts_tpu_torch.model.config import KokoroConfig
from illufly_tts_tpu_torch.model.kokoro import KokoroModel
from illufly_tts_tpu_torch.model.params import (
    export_flax_params,
    flax_shapes,
)
from illufly_tts_tpu_torch.parallel import mesh as port_mesh
from illufly_tts_tpu_torch.parallel.replicas import Replicas
from illufly_tts_tpu_torch.training import loop
from illufly_tts_tpu_torch.training import step as port_step
from tests import test_sharding as jax_cases
from tests import torch_port_cases as port_cases
from tests.test_model import tiny_config
from tests.test_parity_torch import small_config
from tests.test_torch_params import port_config
from tests.test_torch_training import (
    DEGENERATE,
    LR,
    T,
    init_params,
    jax_step,
    leaves,
    port_model,
    rel_l2,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")
TEXTS = ["ni→xau↓", "tsʰɤ↘ʂɨ↘", "a→", "ma→ma→", "ni→", "xau↓",
         "tsai↘tɕjɛn↘", "i→əɹ↘"]  # tests/test_sharding.py's batch
BUCKETS = dict(token_buckets=(16,), frame_buckets=(64,))


def cpu_mesh(n_data, n_model=1):
    return port_mesh.make_mesh(n_data=n_data, n_model=n_model,
                               devices=[CPU] * (n_data * n_model))


# ---- the mesh and the partition rules ---------------------------------------

def test_param_spec_matches_jax_on_tiny_and_full_configs():
    jcfg = tiny_config()
    jmodel = JaxKokoro(jcfg)
    ids = jnp.zeros((1, 16), jnp.int32)
    mask = jnp.ones((1, 16))
    ref = jnp.zeros((1, 2 * jcfg.style_dim))
    tree = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), ids,
                                              mask, ref, num_frames=32))
    jax_specs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(p.key) for p in path if hasattr(p, "key"))
        jax_specs[name] = tuple(jax_mesh.param_spec(name, leaf.shape))
    mesh = cpu_mesh(4, 2)
    ours = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            else:
                assert value.mesh is mesh
                ours["/".join(path + (key,))] = tuple(value.spec)

    walk(port_mesh.param_shardings(KokoroModel(port_config(jcfg)), mesh),
         ())
    assert ours == jax_specs
    assert any("model" in spec for spec in ours.values())
    with torch.device("meta"):
        full = KokoroModel(KokoroConfig())
    shapes = flax_shapes(full)
    assert len(shapes) > 400
    split = 0
    for path, shape in shapes.items():
        name = "/".join(("params",) + path)
        spec = port_mesh.param_spec(name, shape)
        assert tuple(spec) == tuple(jax_mesh.param_spec(name, shape)), name
        split += "model" in spec
    assert split > 100


def test_make_mesh_shape_and_assert():
    mesh = port_mesh.make_mesh(n_model=2, devices=[CPU] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.devices.shape == (4, 2) and len(mesh.data_devices) == 4
    assert port_mesh.make_mesh(n_data=3, devices=[CPU] * 8).shape == {
        "data": 3, "model": 1}
    with pytest.raises(AssertionError, match=r"^\(3, 1, 2\)"):
        port_mesh.make_mesh(n_data=3, devices=[CPU] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_mesh.make_mesh(n_data=1)
    else:
        assert port_mesh.make_mesh().shape["data"] == (
            torch.cuda.device_count())


def test_shardings_place_rows_and_replicas():
    mesh = cpu_mesh(4)
    x = torch.arange(24.0).reshape(8, 3)
    parts = port_mesh.batch_sharding(mesh).place(x)
    assert [p.tolist() for p in parts] == [x[2 * i:2 * i + 2].tolist()
                                           for i in range(4)]
    assert torch.equal(port_mesh.gather(parts, CPU), x)
    assert all(torch.equal(p, x)
               for p in port_mesh.replicated(mesh).place(x))
    with pytest.raises(ValueError, match="does not divide the 4-way"):
        port_mesh.batch_sharding(mesh).place(x[:6])
    model = KokoroModel(port_config())
    replicas = port_mesh.shard_params(model, mesh)
    assert replicas[0] is model and len({id(r) for r in replicas}) == 4
    for rep in replicas[1:]:
        for p, q in zip(rep.parameters(), model.parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=0)


# ---- serving ------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """The port's one-device and 8-way mesh engines and the JAX 8-way mesh
    engine, on one set of parameters, with one voice."""
    single = Synthesizer(config=port_config(), device="cpu", **BUCKETS)
    mesh = Synthesizer(config=port_config(), params=single.params,
                       mesh=cpu_mesh(8), **BUCKETS)
    jax_engine = JaxSynthesizer(config=tiny_config(), params=single.params,
                                mesh=jax_mesh.make_mesh(n_data=8), **BUCKETS)
    for s in (single, mesh, jax_engine):
        s.register_random_voice("v", seed=3)
    return single, mesh, jax_engine


def test_mesh_engine_matches_jax_mesh_and_single_engine(engines):
    single, mesh, jax_engine = engines
    h = mesh.dispatch(TEXTS, ["v"] * 8)
    assert h.b_bucket == 8 and [s.b_bucket for s in h.shards] == [1] * 8
    ours = mesh.collect(h)
    theirs = jax_engine.synthesize_batch(TEXTS, ["v"] * 8)
    base = single.synthesize_batch(TEXTS, ["v"] * 8)
    assert len(ours) == len(theirs) == len(base) == 8
    for a, j, b in zip(ours, theirs, base):
        assert a.size == j.size == b.size
        rms = float(np.sqrt(np.mean((a - j) ** 2)))
        assert rms / float(np.sqrt(np.mean(j ** 2))) < 5e-3
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-4)


def test_mesh_keeps_durations_pitch_and_speed(engines):
    """``keep_durations`` (timestamps' ``rendered_durations``), speeds and
    pitches through the replicas, as on one device."""
    single, mesh, _ = engines
    kw = dict(speeds=[1.0, 1.2, 0.9], pitches=[1.0, 1.3, 0.8],
              keep_durations=True)
    hm = mesh.dispatch(TEXTS[:3], ["v"] * 3, **kw)
    hs = single.dispatch(TEXTS[:3], ["v"] * 3, **kw)
    durations = mesh.rendered_durations(hm)
    assert durations.shape == (3, 16)
    np.testing.assert_array_equal(durations, single.rendered_durations(hs))
    for a, b in zip(mesh.collect(hm), single.collect(hs)):
        assert a.size == b.size
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-4)


def test_mesh_frame_bucket_is_one_for_the_batch():
    """Rows whose own totals pick different frame buckets render at the
    batch's one bucket, as the one-device engine does."""
    single = Synthesizer(config=port_config(), device="cpu",
                         token_buckets=(32,), frame_buckets=(32, 64, 128))
    mesh = Synthesizer(config=port_config(), params=single.params,
                       mesh=cpu_mesh(2), token_buckets=(32,),
                       frame_buckets=(32, 64, 128))
    texts = ["a→", "tsai↘tɕjɛn↘ ni→xau↓ ma→ma→ i→əɹ↘"]
    for s in (single, mesh):
        s.register_random_voice("v", seed=3)
    hs, hm = single.dispatch(texts, ["v"] * 2), mesh.dispatch(texts, ["v"] * 2)
    totals = [s.totals.numpy() for s in hm.shards]
    picks = {port_pick(mesh, t) for t in totals}
    assert len(picks) == 2  # each shard alone would pick another bucket
    assert mesh._pick_f_bucket(hm) == single._pick_f_bucket(hs) == max(picks)
    for a, b in zip(mesh.collect(hm), single.collect(hs)):
        assert a.size == b.size


def port_pick(engine, totals):
    from illufly_tts_tpu_torch.engine.buckets import pick

    return pick(engine.frame_buckets, int(totals.max()))


def test_mesh_batch_buckets_round_to_the_axis():
    s = Synthesizer(config=port_config(), mesh=cpu_mesh(6), **BUCKETS)
    assert s.batch_buckets == (1, 2, 4, 8, 16, 32, 64)
    assert [s._batch_bucket(n) for n in (1, 6, 7, 12, 13, 36, 64)] == [
        6, 6, 12, 12, 18, 36, 66]


JAX_SERVING_CASES = port_cases.collect(jax_cases, exclude=(
    "test_data_parallel_inference", "test_tensor_parallel_train_step",
    "test_param_specs_cover_tp"))
API_MODULES = {f"illufly_tts_tpu.{name}": f"illufly_tts_tpu_torch.{name}"
               for name in ("api.auth", "api.dev_mode", "api.endpoints",
                            "api.jwt_hs256", "audio.wav")}


def test_all_jax_serving_cases_collected():
    assert len(JAX_SERVING_CASES) == 4, sorted(JAX_SERVING_CASES)


@pytest.mark.parametrize("case", sorted(JAX_SERVING_CASES))
def test_jax_serving_case_on_the_port(case, monkeypatch, tmp_path):
    port_cases.use_port_engine(monkeypatch, jax_cases, ("tiny_config",),
                               extra=API_MODULES)
    monkeypatch.setattr(
        jax_cases, "make_mesh",
        lambda n_data=None, n_model=1: port_mesh.make_mesh(
            n_data, n_model, devices=[CPU] * 8))
    # the HTTP case sets these itself: restored afterwards
    monkeypatch.setenv("FASTAPI_SECRET_KEY", "test-secret")
    monkeypatch.delenv("TTS_DEV_MODE", raising=False)
    port_cases.run(jax_cases, JAX_SERVING_CASES[case], tmp_path=tmp_path)


# ---- streams and graphs on a mesh --------------------------------------------

def test_mesh_streams(engines):
    single, mesh, _ = engines
    h = mesh.dispatch(TEXTS[6:7], ["v"])
    assert h.b_bucket == 8
    win = list(mesh.stream_decode(h, window_frames=32, halo_frames=8,
                                  exact=False))
    hs = single.dispatch(TEXTS[6:7], ["v"])
    want = list(single.stream_decode(hs, window_frames=32, halo_frames=8,
                                     exact=False))
    assert [c.shape for c in win] == [c.shape for c in want]
    for a, b in zip(win, want):
        assert a.tobytes() == b.tobytes()
    assert ("win", 1, 64, 64, 16) in mesh._replicas[7]._graphs
    h = mesh.dispatch(TEXTS, ["v"] * 8, fmt="f32")
    exact = np.concatenate(list(mesh.stream_decode(h, window_frames=16)),
                           axis=1)
    for i, clip in enumerate(mesh.collect(h)):
        assert exact[i, : clip.size].tobytes() == clip.tobytes()


def test_mesh_warmup_and_load_params(engines, tmp_path):
    """``warmup`` captures every replica's keys at its rows of each batch;
    a served batch replays them on every replica; ``load_params`` drops
    every replica's graphs and renders as a fresh mesh engine does."""
    single, _, _ = engines
    s = Synthesizer(config=port_config(), params=single.params,
                    mesh=cpu_mesh(2), **BUCKETS)
    s.register_random_voice("v", seed=3)
    eager = s.synthesize_batch(TEXTS[:4], ["v"] * 4)
    s.warmup(batch_sizes=(4,), token_sizes=(16,), frame_sizes=(64,),
             formats=("pcm16",))
    for rep in s._replicas:
        assert set(rep._graphs) == {(2, 16), (2, 16, 64, "pcm16")}
    replayed = s.synthesize_batch(TEXTS[:4], ["v"] * 4)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(eager, replayed))
    for rep in s._replicas:
        assert rep.graph_replays == {(2, 16): 1, (2, 16, 64, "pcm16"): 1}
    assert s.absorb_drain() > 0
    path = str(tmp_path / "other.msgpack")
    other = Synthesizer(config=port_config(), seed=7, device="cpu",
                        **BUCKETS)
    other.save_params(path)
    s.load_params(path)
    assert all(not rep._graphs for rep in s._replicas)
    fresh = Synthesizer(config=port_config(), params=other.params,
                        mesh=cpu_mesh(2), **BUCKETS)
    fresh.register_random_voice("v", seed=3)
    a = s.synthesize_batch(TEXTS[:4], ["v"] * 4)
    b = fresh.synthesize_batch(TEXTS[:4], ["v"] * 4)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


def test_bf16_mesh_engine_serves():
    s = Synthesizer(config=dataclasses.replace(port_config(),
                                               dtype=torch.bfloat16),
                    mesh=cpu_mesh(2), **BUCKETS)
    s.register_random_voice("v", seed=3)
    assert all(rep.net.config.dtype == torch.bfloat16
               for rep in s._replicas)
    assert s._replicas[0].net is not s.model
    out = s.synthesize_batch(TEXTS[:3], ["v"] * 3, fmt="f32")
    assert all(np.isfinite(a).all() and a.size > 0 for a in out)


# ---- training -----------------------------------------------------------------

ROWS = (10, 7, 4, 9)  # tokens between BOS/EOS: the shards' mask sums differ
FRAMES = 64


def _mesh_batch(cfg):
    rng = np.random.RandomState(3)
    b = len(ROWS)
    ids = np.zeros((b, T), np.int32)
    mask = np.zeros((b, T), np.float32)
    for i, n in enumerate(ROWS):
        ids[i, 1:n + 1] = rng.randint(1, cfg.n_token, n)
        mask[i, :n + 2] = 1.0
    ref = (rng.randn(b, 2 * cfg.style_dim) * 0.1).astype(np.float32)
    dur = (mask * (3 + (rng.rand(b, T) > 0.5))).astype(np.float32)
    audio = (rng.randn(b, FRAMES * cfg.samples_per_frame) * 0.1).astype(
        np.float32)
    return ids, mask, ref, dur, audio


def _port_batch(arrays):
    ids, *rest = arrays
    return port_step.TrainBatch(torch.from_numpy(ids).long(),
                                *map(torch.from_numpy, rest))


def _grads(replicas, batch):
    """Loss, metrics and the master's gradient leaves of one step."""
    replicas.train()
    loss, metrics = port_step.make_loss_fn(replicas, FRAMES)(batch)
    loss.backward()
    replicas.reduce_grads()
    return (float(loss.detach()), {k: float(v) for k, v in metrics.items()},
            leaves(export_flax_params(replicas.master, grads=True)))


def _assert_grads_close(ours, ref):
    assert ours.keys() == ref.keys()
    total = np.sqrt(sum(float(np.sum(g ** 2)) for g in ref.values()))
    for key, g in ref.items():
        if DEGENERATE.search(key):
            assert np.linalg.norm(ours[key] - g) <= 1e-3 * total, key
        else:
            assert rel_l2(ours[key], g) <= 1e-3, key


@pytest.fixture(scope="module")
def train_setup():
    jcfg = small_config()
    params = init_params(jcfg)
    arrays = _mesh_batch(jcfg)
    assert len({float(m.sum()) for m in arrays[1]}) == len(ROWS)
    return jcfg, params, arrays


def test_mesh_step_equals_single_device_step(train_setup):
    jcfg, params, arrays = train_setup
    batch = _port_batch(arrays)
    single = _grads(Replicas(port_model(jcfg, params)), batch)
    mesh = _grads(Replicas(port_model(jcfg, params), cpu_mesh(4)), batch)
    assert mesh[0] == pytest.approx(single[0], rel=1e-6)
    for key, value in single[1].items():
        assert mesh[1][key] == pytest.approx(value, rel=1e-6), key
    _assert_grads_close(mesh[2], single[2])
    # the mean of per-shard losses (each shard normalized by its own mask)
    # is another objective on this batch
    model = port_model(jcfg, params)
    loss_fn = port_step.make_loss_fn(model, FRAMES)
    with torch.no_grad():
        per_shard = [float(loss_fn(port_step.TrainBatch(
            *(t[i:i + 1] for t in batch)))[0]) for i in range(len(ROWS))]
    assert abs(np.mean(per_shard) - single[0]) > 1e-4 * single[0]


# Adam's first step is g_c / (|g_c| + eps), g_c the clipped gradient: an
# entry moves by eps / |g_c| times its relative error, so how many entries
# move by more than 1e-3 of lr depends on the batch. On this one JAX's own
# step on the (4 x 1) mesh and on one device differ in 149059 of 30.0 M
# entries (0.5%, past test_one_adamw_step_matches_optax's 0.2% budget), and
# two entries of decode_2's conv1x1 kernel with |g| 1.0e-4 and 1.2e-4 (that
# test's batch had none above 8e-5) differ by 2.6e-3 of lr. So: no such
# entry where |g| >= 2e-4, and at most twice as many as JAX's own.
SMALL_GRAD = 2e-4


def _adamw_update(params, grads) -> dict:
    """optax's clipped AdamW first step on ``grads``, per leaf."""
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    flat_g, unravel = ravel_pytree(grads)
    flat_p = ravel_pytree(params)[0]
    updates, _ = opt.update(flat_g, opt.init(flat_p), flat_p)
    return leaves(unravel(updates))


def _n_off(ours: dict, theirs: dict, grads: dict) -> int:
    """Entries (``DEGENERATE`` leaves left out) whose updates differ by
    more than 1e-3 of lr; none may where |grads| >= ``SMALL_GRAD``."""
    n_off = 0
    for key, upd in theirs.items():
        if DEGENERATE.search(key):
            continue
        off = np.abs(ours[key] / LR - upd / LR) > 1e-3
        assert not (off & (np.abs(grads[key]) >= SMALL_GRAD)).any(), key
        n_off += int(off.sum())
    return n_off


def test_train_mesh_step_matches_jax_mesh_step(train_setup):
    """``train(mesh=<4 replicas>)`` one step against the JAX loss and
    gradients on a (4 x 1) mesh and optax's clipped AdamW step on them."""
    jcfg, params, arrays = train_setup
    jmesh = jax_mesh.make_mesh(n_data=4, n_model=1)
    loss_fn = jax.jit(jax.value_and_grad(jax_step.make_loss_fn(
        JaxKokoro(jcfg), FRAMES), has_aux=True))
    batch = jax_step.TrainBatch(*map(jnp.asarray, arrays))
    (jloss, _), jgrads = loss_fn(
        jax_mesh.shard_params(params, jmesh), jax_step.TrainBatch(*(
            jax.device_put(a, jax_mesh.batch_sharding(jmesh))
            for a in batch)))
    jgrads = jax.device_get(jgrads)
    one_device = jax.device_get(loss_fn(params, batch)[1])

    seen = []
    model = port_model(jcfg, params)
    master, _, _ = loop.train(
        model, steps=1, frames=FRAMES, learning_rate=LR, log_every=1,
        batches=iter([_port_batch(arrays)]), mesh=cpu_mesh(4),
        on_metrics=lambda step, m: seen.append(m))
    assert master is model
    assert abs(seen[0]["loss"] - float(jloss)) <= 1e-4 * abs(float(jloss))
    replicas = Replicas(port_model(jcfg, params), cpu_mesh(4))
    _assert_grads_close(_grads(replicas, _port_batch(arrays))[2],
                        leaves(jgrads))

    want = _adamw_update(params, jgrads)
    after, before = leaves(export_flax_params(master)), leaves(params)
    ours = {key: after[key] - before[key] for key in want}
    n_ours = _n_off(ours, want, leaves(jgrads))
    n_jax = _n_off(_adamw_update(params, one_device), want,
                   leaves(jgrads))
    assert 0 < n_ours <= 2 * n_jax, (n_ours, n_jax)


def test_train_mesh_indivisible_batch_raises(train_setup):
    jcfg, params, arrays = train_setup
    batch = port_step.TrainBatch(*(t[:3] for t in _port_batch(arrays)))
    with pytest.raises(ValueError, match="does not divide the 4-way"):
        loop.train(port_model(jcfg, params), steps=1, frames=FRAMES,
                   batches=iter([batch]), mesh=cpu_mesh(4))


def test_train_mesh_rounds_the_batch_size(train_setup, monkeypatch):
    """``batch_size`` 3 on a 2-way axis draws batches of 4, as the JAX
    trainer rounds it; the replicas hold the master's weights after the
    step."""
    jcfg, params, _ = train_setup
    drawn = []
    synthetic = loop.synthetic_batches

    def keep(*args, **kw):
        for item in synthetic(*args, **kw):
            drawn.append(item.input_ids.shape[0])
            yield item

    monkeypatch.setattr(loop, "synthetic_batches", keep)
    model = port_model(jcfg, params)
    replicas = []
    make = loop.Replicas

    def spy(*args, **kw):
        replicas.append(make(*args, **kw))
        return replicas[-1]

    monkeypatch.setattr(loop, "Replicas", spy)
    loop.train(model, steps=1, batch_size=3, tokens=T, frames=16,
               log_every=0, mesh=cpu_mesh(2))
    assert drawn == [4]
    (reps,) = replicas
    for p, q in zip(reps.models[1].parameters(), model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_train_mesh_adversarial_step(train_setup):
    """``adversarial=True`` on a 2-way mesh: the discriminator runs on the
    first device over the gathered audio; both players step."""
    jcfg, params, arrays = train_setup
    seen = []
    loop.train(port_model(jcfg, params), steps=1, frames=FRAMES,
               log_every=1, adversarial=True, mesh=cpu_mesh(2),
               disc_kwargs=dict(periods=(2,), resolutions=((128, 32),),
                                base_channels=4, max_channels=8),
               batches=iter([_port_batch(arrays)]),
               on_metrics=lambda step, m: seen.append(m))
    (metrics,) = seen
    assert {"d_loss", "adv_loss", "fm_loss", "mel_l1"} <= metrics.keys()
    assert all(np.isfinite(v) for v in metrics.values()), metrics

