# -*- coding: utf-8 -*-
"""PyTorch port: the batching scheduler.

Every case of ``tests/test_scheduler.py`` (fairness, per-user ordering,
cancel-pending, format-homogeneous batches, the split-phase FIFO and
decode-ahead, the failure policy, eviction, the soak) runs again with the
port's ``TTSServiceManager``, ``TTSTask`` and ``TaskStatus`` in place of
the JAX package's, against that file's fake pipelines. Then one task set
goes end to end through the port's real pipeline on the CPU, a timestamped
task among them, and the kernels' launch counters are shown exact when
several threads bump them at once."""
import inspect
import os
import sys
import threading

import numpy as np
import pytest
import torch

from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
from illufly_tts_tpu_torch.ops import adain_snake_conv as asc
from illufly_tts_tpu_torch.ops import istft_oa as oa
from illufly_tts_tpu_torch.pipeline import CachedTTSPipeline
from illufly_tts_tpu_torch.runtime import scheduler as port_scheduler
from tests import test_scheduler as jax_cases
from tests.test_torch_params import port_config

torch.set_num_threads(2)

CASES = sorted(name for name, fn in vars(jax_cases).items()
               if name.startswith("test_") and inspect.iscoroutinefunction(fn))


def test_all_scheduler_cases_collected():
    assert len(CASES) >= 20, CASES


@pytest.mark.parametrize("case", CASES)
async def test_scheduler_case_on_the_port(case, monkeypatch, tmp_path):
    for name in ("TTSServiceManager", "TTSTask", "TaskStatus"):
        monkeypatch.setattr(jax_cases, name, getattr(port_scheduler, name))
    fn = getattr(jax_cases, case)
    kwargs = ({"tmp_path": tmp_path}
              if "tmp_path" in inspect.signature(fn).parameters else {})
    await fn(**kwargs)


async def test_end_to_end_on_the_port_pipeline(tmp_path):
    """Text tasks from two users, one with word timestamps and one in
    mulaw8k, through the scheduler's split-phase path on the port's real
    pipeline; each completes in order with audio, stamps and a wav."""
    synth = Synthesizer(port_config(), seed=11, device="cpu",
                        token_buckets=(32, 64), frame_buckets=(64, 128))
    synth.register_random_voice("zf_001", seed=11)
    pipe = CachedTTSPipeline(synthesizer=synth)
    assert pipe.supports_split_phase
    manager = port_scheduler.TTSServiceManager(
        pipeline=pipe, output_dir=str(tmp_path), max_wait_time=0.02)
    await manager.start()
    try:
        specs = [("u1", 1, "集成测试。", "pcm16", True),
                 ("u1", 2, "第二句。", "f32", False),
                 ("u2", 1, "Hello there.", "mulaw8k", False)]
        ids = [await manager.submit_task(
            text, "zf_001", user_id=user, sequence_id=seq,
            output_format=fmt, return_timestamps=stamps)
            for user, seq, text, fmt, stamps in specs]
        for tid in ids:
            status = await jax_cases.wait_status(manager, tid, "completed",
                                                 timeout=120.0)
            assert status["status"] == "completed"
    finally:
        await manager.shutdown()
    tasks = [manager.tasks[tid] for tid in ids]
    assert tasks[0].completed_at <= tasks[1].completed_at
    for task, (_, _, _, fmt, stamps) in zip(tasks, specs):
        audio = task.audio_chunks[0]
        assert audio.size > 0
        assert audio.dtype == {"pcm16": np.int16, "f32": np.float32,
                               "mulaw8k": np.uint8}[fmt]
        assert os.path.exists(tmp_path / f"{task.task_id}.wav")
        if stamps:
            words = task.timestamps
            assert words and words[0]["text"]
            dur = audio.size / 24000
            prev = 0.0
            for w in words:
                assert prev - 1e-6 <= w["start_s"] <= w["end_s"] <= dur + 1e-6
                prev = w["end_s"]
        else:
            assert task.timestamps is None
    stats = manager.stats()
    assert stats["completed"] == 3
    assert {"frontend", "model"} <= set(stats["stage_timers"])


def test_launch_counters_exact_under_threads():
    """The wrappers count launches through ``count_launch``; bumps from
    several threads at once (the scheduler's workers) all land."""
    saved_oa, saved_asc = oa.launches, dict(asc.launches)
    old_interval = sys.getswitchinterval()
    n_threads, n_bumps = 8, 5000
    names = list(asc.launches)
    start = threading.Barrier(n_threads)

    def bump():
        start.wait()
        for _ in range(n_bumps):
            oa.count_launch()
            for name in names:
                asc.count_launch(name)

    try:
        sys.setswitchinterval(1e-6)
        oa.launches = 0
        for name in names:
            asc.launches[name] = 0
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert oa.launches == n_threads * n_bumps
        assert asc.launches == {name: n_threads * n_bumps for name in names}
        # each bump waits for its module's lock
        for mod, bump_one, read in (
                (oa, oa.count_launch, lambda: oa.launches),
                (asc, lambda: asc.count_launch(names[0]),
                 lambda: asc.launches[names[0]])):
            before = read()
            with mod._launches_lock:
                t = threading.Thread(target=bump_one)
                t.start()
                t.join(timeout=0.2)
                assert t.is_alive() and read() == before
            t.join(timeout=60)
            assert not t.is_alive() and read() == before + 1
    finally:
        sys.setswitchinterval(old_interval)
        oa.launches = saved_oa
        asc.launches.update(saved_asc)

