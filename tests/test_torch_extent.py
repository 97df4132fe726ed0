# -*- coding: utf-8 -*-
"""PyTorch port: row extents in the bf16 Generator kernels, on the CPU.

With each row's mask extent (one past its last nonzero column) the bf16
fused convs compute only the column tiles that start before the extent
plus the conv's reach ``(k - 1) * d / 2`` and store the bias for the rest,
spread over one wave of CTAs; the AdaIN pass skips the chunks past the
extent. The kernels run only on the card, where ``chip_smoke.py``'s
``check_extents`` holds them bitwise to the launch without extents. Here:

- the split (``work_plan``, the mirror of the source's ``share_of``) over
  the grid the launch has without extents: every tile before the extent
  plus the reach assigned once, none past it, the rest each a bias tile
  once, the CTAs' shares within one tile; whole rows split as without
  extents;
- the premise that makes the split exact: the plain fused op's output at
  columns at or past the extent plus the reach is the bias, bit for bit,
  and the chunked AdaIN arithmetic with the chunks past the extent set to
  (0, 0, 0) is bitwise the full one;
- the wiring: the Generator hands each stage's extents to every residual
  block, and those to both fused calls and the AdaIN pass;
- the tally, summed over the cards launched on, and its way into
  ``TIMERS``' snapshot and ``/metrics``."""
import numpy as np
import pytest
import torch

from illufly_tts_tpu_torch.ops import adain_moments as am
from illufly_tts_tpu_torch.ops import adain_snake_conv as asc
from illufly_tts_tpu_torch.utils.profiling import StageTimers
from illufly_tts_tpu_torch.utils.prometheus import render_prometheus

torch.set_num_threads(2)

SMS = 132  # an H100's SMs: the grid the card's launches take
INVENTORY = [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)]
# the bf16 Generator's two stages at B=32, F 512 (C, L), and B=1
STAGES = [(32, 256, 10240), (32, 128, 61440), (1, 256, 10240),
          (1, 128, 61440)]


def _extents(batch, length, tile_len, pad, seed):
    """Rows at the split's edges (empty, one column, full, a tile edge +-
    the reach +- 1, the reach crossing a tile boundary), then rows of the
    offline cell (120-510 of 512 frames)."""
    edges = [0, 1, length, length - 1]
    for edge in (tile_len, 2 * tile_len):
        edges += [edge - pad - 1, edge - pad, edge - pad + 1, edge + pad - 1,
                  edge + pad, edge + pad + 1, edge - 1, edge + 1]
    rng = np.random.RandomState(seed)
    cell = [int(f) * length // 512 for f in rng.randint(120, 511, size=64)]
    rows = [min(max(e, 0), length) for e in edges + cell]
    if batch == 1:
        return [[e] for e in rows]
    return [rows[:batch], rows[batch:2 * batch]]


def _plan_cases():
    for batch, channels, length in STAGES:
        tile_len = asc.column_tile(batch, channels, length, SMS, bf16=True)
        for k, d in INVENTORY:
            pad = (k - 1) * d // 2
            for i, ext in enumerate(_extents(batch, length, tile_len, pad,
                                             seed=k * 10 + d)):
                if batch == 1 and i % 7:  # B=1: a sample of the rows
                    continue
                yield pytest.param(ext, channels, length, tile_len, pad,
                                   id=f"B{batch}-C{channels}-L{length}-k{k}"
                                   f"-d{d}-{i}")


def _tiles(batch, channels, length, tile_len, pad, walk):
    """The grid's tiles a CTA, as the wrappers give them: the halo tile's
    ``tiles_per_cta``, the walking carry's ``carry_tiles_per_chunk``."""
    if walk:
        return asc.carry_tiles_per_chunk(batch, channels, channels, length,
                                         2 * pad + 1, 1, SMS, tile_len,
                                         bf16=True)
    return asc.tiles_per_cta(batch, channels, length, SMS, tile_len)


@pytest.mark.parametrize("walk", [False, True])
@pytest.mark.parametrize("extents,channels,length,tile_len,pad",
                         list(_plan_cases()))
def test_work_plan_covers_each_reached_tile_once(extents, channels, length,
                                                 tile_len, pad, walk):
    """Every (row, C_out tile, column tile) whose tile starts before the
    row's extent + reach (clipped to the row; none for an empty row) is
    computed by exactly one CTA of the grid the launch has without
    extents, every other tile is a bias tile of exactly one CTA, and the
    CTAs' shares of each list differ by at most one; where every row is
    whole, the split is the one without extents."""
    batch = len(extents)
    co_tiles = -(-channels // asc.COUT_TILE)
    n_tiles = -(-length // tile_len)
    tiles = _tiles(batch, channels, length, tile_len, pad, walk)
    plan = asc.work_plan(extents, channels, length, tile_len, pad, tiles)
    assert len(plan) == batch * co_tiles * -(-n_tiles // tiles)
    assert len(plan) <= SMS or tiles == 1  # about one wave
    work = [t for share, _ in plan for t in share]
    bias = [t for _, share in plan for t in share]
    reached = {(b, co, t) for b, e in enumerate(extents)
               for co in range(co_tiles) for t in range(n_tiles)
               if e > 0 and t * tile_len < e + pad}
    assert len(work) == len(set(work)) and set(work) == reached
    assert len(bias) == len(set(bias))
    assert set(bias) == {(b, co, t) for b in range(batch)
                         for co in range(co_tiles)
                         for t in range(n_tiles)} - reached
    if bias:
        for part in (0, 1):
            sizes = [len(shares[part]) for shares in plan]
            assert max(sizes) - min(sizes) <= 1
    else:
        assert plan == asc.work_plan([length] * batch, channels, length,
                                     tile_len, pad, tiles)
    # each CTA's computed tiles are consecutive in the (b, co, tile) order,
    # so within a segment a share is a run of neighbouring tiles (the
    # walking carry's premise)
    for share, _ in plan:
        assert share == sorted(share)
        for prev, cur in zip(share, share[1:]):
            if prev[:2] == cur[:2]:
                assert cur[2] == prev[2] + 1


@pytest.mark.parametrize("batch,channels,length", STAGES + [(8, 128, 61440),
                                                          (1, 256, 1920),
                                                          (1, 128, 11520)])
def test_full_extents_keep_the_split_without_them(batch, channels, length):
    """Full masks (and the stream windows' and B=8 shapes) compute the whole
    grid, each CTA its run of tiles of one (row, C_out tile), in the grid's
    order: the split without extents (the tally reads 1.0 there)."""
    tile_len = asc.column_tile(batch, channels, length, SMS, bf16=True)
    tiles = asc.tiles_per_cta(batch, channels, length, SMS, tile_len)
    plan = asc.work_plan([length] * batch, channels, length, tile_len, 25,
                         tiles)
    n_tiles = -(-length // tile_len)
    runs = -(-n_tiles // tiles)
    co_tiles = -(-channels // asc.COUT_TILE)
    assert len(plan) == batch * co_tiles * runs
    for i, (work, bias) in enumerate(plan):
        b, co, x = i // (co_tiles * runs), (i // runs) % co_tiles, i % runs
        assert work == [(b, co, t) for t in range(
            x * tiles, min(n_tiles, (x + 1) * tiles))]
        assert bias == []


def test_work_tiles():
    assert asc.work_tiles(0, 1000, 256, 25) == 0
    assert asc.work_tiles(1, 1000, 256, 0) == 1
    assert asc.work_tiles(231, 1000, 256, 25) == 1   # 231 + 25 = 256
    assert asc.work_tiles(232, 1000, 256, 25) == 2
    assert asc.work_tiles(1000, 1000, 256, 25) == 4  # clipped to the row
    assert asc.work_tiles(999, 1000, 256, 0) == 4


def test_mask_extent():
    mask = torch.tensor([[1, 1, 1, 0, 0], [0, 0, 0, 0, 0], [1, 0, 1, 0, 1],
                         [0, 1, 0, 0, 0], [0.5, 0, 0, 0.25, 0]])
    ext = asc.mask_extent(mask)
    assert ext.dtype == torch.int32
    assert ext.tolist() == [3, 0, 5, 2, 4]
    assert asc.mask_extent(mask.bfloat16()).tolist() == [3, 0, 5, 2, 4]


def _conv_args(batch, channels, length, k, extents, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(batch, channels, length, generator=g) * 0.5).to(dtype)
    mask = (torch.arange(length)[None, :]
            < torch.tensor(extents)[:, None]).float()
    mask[0, ::5] = 0.0  # holes inside an extent change nothing
    return (x, mask, 1.0 + 0.1 * torch.randn(batch, channels, generator=g),
            0.1 * torch.randn(batch, channels, generator=g),
            torch.rand(channels, generator=g) + 0.5,
            torch.randn(k, channels, channels, generator=g) / (channels * k)
            ** 0.5, torch.randn(channels, generator=g) * 0.1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,d", [(3, 1), (3, 5), (7, 3), (11, 1), (11, 5)])
def test_output_past_the_reach_is_the_bias(dtype, k, d):
    """The plain fused op (the kernels' arithmetic) under ragged masks: at
    every column at or past the row's extent + (k - 1) d / 2 the output is
    the bias (bf16: rounded, + 0 first) bit for bit, and so are the bias
    tiles the split stores; the columns just inside the reach are not."""
    batch, channels, length = 4, 32, 300
    pad = (k - 1) * d // 2
    extents = [300, 0, 137, 61]
    args = _conv_args(batch, channels, length, k, extents, dtype, k + d)
    ext = asc.mask_extent(args[1])
    y = asc.adain_snake_conv_plain(*args, k, d, extent=ext)
    assert torch.equal(y, asc.adain_snake_conv_plain(*args, k, d))
    bias = (0.0 + args[-1]).to(dtype)
    tile_len = 64
    for b, e in enumerate(ext.tolist()):
        tail = y[b, :, min(length, e + pad):]
        assert torch.equal(tail, bias[:, None].expand_as(tail))
        stored = y[b, :, min(length, tile_len * asc.work_tiles(
            e, length, tile_len, pad)):]
        assert torch.equal(stored, bias[:, None].expand_as(stored))
        if 0 < e and e + pad <= length and pad > 0:
            # within the reach, valid inputs still contribute
            assert not torch.equal(y[b, :, e + pad - 1],
                                   bias.to(y.dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("chunk", [64, 4096])
def test_skipped_chunks_leave_the_fold_bitwise(dtype, folded, chunk):
    """The AdaIN pass's chunked arithmetic with every chunk that starts at
    or past its row's extent given (count, mean, M2) = (0, 0, 0), as the
    kernel writes without reading it, is bitwise the full computation: the
    full pass gives those chunks (+0, +0, +0), and Chan's combine leaves
    n, mean and M2 unchanged by them."""
    g = torch.Generator().manual_seed(chunk + folded)
    batch, channels, length = 5, 8, 9000
    extents = [9000, 0, 4096, 4097, 130]
    x = (torch.randn(batch, channels, length, generator=g) * 1.5
         + 0.3).to(dtype)
    mask = (torch.arange(length)[None, :]
            < torch.tensor(extents)[:, None]).float()
    gamma, beta = (0.3 * torch.randn(2, batch, channels,
                                     generator=g)).unbind(0)
    fold = (gamma, beta) if folded else (None, None)
    full = am.adain_fold_chunked_plain(x, mask, *fold, chunk=chunk)
    skipped = am.adain_fold_chunked_plain(
        x, mask, *fold, chunk=chunk, skip_past=asc.mask_extent(mask))
    for a, b in zip(full, skipped):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # the wrapper takes the extents (its plain path on the CPU)
    got = am.adain_fold(x, mask, *fold, extent=asc.mask_extent(mask))
    for a, b in zip(got, am.adain_fold(x, mask, *fold)):
        assert torch.equal(a, b)


def test_extent_arguments_are_checked():
    x = torch.zeros(2, 4, 10)
    mask = torch.ones(2, 10)
    with pytest.raises(ValueError, match="extent"):
        am.adain_fold(x, None, None, None,
                      extent=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="extent"):
        am.adain_fold(x, mask, None, None, extent=torch.zeros(2))
    args = (x.bfloat16(), mask, torch.ones(2, 4), torch.zeros(2, 4),
            torch.ones(4), torch.zeros(3, 4, 4), torch.zeros(4), 3)
    for fn in (asc.adain_snake_conv, asc.adain_snake_conv_carry):
        with pytest.raises(ValueError, match="extent"):
            fn(*args, extent=torch.zeros(3, dtype=torch.int32))
        with pytest.raises(ValueError, match="extent"):
            fn(*args, extent=torch.zeros(2, dtype=torch.int64))
        # taken, and every column computed (the CPU's plain version)
        assert torch.equal(fn(*args, extent=torch.zeros(2, dtype=torch.int32)),
                           fn(*args))


def test_generator_hands_each_stage_its_extents(monkeypatch):
    """Each residual block of a bfloat16 Generator stage gets the extents
    of that stage's mask, and passes them to both fused calls and the AdaIN
    pass; without a mask, none; a float32 Generator, whose convs compute
    every column, none either."""
    from illufly_tts_tpu_torch.model import layers, vocoder
    from illufly_tts_tpu_torch.model.config import IstftNetConfig, KokoroConfig
    from illufly_tts_tpu_torch.model.kokoro import to_compute_dtype

    cfg = KokoroConfig(istftnet=IstftNetConfig(
        upsample_rates=(2, 3), upsample_kernel_sizes=(4, 6),
        upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
        resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), gen_istft_n_fft=20,
        gen_istft_hop_size=5))
    torch.manual_seed(0)
    gen = vocoder.Generator(cfg, 16).eval()
    gen16 = to_compute_dtype(vocoder.Generator(cfg, 16).eval(),
                             torch.bfloat16)
    seen = {"conv": [], "fold": []}

    def spy(kind, fn):
        def call(*args, extent=None, **kw):
            mask = args[1]
            seen[kind].append((mask.shape[1], None if extent is None
                               else extent.tolist(), mask))
            return fn(*args, extent=extent, **kw)
        return call

    for name in ("adain_snake_conv", "adain_snake_conv_carry"):
        monkeypatch.setattr(layers, name, spy("conv", getattr(layers, name)))
    monkeypatch.setattr(layers, "adain_fold", spy("fold", layers.adain_fold))
    frames = 12
    mask = (torch.arange(frames)[None, :]
            < torch.tensor([12, 5, 0])[:, None]).float()
    x = torch.randn(3, 16, frames)
    s = torch.randn(3, cfg.style_dim)
    f0 = torch.zeros(3, frames)
    with torch.no_grad():
        gen16(x.bfloat16(), s.bfloat16(), f0, mask)
    lengths = {frames * 2: [24, 10, 0], frames * 6: [72, 30, 0]}
    for kind in ("conv", "fold"):
        assert seen[kind] and {n for n, _, _ in seen[kind]} == set(lengths)
        for n, ext, m in seen[kind]:
            assert ext == lengths[n]
            assert ext == asc.mask_extent(m).tolist()
    for run in (lambda: gen16(x.bfloat16(), s.bfloat16(), f0),
                lambda: gen16(x.bfloat16(), s.bfloat16(), f0, mask,
                              extents=False),
                lambda: gen(x, s, f0, mask)):
        seen["conv"].clear()
        seen["fold"].clear()
        with torch.no_grad():
            run()
        assert seen["conv"] and seen["fold"]
        assert all(e is None for kind in ("conv", "fold")
                   for _, e, _ in seen[kind])


def test_stream_windows_pass_no_extents():
    """``decode_window`` renders its window with the mask and without row
    extents: a window's rows are whole but near the stream's end."""
    from types import SimpleNamespace

    from illufly_tts_tpu_torch.model.kokoro import KokoroModel

    calls = []

    def generate(x, s, f0, mask, rad_offset=None, extents=True):
        calls.append((mask.shape, extents))
        return torch.zeros(x.shape[0], x.shape[-1] * 300)

    net = SimpleNamespace(
        config=SimpleNamespace(style_split=4, dtype=torch.bfloat16,
                               samples_per_frame=600),
        decoder=SimpleNamespace(generate=generate))
    frames = 40
    mask = torch.ones(1, frames)
    audio = KokoroModel.decode_window(
        net, torch.zeros(1, 8, frames), torch.zeros(1, frames),
        torch.zeros(1, frames), mask, torch.zeros(1, 8), 8, 16, 4)
    assert calls == [(torch.Size([1, 24]), False)]
    assert audio.shape == (1, 20 * 300)


def test_readers_join_the_snapshot_and_metrics():
    """A reader's counters appear in ``snapshot()`` under its name (left out
    while it reads None) and in ``/metrics`` as the bf16 convs' tile
    counters and computed share, not as a stage."""
    t = StageTimers()
    reading = [None]
    t.add_reader("bf16_conv_columns", lambda: reading[0])
    t.add("frontend", 0.25)
    assert set(t.snapshot()) == {"frontend"}
    reading[0] = {"computed_tiles": 620, "grid_tiles": 1000,
                  "computed_share": 0.62}
    snap = t.snapshot()
    assert snap["bf16_conv_columns"] == reading[0]
    text = render_prometheus({"stage_timers": snap})
    assert "tts_bf16_conv_tiles_computed_total 620" in text
    assert "tts_bf16_conv_tiles_grid_total 1000" in text
    assert "tts_bf16_conv_computed_share 0.62" in text
    assert 'stage="bf16_conv_columns"' not in text
    assert 'tts_stage_invocations_total{stage="frontend"} 1' in text


def test_tally_reads_nothing_without_the_library(monkeypatch):
    """On a host that never launched a bf16 conv the tally is None (nothing
    touches CUDA), so the engine's snapshot leaves it out."""
    from illufly_tts_tpu_torch.utils.profiling import TIMERS

    monkeypatch.setattr(asc, "_TALLIED", set())
    assert asc.columns_tally() is None
    assert "bf16_conv_columns" not in TIMERS.snapshot()


def test_tally_sums_the_cards_launched_on(monkeypatch):
    """The tally sums each card's counter that a bf16 conv launched on,
    read on that card with its own stream; no other card is read."""
    import contextlib

    counters = {0: (620, 1000), 1: (30, 50), 2: (7, 9)}
    current = [None]
    reads = []

    class Lib:
        @staticmethod
        def adain_snake_conv_tally(out, stream):
            reads.append((current[0], stream))
            out[0], out[1] = counters[current[0]]
            return 0

    @contextlib.contextmanager
    def device(index):
        current[0] = index
        yield
        current[0] = None

    monkeypatch.setattr(asc, "_TALLIED", {1, 0})
    monkeypatch.setattr(asc, "_library", lambda: Lib)
    monkeypatch.setattr(asc, "_tally_stream",
                        lambda index: type("S", (), {"cuda_stream": 100 + index}))
    monkeypatch.setattr(asc.torch.cuda, "device", device)
    assert asc.columns_tally() == {"computed_tiles": 650, "grid_tiles": 1050,
                                   "computed_share": 650 / 1050}
    assert reads == [(0, 100), (1, 101)]
