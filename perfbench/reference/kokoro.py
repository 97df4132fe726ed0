"""Plain PyTorch reference of the Kokoro-82M stack that the benchmark serves:
StyleTTS2's text side (PL-BERT/ALBERT, the style-conditioned duration
predictor, the F0/energy towers, the text encoder), the AdaIN decoder and
the iSTFTNet Generator with its harmonic source and iSTFT head.

Written from the published architecture, in float32 (float64 where its
weights and inputs are, for ``perfbench/conditioning.py``), one utterance at a
time, with no kernel, graph, cache or batching: every product is a
``torch`` operation. It reads its weights from a dict of tensors named as
the served model names them, so the benchmark hands both sides the same
seeded weights.

``quant`` (a function of a tensor) is applied to both operands of every
product (linear layers, convolutions, attention, the LSTMs' inputs and
weights): the identity for the reference, a rounding for the precision
controls (``perfbench/harness/check.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6      # the ALBERT and text-encoder LayerNorms
NORM_EPS = 1e-5    # instance and AdaLayerNorm
INV_SQRT2 = 1.0 / math.sqrt(2.0)
# (dim_in, dim_out, upsample) of the decoder's four decode blocks
DECODE_SPECS = ((1024 + 2 + 64, 1024, False),) * 3 + ((1024 + 2 + 64, 512, True),)


def _ident(t: torch.Tensor) -> torch.Tensor:
    return t


class Reference:
    """``cfg``: the model's sizes (``perfbench/harness/configs.py``);
    ``params``: name -> float32 tensor on the device the reference runs
    on."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 quant: Optional[Callable] = None):
        self.cfg = cfg
        self.p = params
        self.q = quant or _ident
        self._lstms: Dict[str, torch.nn.LSTM] = {}

    # ---- primitives ---------------------------------------------------------

    def lin(self, x, name):
        return F.linear(self.q(x), self.q(self.p[f"{name}.weight"]),
                        self.p[f"{name}.bias"])

    def conv(self, x, name, stride=1, dilation=1, padding=None, groups=1):
        w = self.p[f"{name}.weight"]
        k = w.shape[-1]
        if padding is None:
            padding = ((k - 1) * dilation) // 2
        return F.conv1d(self.q(x), self.q(w), self.p[f"{name}.bias"],
                        stride=stride, padding=padding, dilation=dilation,
                        groups=groups)

    def conv_t(self, x, name, stride, groups=1):
        w = self.p[f"{name}.weight"]
        k = w.shape[-1]
        pad = max(0, (k - stride + 1) // 2)
        return F.conv_transpose1d(
            self.q(x), self.q(w), self.p[f"{name}.bias"], stride=stride,
            padding=pad, output_padding=stride - k + 2 * pad, groups=groups)

    def layer_norm(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], eps=LN_EPS)

    def lstm(self, x, mask, name):
        """Bidirectional LSTM over each row's valid prefix, [B, T, D] ->
        [B, T, 2H], zero past it (the backward direction starts at the
        row's last valid step)."""
        out = []
        for direction in ("fwd", "bwd"):
            mod = self._lstm(f"{name}.{direction}")
            if direction == "fwd":
                y, _ = mod(self.q(x))
            else:
                y = torch.zeros(x.shape[0], x.shape[1], mod.hidden_size,
                                device=x.device)
                for b in range(x.shape[0]):
                    n = int(mask[b].sum().item())
                    if n:
                        r, _ = mod(self.q(x[b:b + 1, :n].flip(1)))
                        y[b, :n] = r[0].flip(0)
            out.append(y)
        return torch.cat(out, dim=-1) * mask[..., None]

    def _lstm(self, name):
        mod = self._lstms.get(name)
        if mod is None:
            w_ih = self.p[f"{name}.weight_ih_l0"]
            hidden = w_ih.shape[0] // 4
            mod = torch.nn.LSTM(w_ih.shape[1], hidden, batch_first=True)
            mod = mod.to(w_ih.device).requires_grad_(False)
            with torch.no_grad():
                for leaf in ("weight_ih_l0", "weight_hh_l0"):
                    getattr(mod, leaf).copy_(self.q(self.p[f"{name}.{leaf}"]))
                mod.bias_ih_l0.copy_(self.p[f"{name}.bias_ih_l0"])
                mod.bias_hh_l0.copy_(self.p[f"{name}.bias_hh_l0"])
            self._lstms[name] = mod
        return mod

    @staticmethod
    def leaky(x, slope=0.2):
        return torch.where(x >= 0, x, slope * x)

    @staticmethod
    def moments(x, mask):
        """Masked mean and 1/sqrt(var + eps) over time, [B, C, L] -> [B, C]."""
        m = mask[:, None, :]
        count = m.sum(dim=-1).clamp(min=1.0)
        mean = (x * m).sum(dim=-1) / count
        var = ((x - mean[..., None]) ** 2 * m).sum(dim=-1) / count
        return mean, torch.rsqrt(var + NORM_EPS)

    def adain(self, x, s, mask, name):
        gamma, beta = self.lin(s, f"{name}.fc")[:, :, None].chunk(2, dim=1)
        mean, rstd = self.moments(x, mask)
        return (1.0 + gamma) * ((x - mean[..., None]) * rstd[..., None]) + beta

    def ada_layer_norm(self, x, s, name):
        gamma, beta = self.lin(s, f"{name}.fc")[:, None, :].chunk(2, dim=-1)
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        return (1.0 + gamma) * ((x - mean) * torch.rsqrt(var + NORM_EPS)) + beta

    # ---- stage A: text -> durations -------------------------------------------

    def albert(self, ids, mask):
        a = self.cfg["albert"]
        steps = ids.shape[1]
        emb = self.p["bert.tok_emb.weight"][ids] + \
            self.p["bert.pos_emb"][None, :steps]
        x = self.lin(self.layer_norm(emb, "bert.ln_emb"), "bert.emb_proj")
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
        heads = a["num_heads"]
        width = x.shape[-1]
        hd = width // heads
        pre = "bert.shared_layer"
        for _ in range(a["num_layers"]):  # one layer, shared (ALBERT)
            q, k, v = (t.reshape(x.shape[0], steps, heads, hd).transpose(1, 2)
                       for t in self.lin(x, f"{pre}.qkv").chunk(3, dim=-1))
            logits = (self.q(q) @ self.q(k).transpose(-1, -2)) / math.sqrt(hd)
            probs = torch.softmax(logits + bias, dim=-1)
            ctx = (self.q(probs) @ self.q(v)).transpose(1, 2).reshape(x.shape)
            x = self.layer_norm(x + self.lin(ctx, f"{pre}.attn_out"),
                                f"{pre}.ln_attn")
            h = F.gelu(self.lin(x, f"{pre}.ffn_in"), approximate="tanh")
            x = self.layer_norm(x + self.lin(h, f"{pre}.ffn_out"),
                                f"{pre}.ln_ffn")
        return x * mask[..., None]

    def durations(self, ids, mask, ref_s):
        """-> (float durations [B, T] in frames, d [B, T, hidden + style])."""
        style = ref_s[:, self.cfg["style_dim"]:]
        d_en = self.lin(self.albert(ids, mask), "bert_encoder")
        m = mask[..., None]
        s_seq = style[:, None, :].expand(-1, ids.shape[1], -1)
        x = d_en
        pre = "predictor.duration_encoder"
        for i in range(3):
            x = torch.cat([x, s_seq], dim=-1) * m
            x = self.lstm(x, mask, f"{pre}.lstm_{i}")
            x = self.ada_layer_norm(x, style, f"{pre}.adaln_{i}") * m
        d = torch.cat([x, s_seq], dim=-1) * m
        logits = self.lin(self.lstm(d, mask, "predictor.lstm"),
                          "predictor.duration_proj")
        return torch.sigmoid(logits).sum(dim=-1) * mask, d

    @staticmethod
    def quantize(duration, mask):
        """Round half to even, at least one frame a valid token."""
        return (torch.clamp(torch.round(duration), min=1) * mask).long()

    @staticmethod
    def fit(pred_dur, frames):
        """Clip the durations so that they fit ``frames`` frames."""
        cum_prev = torch.cumsum(pred_dur, dim=-1) - pred_dur
        return torch.minimum(torch.clamp(frames - cum_prev, min=0), pred_dur)

    # ---- stage B: durations -> audio ------------------------------------------

    @staticmethod
    def expand(feat, dur, frames):
        """Token features [B, T, C] to frames [B, F, C]; frames past the
        durations repeat the last token."""
        rows = []
        for b in range(feat.shape[0]):
            idx = torch.repeat_interleave(
                torch.arange(feat.shape[1], device=feat.device), dur[b])
            pad = frames - idx.shape[0]
            idx = torch.cat([idx, idx.new_full((pad,), feat.shape[1] - 1)])
            rows.append(feat[b, idx])
        return torch.stack(rows)

    @staticmethod
    def frame_mask(dur, frames):
        pos = torch.arange(frames, device=dur.device)[None, :]
        return (pos < dur.sum(dim=-1, keepdim=True)).float()

    def res_block(self, x, s, mask, name, upsample):
        """AdaIN residual block, channels-first, masked before every conv."""
        up_mask = mask.repeat_interleave(2, dim=1) if upsample else mask

        def m(h, up=False):
            return h * (up_mask if up else mask)[:, None, :]

        h = self.leaky(self.adain(x, s, mask, f"{name}.norm1"))
        if upsample:
            h = self.conv_t(m(h), f"{name}.pool", 2, groups=h.shape[1])
        h = self.conv(m(h, up=upsample), f"{name}.conv1")
        h = self.leaky(self.adain(h, s, up_mask, f"{name}.norm2"))
        h = self.conv(m(h, up=upsample), f"{name}.conv2")
        sc = m(x)
        if upsample:
            sc = sc.repeat_interleave(2, dim=-1)
        if f"{name}.conv1x1.weight" in self.p:
            sc = self.conv(sc, f"{name}.conv1x1")
        return (h + sc) * INV_SQRT2

    def f0n(self, en, style, fmask):
        x = self.lstm(en, fmask, "predictor.shared").transpose(1, 2)
        out = []
        for tower in ("f0", "n"):
            h, m = x, fmask
            for i in range(3):
                h = self.res_block(h, style, m, f"predictor.{tower}_{i}",
                                   upsample=(i == 1))
                if i == 1:
                    m = m.repeat_interleave(2, dim=1)
            out.append(self.conv(h, f"predictor.{tower}_proj")[:, 0, :])
        return out

    def text_encoder(self, ids, mask):
        x = self.p["text_encoder.embed.weight"][ids].transpose(1, 2)
        m = mask[:, None, :]
        for i in range(self.cfg["n_layer"]):
            x = self.conv(x * m, f"text_encoder.conv_{i}")
            x = self.layer_norm(x.transpose(1, 2),
                                f"text_encoder.ln_{i}").transpose(1, 2)
            x = self.leaky(x) * m
        x = self.lstm(x.transpose(1, 2), mask, "text_encoder.lstm")
        return x * m.transpose(1, 2)

    def front(self, ids, mask, d, dur, ref_s, frames):
        """-> (asr [B, H, F], f0 [B, 2F], n [B, 2F], fmask [B, F])."""
        style = ref_s[:, self.cfg["style_dim"]:]
        en = self.expand(d, dur, frames)
        fmask = self.frame_mask(dur, frames)
        f0, n = self.f0n(en, style, fmask)
        asr = self.expand(self.text_encoder(ids, mask), dur, frames)
        return asr.transpose(1, 2), f0, n, fmask

    def trunk(self, asr, f0, n, s, fmask):
        mask2 = fmask.repeat_interleave(2, dim=1)
        f0 = f0 * mask2
        n = n * mask2
        f0c = self.conv(f0[:, None, :], "decoder.f0_conv", stride=2)
        nc = self.conv(n[:, None, :], "decoder.n_conv", stride=2)
        x = self.res_block(torch.cat([asr, f0c, nc], dim=1), s, fmask,
                           "decoder.encode", upsample=False)
        asr_res = self.conv(asr, "decoder.asr_res")
        residual, cur = True, fmask
        for i, (_, _, upsample) in enumerate(DECODE_SPECS):
            if residual:
                x = torch.cat([x, asr_res, f0c, nc], dim=1)
            x = self.res_block(x, s, cur, f"decoder.decode_{i}", upsample)
            if upsample:
                residual = False
                cur = cur.repeat_interleave(2, dim=1)
        return x, f0, cur

    # ---- the Generator ------------------------------------------------------------

    def source(self, f0_up, rad_offset=None):
        """Harmonic source: 8 harmonics and the fundamental, silent where
        F0 is unvoiced, merged by a linear layer and tanh."""
        h = torch.arange(1, 10, dtype=f0_up.dtype, device=f0_up.device)
        rad = torch.cumsum(f0_up / self.cfg["sample_rate"], dim=-1)
        if rad_offset is not None:
            rad = rad + rad_offset[:, None]
        uv = (f0_up > 10.0).float()[..., None]
        sines = 0.1 * torch.sin(2.0 * math.pi * rad[..., None] * h) * uv
        return torch.tanh(self.lin(sines, "decoder.generator.source.merge"))[..., 0]

    def snake_block(self, x, s, mask, name, dilations):
        """Generator residual block: AdaIN, snake, mask and a dilated conv,
        twice a step, one step per dilation."""
        for j, d in enumerate(dilations):
            for n, dil in ((1, d), (2, 1)):
                alpha = self.p[f"{name}.alpha{n}_{j}"]
                h = self.adain(x if n == 1 else h, s, mask,
                               f"{name}.adain{n}_{j}")
                h = (h + (1.0 / alpha) * torch.square(torch.sin(alpha * h)))
                h = self.conv(h * mask[:, None, :], f"{name}.conv{n}_{j}",
                              dilation=dil)
            x = (x + h) * mask[:, None, :]
        return x

    def generator(self, x, s, f0, mask, rad_offset=None):
        net = self.cfg["istftnet"]
        n_fft, hop = net["gen_istft_n_fft"], net["gen_istft_hop_size"]
        rates = net["upsample_rates"]
        f0 = f0 * mask
        x = x * mask[:, None, :]
        f0_up = f0.repeat_interleave(math.prod(rates) * hop, dim=1)
        har = self.source(f0_up, rad_offset)
        har = F.pad(har[:, None, :], (0, n_fft - hop), mode="reflect")[:, 0]
        mag, phase = stft(har, n_fft, hop)
        har_spec = torch.cat([mag, phase], dim=-1).transpose(1, 2)
        cur = mask
        pre = "decoder.generator"
        kernels = net["resblock_kernel_sizes"]
        for i, u in enumerate(rates):
            x = self.conv_t(self.leaky(x, 0.1), f"{pre}.up_{i}", u)
            cur = cur.repeat_interleave(u, dim=1)
            x = x * cur[:, None, :]
            if i + 1 < len(rates):
                stride = math.prod(rates[i + 1:])
                x_src = self.conv(har_spec, f"{pre}.noise_conv_{i}",
                                  stride=stride, padding=(stride + 1) // 2)
            else:
                x_src = self.conv(har_spec, f"{pre}.noise_conv_{i}")
            x = x + self.snake_block(x_src, s, cur, f"{pre}.noise_res_{i}",
                                     (1, 3, 5))
            acc = 0
            for j, dil in enumerate(net["resblock_dilation_sizes"]):
                acc = acc + self.snake_block(x, s, cur, f"{pre}.res_{i}_{j}",
                                             dil)
            x = acc / len(kernels)
        y = self.conv(self.leaky(x, 0.01), f"{pre}.conv_post")
        k = n_fft // 2 + 1
        mag = torch.exp(torch.clamp(y[:, :k], -12.0, 8.0))
        phase = math.pi * torch.sin(y[:, k:])
        return istft(mag.transpose(1, 2), phase.transpose(1, 2), n_fft,
                     hop)[:, : y.shape[-1] * hop]

    # ---- whole utterances -----------------------------------------------------------

    def render(self, ids, mask, d, dur, ref_s, frames):
        """Stage B at ``frames`` frames -> (float audio [B, F * 600] zero
        past each row's frames, fmask)."""
        dur = self.fit(dur, frames)
        asr, f0, n, fmask = self.front(ids, mask, d, dur, ref_s, frames)
        s = ref_s[:, : self.cfg["style_dim"]]
        x, f0m, cur = self.trunk(asr, f0, n, s, fmask)
        audio = self.generator(x, s, f0m, cur)
        return audio * fmask.repeat_interleave(samples_per_frame(self.cfg),
                                               dim=1), fmask

    def stream(self, ids, mask, d, dur, ref_s, frames, window_frames,
               halo_frames):
        """The windowed stream of one utterance at ``frames`` frames: the
        sequence-global part once, then the Generator over windows of
        ``window_frames`` frames with ``halo_frames`` of context on each
        side, neighbouring windows crossfaded over the halo by a linear
        ramp. -> float audio [total frames * 600]."""
        cfg = self.cfg
        spf = samples_per_frame(cfg)
        dur = self.fit(dur, frames)
        total = int(dur.sum())
        asr, f0, n, fmask = self.front(ids, mask, d, dur, ref_s, frames)
        s = ref_s[:, : cfg["style_dim"]]
        x, f0m, cur = self.trunk(asr, f0, n, s, fmask)
        per_pos = f0m * ((spf // 2) / cfg["sample_rate"])
        cum_rad = torch.cumsum(per_pos, dim=-1) - per_pos
        window, halo = 2 * window_frames, 2 * halo_frames  # generator frames
        span, spi = window + 2 * halo, spf // 2
        x_p = F.pad(x, (0, halo))
        f0_p, rad_p, mask_p = (F.pad(t, (0, halo)) for t in (f0m, cum_rad, cur))
        length = x_p.shape[-1]
        if span > length:
            raise ValueError(f"a window of {span} generator frames exceeds "
                             f"the {length} of the utterance")
        body, overlap = window_frames * spf, halo_frames * spf
        ramp = torch.linspace(0.0, 1.0, overlap, device=x.device)
        pieces, tail = [], None
        for start in range(0, 2 * total, window):
            lo = min(max(start - halo, 0), length - span)
            audio = self.generator(x_p[:, :, lo:lo + span], s,
                                   f0_p[:, lo:lo + span],
                                   mask_p[:, lo:lo + span],
                                   rad_offset=rad_p[:, lo])
            emit = window + halo
            a0 = min(max((start - lo) * spi, 0), audio.shape[1] - emit * spi)
            m0 = min(max(start, 0), length - emit)
            chunk = audio[0, a0:a0 + emit * spi] * \
                mask_p[0, m0:m0 + emit].repeat_interleave(spi)
            out = chunk[:body].clone()
            if tail is not None:
                out[:overlap] = tail * (1.0 - ramp) + out[:overlap] * ramp
            tail = chunk[body:body + overlap]
            pieces.append(out)
        return torch.cat(pieces)[: total * spf]


def samples_per_frame(cfg: dict) -> int:
    net = cfg["istftnet"]
    return 2 * net["gen_istft_hop_size"] * math.prod(net["upsample_rates"])


def pcm16(audio: torch.Tensor) -> torch.Tensor:
    """Float audio [B, L] -> int16 as served: scaled to a peak of 1 where it
    clips, clipped, times 32767, rounded."""
    peak = audio.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(peak > 1.0, 1.0 / peak.clamp(min=1e-9),
                        torch.ones_like(peak))
    return torch.round(torch.clamp(audio * scale, -1.0, 1.0) * 32767.0).to(
        torch.int16)


# ---- the tiny STFT of the Generator's head ---------------------------------------


def _bases(n_fft: int, device, dtype=torch.float32):
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    angle = 2.0 * np.pi * np.outer(n, k) / n_fft          # [n_fft, K]
    cos, sin = np.cos(angle), -np.sin(angle)
    cos[np.abs(cos) < 1e-12] = 0.0
    sin[np.abs(sin) < 1e-12] = 0.0
    w = np.full(n_fft // 2 + 1, 2.0 / n_fft)
    w[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        w[-1] = 1.0 / n_fft
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)    # periodic Hann
    to = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return (to(cos), to(sin), to((np.cos(angle) * w).T),
            to((-np.sin(angle) * w).T), to(win))


def stft(x, n_fft, hop):
    """x [B, L] -> (magnitude, phase) [B, frames, n_fft // 2 + 1]; a bin
    with no energy has phase 0."""
    cos, sin, _, _, win = _bases(n_fft, x.device, x.dtype)
    frames = x.unfold(-1, n_fft, hop) * win
    re, im = frames @ cos, frames @ sin
    power = re * re + im * im
    mag = torch.sqrt(power + 1e-9)
    im = torch.where(im == 0.0, torch.zeros_like(im), im)
    dead = power < 1e-12
    re = torch.where(dead, torch.ones_like(re), re)
    im = torch.where(dead, torch.zeros_like(im), im)
    return mag, torch.atan2(im, re)


def istft(mag, phase, n_fft, hop):
    """(magnitude, phase) [B, frames, K] -> audio [B, (frames - 1) * hop +
    n_fft]: Hann-windowed frames overlap-added and divided by the summed
    squared window."""
    _, _, icos, isin, win = _bases(n_fft, mag.device, mag.dtype)
    frames = (mag * torch.cos(phase)) @ icos + (mag * torch.sin(phase)) @ isin
    frames = frames * win
    batch, count, _ = frames.shape
    length = (count - 1) * hop + n_fft
    audio = frames.new_zeros(batch, length)
    env = frames.new_zeros(length)
    for j in range(n_fft // hop):
        audio[:, j * hop:j * hop + count * hop] += \
            frames[:, :, j * hop:(j + 1) * hop].reshape(batch, -1)
        env[j * hop:j * hop + count * hop] += \
            (win * win)[j * hop:(j + 1) * hop].repeat(count)
    return audio / env.clamp(min=1e-8)
