"""How well-conditioned the Generator is on unvoiced and voiced frames, at
the configuration's widths and the seed's weights: the plain reference in
float32, the TF32 control and the program's Generator, each against the
reference in float64, on one input (a random trunk output and style) under
three F0 curves.

    python3 perfbench/conditioning.py [--config kokoro82m-zh-f32] [--seed N]
        [--frames 96] [--device cpu]

prints one JSON line per F0 curve: rms of each side's difference from the
float64 reference over the float64 reference's rms. Where float32 and
float64 of the same arithmetic differ by as much as the control does, no
comparison of waveforms can hold there (``PERF.md``, Open questions): with
the seeded weights a voiced frame's harmonic source reaches the Generator
through the phases of STFT bins that hold only its window's leakage, whose
float32 rounding decides them."""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from perfbench.harness import check, configs, registry  # noqa: E402

CURVES = {  # F0 [Hz] over the utterance's half-frames, t in [0, 1]
    "unvoiced": lambda t: 4.5 + 4.5 * torch.sin(6.2832 * 3 * t),
    "edge": lambda t: 11.5 + 3.5 * torch.sin(6.2832 * 3 * t),
    "voiced": lambda t: 170.0 + 50.0 * torch.sin(6.2832 * 3 * t),
}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt().clamp(min=1e-30))


def readings(cfg: dict, seed: int, frames: int, device: str,
             program: bool = True, family: str = "kokoro") -> list:
    """``family``: the name of the model family ``cfg`` is sized for
    (``perfbench/families/<family>.py``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fam = registry.family(family)
    params = fam.make(cfg, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed ^ 0xF0)
    x = torch.randn(1, 512, frames, generator=gen, device=device)
    s = torch.randn(1, cfg["style_dim"], generator=gen, device=device) * 0.1
    mask = torch.ones(1, frames, device=device)
    t = torch.linspace(0.0, 1.0, frames, device=device)[None]
    port = None
    if program:
        port = fam.model(cfg, params, device).decoder.generator.eval()

    def ref(dtype, quant=None):
        p = {k: v.to(dtype) for k, v in params.items()}
        r = fam.Reference(cfg, p, quant)
        return lambda f0: r.generator(x.to(dtype), s.to(dtype), f0.to(dtype),
                                      mask.to(dtype))

    sides = {"float32": ref(torch.float32),
             "tf32_control": ref(torch.float32, check.round_mantissa(10))}
    want = ref(torch.float64)
    out = []
    with torch.no_grad():
        for name, curve in CURVES.items():
            f0 = curve(t)
            exact = want(f0)
            row = {"f0": name, "f0_hz": [float(f0.min()), float(f0.max())],
                   "rms": float(exact.pow(2).mean().sqrt())}
            for side, fn in sides.items():
                row[side] = _rel(fn(f0), exact)
            if port is not None:
                row["program"] = _rel(port(x, s, f0, mask)[:, :exact.shape[-1]],
                                      exact)
            out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="kokoro82m-zh-f32")
    p.add_argument("--seed", type=int, default=2147483999)
    p.add_argument("--frames", type=int, default=96,
                   help="half-frames of the Generator's input")
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    for row in readings(configs.load(args.config), args.seed, args.frames,
                        args.device,
                        family=configs.family_name(args.config)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
