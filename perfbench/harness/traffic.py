"""The general traffic generator: a mix file (``perfbench/traffic/<mix>.json``)
names its ``kind`` and gives its parameters; the kind's function here turns
them and a seed into the run's requests.

Every seed gets the same amount of work in another order: the count of
requests is the rate times the window, lengths are the law's quantiles at
evenly spaced levels, and every count a law splits (requests per user, per
prompt, unique texts) is its share of the whole rounded, all shuffled; only
the words and the order change with the seed.

- ``open_poisson``: independent users sending on a schedule (open loop):
  the gaps between arrivals are the exponential law's quantiles (a Poisson
  process's) in a seeded order, scaled to the window; each user sends its
  Zipf share of the requests, a voice per user; texts unique, or
  (``prompts``) each of a fixed set of prompts its Zipf share of the
  requests, with a fixed share of unique texts among them.
- ``closed_stream``: one client streaming texts one after another; the
  lengths in an order whose every prefix holds each length in its share,
  since the window gets through only part of the list.
- ``offline_batches``: one document cut into sentences, rendered in
  batches back to back.
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import frontend


def _quantiles(levels, law: dict) -> np.ndarray:
    """The lognormal law's quantiles at ``levels`` in (0, 1), clipped."""
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf(u) for u in levels])
    x = np.exp(np.log(law["median"]) + law["sigma"] * z)
    return np.clip(np.round(x), law["min"], law["max"]).astype(int)


def _quantile_lengths(rng, count: int, law: dict) -> np.ndarray:
    """The law's quantiles at (i + 0.5) / count in a seeded order."""
    return rng.permutation(_quantiles((np.arange(count) + 0.5) / count, law))


def _prefix_stratified_lengths(rng, count: int, law: dict) -> np.ndarray:
    """The law's quantiles at levels that fill [0, 1) evenly in every
    prefix (a golden-ratio sequence from a seeded start): a closed loop
    that gets through only part of the list still draws every length in
    its share."""
    levels = (rng.random() + 0.6180339887498949 * np.arange(count)) % 1.0
    return _quantiles(np.clip(levels, 1e-9, 1 - 1e-9), law)


def _shares(weights, count: int) -> np.ndarray:
    """``count`` split in proportion to ``weights``, rounded by the largest
    remainders: the same counts for every seed."""
    exact = np.asarray(weights, float) / np.sum(weights) * count
    out = np.floor(exact).astype(int)
    out[np.argsort(out - exact, kind="stable")[:count - out.sum()]] += 1
    return out


def _arrivals(rng, count: int, seconds: float) -> np.ndarray:
    """``count`` arrival instants in (0, seconds): the ``count + 1`` gaps of
    a Poisson process at the exponential law's quantiles, shuffled, scaled
    to span the window."""
    levels = (np.arange(count + 1) + 0.5) / (count + 1)
    t = np.cumsum(rng.permutation(-np.log1p(-levels)))
    return t[:-1] / t[-1] * seconds


def _drawn(rng, weights, count: int) -> np.ndarray:
    """``count`` indices into ``weights``, each index its share of them
    (``_shares``), in a seeded order; which index holds which share is
    seeded too."""
    n = len(weights)
    return rng.permutation(np.repeat(rng.permutation(n),
                                     _shares(weights, count)))


def _texts_at(rng, targets, lang_shares, mix, tables, taken, key):
    """One unique text per target length (characters, or tokens where
    ``key`` is "tokens")."""
    langs = list(lang_shares)
    p = np.array([lang_shares[k] for k in langs], float)
    p /= p.sum()
    out = []
    law = mix[key]
    for target in targets:
        while True:
            lang = langs[rng.choice(len(langs), p=p)]
            if key == "tokens":
                raw, norm = frontend.compose_tokens(
                    rng, lang, int(target), tables, mix["number_share"],
                    law["max"])
                if raw is None:
                    continue
            else:
                raw, norm = frontend.compose(rng, lang, int(target), tables,
                                             mix["number_share"])
                if len(raw) > law["max"]:
                    continue
            if raw not in taken:
                break
        taken.add(raw)
        out.append({"text": raw, "normalized": norm,
                    "ipa": frontend.expected_ipa(norm, tables), "lang": lang})
    return out


def open_poisson(mix: dict, seed: int, seconds: float, tables: dict,
                 rate=None) -> List[dict]:
    rng = np.random.default_rng(seed)
    rate = mix["rate_per_s"] if rate is None else rate
    count = max(1, int(round(rate * seconds)))
    due = _arrivals(rng, count, seconds)
    users = mix["users"]
    user_of = _drawn(rng, 1.0 / np.arange(1, users + 1) ** mix["user_zipf"],
                     count)
    taken: set = set()
    if "prompts" in mix:
        pr = mix["prompts"]
        prompts = _texts_at(rng, _quantile_lengths(rng, pr["count"],
                                                   mix["chars"]),
                            mix["languages"], mix, tables, taken, "chars")
        n_fresh = int(round(count * pr["unique_share"]))
        fresh = np.zeros(count, bool)
        fresh[rng.permutation(count)[:n_fresh]] = True
        pick = iter(_drawn(rng, 1.0 / np.arange(1, pr["count"] + 1)
                           ** pr["zipf"], count - n_fresh))
        new = _texts_at(rng, _quantile_lengths(rng, max(n_fresh, 1),
                                               mix["chars"]),
                        mix["languages"], mix, tables, taken, "chars")
        it = iter(new)
        items = [next(it) if f else prompts[next(pick)] for f in fresh]
        prefill = [{**p, "voice": 0, "user": "prefill", "index": -1 - i}
                   for i, p in enumerate(prompts)]
    else:
        prefill = []
        items = _texts_at(rng, _quantile_lengths(rng, count, mix["chars"]),
                          mix["languages"], mix, tables, taken, "chars")
    voices = mix["voices"]
    return [{**item, "due": float(t), "user": f"user_{u}",
             "voice": int(u % voices), "index": i}
            for i, (t, u, item) in enumerate(zip(due, user_of, items))], \
        prefill


def closed_stream(mix: dict, seed: int, seconds: float, tables: dict,
                  rate=None) -> List[dict]:
    rng = np.random.default_rng(seed)
    count = mix["streams"]
    items = _texts_at(rng, _prefix_stratified_lengths(rng, count,
                                                      mix["chars"]),
                      mix["languages"], mix, tables, set(), "chars")
    return [{**item, "voice": int(i % mix["voices"]), "index": i}
            for i, item in enumerate(items)], []


def offline_batches(mix: dict, seed: int, seconds: float, tables: dict,
                    rate=None) -> List[dict]:
    rng = np.random.default_rng(seed)
    count = mix["batch"] * mix["batches"]
    items = _texts_at(rng, _quantile_lengths(rng, count, mix["tokens"]),
                      mix["languages"], mix, tables, set(), "tokens")
    return [{**item, "voice": 0, "index": i}
            for i, item in enumerate(items)], []


KINDS = {"open_poisson": open_poisson, "closed_stream": closed_stream,
         "offline_batches": offline_batches}


def generate(mix: dict, seed: int, seconds: float, tables: dict, rate=None):
    """-> (the window's requests, the requests served before it)."""
    return KINDS[mix["kind"]](mix, seed, seconds, tables, rate)
