"""The traffic generators: deterministic per seed, inside their ranges, and
the same sizes for every seed, block by block."""

import json
import os

import numpy as np

from benchmark.tests.micro import ROOT
from benchmark.traffic import chat_closed, t2i_closed


def mix(name):
    with open(os.path.join(ROOT, "benchmark", "traffic", name + ".json")) as f:
        return json.load(f)


def test_t2i_deterministic_ranges_and_blocks():
    p = mix("t2i-1024")
    a, b, c = t2i_closed.draw(p, 5), t2i_closed.draw(p, 5), t2i_closed.draw(p, 2**33 + 7)
    assert a == b and a != c and len(a) == p["requests"]
    lo, hi = p["prompt_tokens"]
    assert all(lo <= len(r["prompt"]) <= hi for r in a)
    k = p["block"]
    for i in range(0, len(a), k):
        assert sorted(len(r["prompt"]) for r in a[i:i + k]) == \
            sorted(len(r["prompt"]) for r in c[i:i + k])
    assert len({r["noise_seed"] for r in a}) == len(a)


def sizes(reqs):
    return sorted((len(r["prompt"]), r["max_new_tokens"],
                   None if r["image"] is None else r["image"][1:]) for r in reqs)


def test_chat_deterministic_ranges_and_blocks():
    p = mix("chat-mix-8")
    a, b, c = chat_closed.draw(p, 11), chat_closed.draw(p, 11), chat_closed.draw(p, 2**31 + 3)
    assert a["clients"] == b["clients"] and a["clients"] != c["clients"]
    assert all((x == y).all() for x, y in zip(a["bases"], b["bases"]))
    assert len(a["clients"]) == p["clients"]
    ids = [r["id"] for reqs in a["clients"] for r in reqs]
    assert len(ids) == len(set(ids)) == p["clients"] * p["blocks"] * p["block"]
    k = p["block"]
    for ra, rc in zip(a["clients"], c["clients"]):
        for i in range(0, len(ra), k):
            assert sizes(ra[i:i + k]) == sizes(rc[i:i + k])
            assert sum(r["image"] is not None for r in ra[i:i + k]) == round(k * p["image_share"])
        for r in ra:
            lo, hi = p["answer_tokens"]
            assert lo <= r["max_new_tokens"] <= hi
            if r["image"] is None:
                lo, hi = p["text_tokens"]
            else:
                _, h, w = r["image"]
                assert h % p["patch"] == 0 and w % p["patch"] == 0
                assert max(h, w) <= p["patch"] * p["max_patches"]
                assert max(h, w) >= p["image_side"][0] - p["patch"]
                assert 0.74 <= w / h <= 1.35
                lo, hi = p["question_tokens"]
            assert lo <= len(r["prompt"]) <= hi
    # the clients' blocks differ from each other
    assert sizes(a["clients"][0][:k]) != sizes(a["clients"][1][:k])
    img = chat_closed.to_float(a["bases"], next(r["image"] for r in a["clients"][0] if r["image"]))
    assert img.dtype == np.float32 and img.min() >= -1.0 and img.max() <= 1.0
