"""Chat requests for a closed loop of `clients` clients, one request in
flight each.

Parameters (the mix's file): `clients`; `block` (requests a stratified
block), `blocks` (blocks a client's list holds, sent in order and then
again); `image_share` (of each block, the requests that carry one image);
`text_tokens` [lo, hi] (text-only prompts), `question_tokens` [lo, hi]
(the question beside an image), `answer_tokens` [lo, hi]
(`max_new_tokens`, greedy), `image_side` [lo, hi] (the longer side in
pixels) and `aspect` [lo, hi] (width over height), `patch` and
`max_patches` (a side is a multiple of the patch, at most `max_patches`
of them) and `base_images` (the pixel sources images are cut from).
Lengths and sides are log-uniform, aspects uniform, each stratified over a
block (`harness.draws`): every seed gives each client the same blocks of
sizes, shuffled. The session's own settings (`slots`, `decode_chunk`,
`warmup_requests`, `warmup_timeout_s`, `request_timeout_s`,
`trace_seconds`, `check_requests`) sit in the same file.

Pixels are uint8 (HWC); a client turns its image into floats in [-1, 1]
before it sends it (`to_float`).
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.draws import offset, rng, stratified_lin, stratified_log, text


def _shape(side: int, aspect: float, patch: int, most: int):
    h, w = (side / aspect, side) if aspect >= 1 else (side, side * aspect)
    cap = patch * most
    return (min(cap, max(patch, int(h) // patch * patch)),
            min(cap, max(patch, int(w) // patch * patch)))


def _block(p: dict, g: np.random.Generator, place: int) -> list:
    """One block of requests: its requests' sizes fixed by `place` (the
    strata's offsets and how they pair), their order and content by g."""
    b = p["block"]
    n_img = int(round(b * p["image_share"]))
    u1, u2, u3 = offset(place), offset(place, 2), offset(place, 3)
    pair = np.random.default_rng(place)  # the pairing of sizes: the block's, not the seed's
    answers = pair.permutation(stratified_log(*p["answer_tokens"], b, u3))
    texts = pair.permutation(stratified_log(*p["text_tokens"], b - n_img, u1))
    questions = pair.permutation(stratified_log(*p["question_tokens"], n_img, u2))
    sides = pair.permutation(stratified_log(*p["image_side"], n_img, u1))
    aspects = pair.permutation(stratified_lin(*p["aspect"], n_img, u2))
    sizes = [(int(t), None) for t in texts]
    sizes += [(int(q), _shape(int(s), float(a), p["patch"], p["max_patches"]))
              for q, s, a in zip(questions, sides, aspects)]
    out = []
    for i in g.permutation(b):
        n, hw = sizes[i]
        r = {"max_new_tokens": int(answers[i]), "prompt": text(g, n), "image": None}
        if hw is not None:
            r["image"] = (int(g.integers(p["base_images"])),) + hw
        out.append(r)
    return out


def draw(p: dict, seed: int) -> dict:
    """{"clients": [[request, ...] per client], "bases": [uint8 images]}."""
    g = rng(seed, 2)
    cap = p["patch"] * p["max_patches"]
    bases = [g.integers(0, 256, (cap, cap, 3), dtype=np.uint8) for _ in range(p["base_images"])]
    clients, n = [], 0
    for c in range(p["clients"]):
        reqs = []
        for j in range(p["blocks"]):
            for r in _block(p, g, j * p["clients"] + c):
                r["id"] = n
                n += 1
                reqs.append(r)
        clients.append(reqs)
    return {"clients": clients, "bases": bases}


def to_float(bases: list, image) -> np.ndarray:
    """A request's image (base, h, w) as HWC float32 in [-1, 1]."""
    b, h, w = image
    return bases[b][:h, :w].astype(np.float32) * (2.0 / 255.0) - 1.0


def pixels(req: dict):
    """A request's image as (h, w) in pixels, or None."""
    return None if req["image"] is None else tuple(req["image"][1:])
