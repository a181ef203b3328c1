"""The mock tokenizer's ids, as the benchmark hands them to both sides
(a frozen copy of `bagel_tpu_torch.data.tokenizer.MockTokenizer`'s rule:
one id a character, then four special ids at the top of the vocabulary)."""

from __future__ import annotations


def special(vocab: int) -> dict:
    n = vocab - 4
    return {"bos_token_id": n, "eos_token_id": n + 1, "start_of_image": n + 2,
            "end_of_image": n + 3}


def encode(text: str, vocab: int) -> list:
    return [(ord(c) * 7 + 13) % (vocab - 4) for c in text]


def prompt_ids(text: str, vocab: int) -> list:
    """A text block as the engine writes it: bos, the text, eos."""
    s = special(vocab)
    return [s["bos_token_id"]] + encode(text, vocab) + [s["eos_token_id"]]
