"""Tokenizer plumbing: the deterministic mock tokenizer.

A copy of `MockTokenizer` from `bagel_tpu/data/tokenizer.py`. The real Qwen2
BPE loader (`load_tokenizer`) waits until tokenizer files are in the
repository.
"""

from __future__ import annotations

from typing import List


class MockTokenizer:
    """Deterministic hash tokenizer for tests: reversible for decode display.

    vocab layout: [0..n_text) hashed text ids, then 4 special ids.
    """

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self._n_text = vocab_size - 4
        self.special = {
            "<|im_start|>": self._n_text,
            "<|im_end|>": self._n_text + 1,
            "<|vision_start|>": self._n_text + 2,
            "<|vision_end|>": self._n_text + 3,
        }

    def encode(self, text: str) -> List[int]:
        return [(ord(c) * 7 + 13) % self._n_text for c in text]

    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)

    @property
    def new_token_ids(self) -> dict:
        return dict(
            bos_token_id=self.special["<|im_start|>"],
            eos_token_id=self.special["<|im_end|>"],
            start_of_image=self.special["<|vision_start|>"],
            end_of_image=self.special["<|vision_end|>"],
        )
