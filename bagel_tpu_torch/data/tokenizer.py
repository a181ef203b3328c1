"""Tokenizer plumbing (a copy of bagel_tpu/data/tokenizer.py).

Released checkpoints use the Qwen2 byte-level BPE tokenizer, loaded here by
`load_tokenizer` with the package's own implementation (data/bpe.py);
`add_special_tokens` registers BAGEL's special tokens as upstream
data_utils.add_special_tokens does. Tests use `MockTokenizer` (no files).
"""

from __future__ import annotations

from typing import List, Tuple

SPECIAL_TOKENS = ["<|im_start|>", "<|im_end|>", "<|vision_start|>", "<|vision_end|>"]


def add_special_tokens(tokenizer) -> Tuple[object, dict, int]:
    """Register BAGEL's special tokens; returns (tokenizer, ids, n_added)."""
    existing = set()
    for v in tokenizer.special_tokens_map.values():
        if isinstance(v, str):
            existing.add(v)
        elif isinstance(v, list):
            existing.update(v)
    num_new = tokenizer.add_tokens([t for t in SPECIAL_TOKENS if t not in existing])
    ids = dict(
        bos_token_id=tokenizer.convert_tokens_to_ids("<|im_start|>"),
        eos_token_id=tokenizer.convert_tokens_to_ids("<|im_end|>"),
        start_of_image=tokenizer.convert_tokens_to_ids("<|vision_start|>"),
        end_of_image=tokenizer.convert_tokens_to_ids("<|vision_end|>"),
    )
    return tokenizer, ids, num_new


def load_tokenizer(path: str):
    """The Qwen2 BPE tokenizer of a checkpoint directory (data/bpe.py), with
    BAGEL's special tokens registered: (tokenizer, ids, n_added)."""
    from bagel_tpu_torch.data.bpe import ByteBPETokenizer

    return add_special_tokens(ByteBPETokenizer.from_checkpoint(path))


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
