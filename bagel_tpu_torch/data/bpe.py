"""Byte-level BPE tokenizer, Qwen2-compatible (a copy of
bagel_tpu/data/bpe.py).

The algorithm of upstream's vendored tokenizer
(modeling/qwen2/tokenization_qwen2.py:1-328): the GPT-2 byte <-> unicode
table, the Qwen2 pre-tokenization regex, greedy lowest-rank pair merging
over the merges ranks, and special tokens that split the input before
pre-tokenization. It loads the released artifacts: vocab.json + merges.txt
(+ the added tokens of tokenizer_config.json) or a tokenizer.json.

`regex` (for the \\p{L}/\\p{N} classes) is the one import beyond the
standard library, and it is imported where a tokenizer is built, not when
this module is imported.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Tuple


# modeling/qwen2/tokenization_qwen2.py:28
PRETOKENIZE_REGEX = (
    r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"""
    r"""| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 reversible byte->printable-unicode table
    (tokenization_qwen2.py:31-53)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return set(zip(word, word[1:]))


class ByteBPETokenizer:
    """Qwen2-style byte-level BPE with added special tokens."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Iterable[Tuple[str, str]],
        special_tokens: Optional[Dict[str, int]] = None,
        eos_token: str = "<|endoftext|>",
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        import regex

        self.pat = regex.compile(PRETOKENIZE_REGEX)
        self.eos_token = eos_token
        self._cache: Dict[str, List[str]] = {}
        # special tokens split the text BEFORE pre-tokenization and map
        # straight to their ids (never merged, never byte-mapped)
        self.special: Dict[str, int] = {}
        self._special_pat = None
        self._special_ids: set = set()
        for tok, tid in (special_tokens or {}).items():
            self.special[tok] = tid
            self.decoder[tid] = tok
            self._special_ids.add(tid)
        self._rebuild_special_pat()

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw):
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_tokenizer_json(cls, path: str, **kw):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        merges = [
            tuple(m) if isinstance(m, list) else tuple(m.split(" "))
            for m in model["merges"]
        ]
        specials = {
            t["content"]: t["id"]
            for t in data.get("added_tokens", [])
        }
        kw.setdefault("special_tokens", specials)
        return cls(model["vocab"], merges, **kw)

    @classmethod
    def from_checkpoint(cls, path: str):
        """HF checkpoint dir: vocab.json+merges.txt preferred,
        tokenizer.json fallback; added tokens from tokenizer_config.json /
        added_tokens.json when present."""
        vocab_f = os.path.join(path, "vocab.json")
        merges_f = os.path.join(path, "merges.txt")
        tok_json = os.path.join(path, "tokenizer.json")
        if os.path.exists(vocab_f) and os.path.exists(merges_f):
            tok = cls.from_files(vocab_f, merges_f)
        elif os.path.exists(tok_json):
            tok = cls.from_tokenizer_json(tok_json)
        else:
            raise FileNotFoundError(
                f"no vocab.json+merges.txt or tokenizer.json under {path}"
            )
        cfg_f = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_f):
            with open(cfg_f, encoding="utf-8") as f:
                cfg = json.load(f)
            for tid, info in sorted(
                cfg.get("added_tokens_decoder", {}).items(),
                key=lambda kv: int(kv[0]),
            ):
                tok._add_special(info["content"], int(tid))
            if cfg.get("eos_token"):
                eos = cfg["eos_token"]
                tok.eos_token = (eos["content"]
                                 if isinstance(eos, dict) else eos)
        added_f = os.path.join(path, "added_tokens.json")
        if os.path.exists(added_f):
            with open(added_f, encoding="utf-8") as f:
                for content, tid in sorted(json.load(f).items(),
                                           key=lambda kv: kv[1]):
                    tok._add_special(content, int(tid))
        tok._rebuild_special_pat()
        return tok

    # -- special tokens -------------------------------------------------------

    def _add_special(self, content: str, tid: Optional[int] = None):
        if content in self.special or content in self.encoder:
            return False
        if tid is None:
            tid = len(self)
        self.special[content] = tid
        self.decoder[tid] = content
        self._special_ids.add(tid)
        return True

    def _rebuild_special_pat(self):
        if self.special:
            import regex

            toks = sorted(self.special, key=len, reverse=True)
            self._special_pat = regex.compile(
                "(" + "|".join(regex.escape(t) for t in toks) + ")"
            )
        else:
            self._special_pat = None

    def add_tokens(self, tokens: List[str]) -> int:
        """HF-compatible: append new special tokens at the end of the
        vocab; returns how many were actually new."""
        n = 0
        for t in tokens:
            if self._add_special(t):
                n += 1
        self._rebuild_special_pat()
        return n

    @property
    def special_tokens_map(self) -> dict:
        return {"eos_token": self.eos_token,
                "additional_special_tokens": list(self.special)}

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        if token in self.special:
            return self.special[token]
        return self.encoder.get(token)

    def __len__(self) -> int:
        ids = list(self.special.values()) or [-1]
        return max(len(self.encoder), max(ids) + 1)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def save_pretrained(self, path: str) -> None:
        """Write the standard HF artifacts (vocab.json, merges.txt,
        added_tokens.json, tokenizer_config.json) so the directory loads
        back through from_checkpoint AND through HF AutoTokenizer."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        merges = sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        with open(os.path.join(path, "merges.txt"), "w",
                  encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in merges:
                f.write(f"{a} {b}\n")
        with open(os.path.join(path, "added_tokens.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.special, f, ensure_ascii=False)
        cfg = {
            "tokenizer_class": "Qwen2Tokenizer",
            "eos_token": self.eos_token,
            "model_max_length": 131072,
            "added_tokens_decoder": {
                str(tid): {"content": tok, "special": True,
                           "lstrip": False, "rstrip": False,
                           "normalized": False, "single_word": False}
                for tok, tid in self.special.items()
            },
        }
        with open(os.path.join(path, "tokenizer_config.json"), "w",
                  encoding="utf-8") as f:
            json.dump(cfg, f, ensure_ascii=False, indent=1)

    # -- BPE core (tokenization_qwen2.py:210-243) -----------------------------

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return [token]
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        if len(self._cache) < 65536:
            self._cache[token] = out
        return out

    # -- public API -----------------------------------------------------------

    def _encode_ordinary(self, text: str) -> List[int]:
        # NFC normalization before pre-tokenization
        # (tokenization_qwen2.py:327)
        text = unicodedata.normalize("NFC", text)
        ids: List[int] = []
        for tok in self.pat.findall(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder[piece])
        return ids

    def encode(self, text: str) -> List[int]:
        if self._special_pat is None:
            return self._encode_ordinary(text)
        ids: List[int] = []
        for chunk in self._special_pat.split(text):
            if not chunk:
                continue
            if chunk in self.special:
                ids.append(self.special[chunk])
            else:
                ids.extend(self._encode_ordinary(chunk))
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        parts: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                text = "".join(buf)
                parts.append(
                    bytearray(self.byte_decoder[c] for c in text).decode(
                        "utf-8", errors="replace"
                    )
                )
                buf.clear()

        for i in ids:
            i = int(i)
            tok = self.decoder.get(i)
            if tok is None:
                continue
            if i in self._special_ids:
                flush()
                if not skip_special_tokens:
                    parts.append(tok)
            else:
                buf.append(tok)
        flush()
        return "".join(parts)
