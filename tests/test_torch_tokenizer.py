"""The byte-level BPE tokenizer of bagel_tpu_torch vs bagel_tpu's, on a BPE
trained on tests/test_tokenizer.py's corpus (no tokenizer files in the
repository).

Bars: the same ids on every text of that file (ASCII, whitespace runs,
contractions, CJK, emoji), the same decoded text, the same special-token
ids and counts from `load_tokenizer`, and a `save_pretrained` round trip.
"""

import json

import pytest

from bagel_tpu.data.bpe import ByteBPETokenizer as JTokenizer
from bagel_tpu.data.tokenizer import load_tokenizer as jload
from bagel_tpu_torch.data.bpe import ByteBPETokenizer, bytes_to_unicode
from bagel_tpu_torch.data.tokenizer import SPECIAL_TOKENS, add_special_tokens, load_tokenizer

from test_tokenizer import PARITY_TEXTS, TRAIN_CORPUS, train_bpe

TEXTS = PARITY_TEXTS + [TRAIN_CORPUS, "<|vision_start|>hello<|vision_end|> <|im_end|>"]


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("bpe")
    vocab, merges = train_bpe(TRAIN_CORPUS)
    vocab["<|endoftext|>"] = len(vocab)
    (td / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (td / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
                                   encoding="utf-8")
    return str(td)


def test_byte_table_matches_jax():
    from bagel_tpu.data.bpe import bytes_to_unicode as jtable

    assert bytes_to_unicode() == jtable()


@pytest.mark.parametrize("loader", ["plain", "special"])
def test_ids_match_jax(bpe_dir, loader):
    if loader == "plain":
        tok, jtok = ByteBPETokenizer.from_checkpoint(bpe_dir), JTokenizer.from_checkpoint(bpe_dir)
    else:
        tok, jtok = load_tokenizer(bpe_dir)[0], jload(bpe_dir)[0]
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text
        assert tok.decode(ids) == jtok.decode(ids)
        assert tok.decode(ids, skip_special_tokens=True) == jtok.decode(
            ids, skip_special_tokens=True)


def test_special_token_ids_match_jax(bpe_dir):
    tok, ids, n = load_tokenizer(bpe_dir)
    _, jids, jn = jload(bpe_dir)
    assert ids == jids and n == jn == len(SPECIAL_TOKENS)
    assert len(tok.encode("<|vision_start|>hello<|vision_end|>")) == 3
    assert add_special_tokens(tok)[2] == 0  # registering again adds nothing


def test_save_pretrained_round_trip(bpe_dir, tmp_path):
    tok, ids, _ = load_tokenizer(bpe_dir)
    tok.save_pretrained(str(tmp_path))
    again, ids2, n = load_tokenizer(str(tmp_path))
    assert n == 0 and ids2 == ids
    assert all(again.encode(t) == tok.encode(t) for t in TEXTS)
    assert jload(str(tmp_path))[1] == ids  # the JAX loader reads the saved files too
