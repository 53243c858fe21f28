"""Text tokenization: the port's own copy of
``sceneverse_tpu/data/tokenizer.py``.

The reference tokenizes with HF ``BertTokenizer('bert-base-uncased')``
(reference modules/language/bert.py:12-14, data/datasets/dataset_wrapper.py).
This module provides:

  * ``WordPieceTokenizer`` — a self-contained WordPiece implementation with
    the BERT special-token protocol ([CLS] ... [SEP] + [PAD]); loads a real
    ``vocab.txt`` when one is available (HF cache or an explicit path),
  * a deterministic hash-vocabulary fallback for zero-egress environments
    (words map to stable ids in the wordpiece range) so the full pipeline
    runs without the BERT vocab file — NOT token-compatible with real BERT
    (parity evaluation requires the real vocab.txt, which ships with every
    released checkpoint).
"""

from __future__ import annotations

import hashlib
import os
import unicodedata
from typing import List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102
MASK_ID = 103
BERT_VOCAB_SIZE = 30522

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")

# --- HF BasicTokenizer character classes (tokenization_bert.py semantics) ---


def _is_whitespace(ch: str) -> bool:
    if ch in " \t\n\r":
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alnum ranges are punctuation even when unicode says otherwise
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _clean_text(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out.append(" " if _is_whitespace(ch) else ch)
    return "".join(out)


def _strip_accents(token: str) -> str:
    return "".join(
        c for c in unicodedata.normalize("NFD", token)
        if unicodedata.category(c) != "Mn"
    )


def _split_on_punc(token: str, never_split) -> List[str]:
    if token in never_split:
        return [token]
    chars = list(token)
    out: List[List[str]] = []
    start_new = True
    for ch in chars:
        if _is_punctuation(ch):
            out.append([ch])
            start_new = True
        else:
            if start_new:
                out.append([])
            start_new = False
            out[-1].append(ch)
    return ["".join(x) for x in out]


def _basic_tokenize(text: str, never_split=frozenset(SPECIAL_TOKENS),
                    do_lower_case: bool = True) -> List[str]:
    """HF ``BasicTokenizer`` parity (bert-base-uncased defaults:
    do_lower_case=True, tokenize_chinese_chars=True, strip_accents=None):
    control-char cleanup, CJK-char isolation, NFC normalization,
    lowercase + accent stripping, punctuation splitting, never-split
    special tokens (reference tokenizes via HF BertTokenizer,
    reference modules/language/bert.py:12-14)."""
    text = _clean_text(text)
    spaced = []
    for ch in text:
        if _is_chinese_char(ord(ch)):
            spaced.extend((" ", ch, " "))
        else:
            spaced.append(ch)
    text = unicodedata.normalize("NFC", "".join(spaced))
    split_tokens: List[str] = []
    for token in text.split():
        if token not in never_split:
            if do_lower_case:
                token = _strip_accents(token.lower())
        split_tokens.extend(_split_on_punc(token, never_split))
    return " ".join(split_tokens).split()


class WordPieceTokenizer:
    def __init__(self, vocab_file: Optional[str] = None,
                 vocab_size: int = BERT_VOCAB_SIZE):
        self.vocab_size = vocab_size
        self.pad_token_id = PAD_ID
        self.cls_token_id = CLS_ID
        self.sep_token_id = SEP_ID
        self.mask_token_id = MASK_ID
        self.unk_token_id = UNK_ID
        self.vocab = None
        if vocab_file and os.path.isfile(vocab_file):
            with open(vocab_file, encoding="utf-8") as f:
                tokens = [line.rstrip("\n") for line in f]
            self.vocab = {t: i for i, t in enumerate(tokens)}
            self.vocab_size = len(tokens)
            self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
            self.pad_token_id = self.vocab.get("[PAD]", PAD_ID)
            self.cls_token_id = self.vocab.get("[CLS]", CLS_ID)
            self.sep_token_id = self.vocab.get("[SEP]", SEP_ID)
            self.mask_token_id = self.vocab.get("[MASK]", MASK_ID)
            self.unk_token_id = self.vocab.get("[UNK]", UNK_ID)

    # -- word -> ids ----------------------------------------------------------
    def _wordpiece(self, word: str) -> List[int]:
        if self.vocab is None:
            # deterministic hash id in the wordpiece range [1000, vocab)
            h = int(hashlib.md5(word.encode()).hexdigest(), 16)
            return [1000 + h % (self.vocab_size - 1000)]
        if len(word) > 100:  # HF WordpieceTokenizer max_input_chars_per_word
            return [self.unk_token_id]
        ids = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_token_id]
            ids.append(cur)
            start = end
        return ids

    def tokenize_to_ids(self, text: str) -> List[int]:
        special = {
            "[PAD]": self.pad_token_id, "[UNK]": self.unk_token_id,
            "[CLS]": self.cls_token_id, "[SEP]": self.sep_token_id,
            "[MASK]": self.mask_token_id,
        }
        ids = []
        for word in _basic_tokenize(text):
            if word in special:
                ids.append(special[word])
            else:
                ids.extend(self._wordpiece(word))
        return ids

    def encode(self, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """[CLS] tokens [SEP] + pad, truncation to max_length (HF
        padding='max_length', truncation=True semantics)."""
        ids = self.tokenize_to_ids(text)[: max_length - 2]
        ids = [self.cls_token_id] + ids + [self.sep_token_id]
        n = len(ids)
        out = np.full(max_length, self.pad_token_id, np.int64)
        out[:n] = ids
        mask = np.zeros(max_length, np.int64)
        mask[:n] = 1
        return out, mask

    def batch_encode(self, texts: Sequence[str], max_length: int):
        pairs = [self.encode(t, max_length) for t in texts]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def decode(self, ids) -> str:
        if self.vocab is None:
            return " ".join(f"<{i}>" for i in ids)
        toks = [self.ids_to_tokens.get(int(i), "[UNK]") for i in ids]
        out = []
        for t in toks:
            if t in ("[PAD]", "[CLS]", "[SEP]"):
                continue
            if t.startswith("##") and out:
                out[-1] += t[2:]
            else:
                out.append(t)
        return " ".join(out)


_CACHED = {}


def get_tokenizer(cfg=None) -> WordPieceTokenizer:
    """Resolve the tokenizer: explicit ``cfg.data.vocab_file``, then common
    cache locations, then the hash fallback."""
    vocab_file = None
    if cfg is not None:
        vocab_file = cfg.select("data.vocab_file")
    if not vocab_file:
        # the JAX package's candidates in its order: the user's HF cache,
        # then the data directory in root's home
        for cand in (
            os.path.expanduser("~/.cache/huggingface/bert-base-uncased/vocab.txt"),
            os.path.expanduser("~root/data/bert-base-uncased/vocab.txt"),
        ):
            if os.path.isfile(cand):
                vocab_file = cand
                break
    key = vocab_file or "__hash__"
    if key not in _CACHED:
        _CACHED[key] = WordPieceTokenizer(vocab_file)
    return _CACHED[key]
