"""CLIP BPE tokenizer.

Port of ``stablediffusion_tpu/tokenizer/clip_bpe.py`` (``CLIPTokenizer``
:135, its merge loops and text cleaning).  Word BPE over UTF-8 bytes
through the reversible byte table, the ``</w>`` end-of-word marker,
vocab.json + merges.txt files (read and written), bos/eos wrapping,
truncation and right padding, and textual-inversion triggers (``add_tokens``
:235, ``clear_added_tokens``, the boundary-aware split of ``tokenize``
:269-290).  Each word goes through the native C++ merge loop
(``tokenizer/bpe_native.py`` over ``csrc/bpe.cpp``) when that builds and
every symbol of the word is in the vocabulary, else through the
pure-Python loop, as in JAX (:159-167, :300-308); the native table is built
at the first word, not at construction.  :data:`TOKENIZE_PATHS` counts the
words each path took.
"""

from __future__ import annotations

import html
import json
import os
import re as _std_re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import regex as re
except ImportError:  # pragma: no cover
    import re  # type: ignore

_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)
_WHITESPACE = re.compile(r"\s+")

try:  # optional mojibake repair, as CLIP's basic_clean uses
    import ftfy
except ImportError:  # pragma: no cover
    ftfy = None

# windows-1252's 0x80-0x9F graphics; the unmapped bytes fall back to the C1
# controls, like ftfy's sloppy-windows-1252
_C1_TO_CP1252 = {
    0x20AC: 0x80, 0x201A: 0x82, 0x0192: 0x83, 0x201E: 0x84, 0x2026: 0x85,
    0x2020: 0x86, 0x2021: 0x87, 0x02C6: 0x88, 0x2030: 0x89, 0x0160: 0x8A,
    0x2039: 0x8B, 0x0152: 0x8C, 0x017D: 0x8E, 0x2018: 0x91, 0x2019: 0x92,
    0x201C: 0x93, 0x201D: 0x94, 0x2022: 0x95, 0x2013: 0x96, 0x2014: 0x97,
    0x02DC: 0x98, 0x2122: 0x99, 0x0161: 0x9A, 0x203A: 0x9B, 0x0153: 0x9C,
    0x017E: 0x9E, 0x0178: 0x9F,
}


def _sloppy_cp1252_bytes(text: str) -> Optional[bytes]:
    out = bytearray()
    for ch in text:
        cp = ord(ch)
        if cp <= 0xFF:
            out.append(cp)
        elif cp in _C1_TO_CP1252:
            out.append(_C1_TO_CP1252[cp])
        else:
            return None
    return bytes(out)


def _fix_segment(seg: str) -> str:
    raw = _sloppy_cp1252_bytes(seg)
    if raw is None or raw.isascii():
        return seg
    try:
        return raw.decode("utf-8")  # strict: invalid sequences -> no repair
    except UnicodeDecodeError:
        return seg


def fix_mojibake(text: str) -> str:
    """ftfy.fix_text-equivalent repair of UTF-8 text mis-decoded as
    windows-1252, plus NFC normalisation."""
    for _ in range(3):
        if any(ord(c) > 0x7F for c in text):
            fixed = " ".join(_fix_segment(s) for s in text.split(" "))
        else:
            fixed = text
        if fixed == text:
            break
        text = fixed
    return unicodedata.normalize("NFC", text)


def _clean(text: str) -> str:
    text = ftfy.fix_text(text) if ftfy is not None else fix_mojibake(text)
    text = html.unescape(html.unescape(text))
    return _WHITESPACE.sub(" ", text).strip()


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable-unicode table."""
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


# words tokenized by each merge loop, over every tokenizer of the process
TOKENIZE_PATHS = {"native": 0, "python": 0}


class CLIPTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        pad_token_id: Optional[int] = None,
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
        model_max_length: int = 77,
    ):
        self.vocab = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.bos_token_id = vocab[bos_token]
        self.eos_token_id = vocab[eos_token]
        self.pad_token_id = self.eos_token_id if pad_token_id is None else pad_token_id
        self.model_max_length = model_max_length
        self.byte_encoder = _bytes_to_unicode()
        self._cache: Dict[str, List[str]] = {}
        # textual-inversion triggers: lowercased whole-string match -> the
        # embedding-table ids it emits in place of BPE (one or more rows)
        self.added_tokens: Dict[str, List[int]] = {}
        self._merges = merges
        self._native = None  # built at the first word; False: unavailable

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw) -> "CLIPTokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f.read().split("\n"):
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "CLIPTokenizer":
        """Load from a diffusers-layout tokenizer folder."""
        special_path = os.path.join(path, "special_tokens_map.json")
        pad_token_id = kw.pop("pad_token_id", None)
        if pad_token_id is None and os.path.exists(special_path):
            with open(special_path, encoding="utf-8") as f:
                pad = json.load(f).get("pad_token")
            if isinstance(pad, dict):
                pad = pad.get("content")
            if pad == "!":
                pad_token_id = 0
        return cls.from_files(
            os.path.join(path, "vocab.json"),
            os.path.join(path, "merges.txt"),
            pad_token_id=pad_token_id,
            **kw,
        )

    def save_pretrained(self, path: str) -> None:
        """Write a diffusers-layout tokenizer folder (the inverse of
        ``from_pretrained``): vocab.json, merges.txt and
        special_tokens_map.json."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        merges = sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in merges:
                f.write(f"{a} {b}\n")
        decoder = {i: t for t, i in self.vocab.items()}
        special = {
            "bos_token": decoder[self.bos_token_id],
            "eos_token": decoder[self.eos_token_id],
        }
        if self.pad_token_id != self.eos_token_id:
            special["pad_token"] = decoder.get(self.pad_token_id, "!")
        with open(os.path.join(path, "special_tokens_map.json"), "w",
                  encoding="utf-8") as f:
            json.dump(special, f, ensure_ascii=False)

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self._cache[token] = out
        return out

    def add_tokens(self, mapping: Dict[str, List[int]]) -> None:
        """Register textual-inversion triggers: whole-string matches that
        emit pre-assigned embedding ids instead of going through BPE."""
        self.added_tokens.update({k.lower(): [int(i) for i in v] for k, v in mapping.items()})

    def clear_added_tokens(self) -> None:
        self.added_tokens.clear()

    def tokenize(self, text: str) -> List[int]:
        text = _clean(text).lower()
        parts = [text]
        if self.added_tokens:
            # word-ish boundaries, longest trigger first: "thing" does not
            # fire inside "something"
            alts = "|".join(f"(?<![a-z0-9]){_std_re.escape(t)}(?![a-z0-9])"
                            for t in sorted(self.added_tokens, key=len, reverse=True))
            parts = _std_re.split(f"({alts})", text)
        unk = self.vocab.get("<|endoftext|>")
        ids: List[int] = []
        for part in parts:
            if part in self.added_tokens:
                ids.extend(self.added_tokens[part])
                continue
            for tok in _PATTERN.findall(part):
                tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                native_ids = self._tokenize_native(tok)
                if native_ids is not None:
                    TOKENIZE_PATHS["native"] += 1
                    ids.extend(native_ids)
                else:
                    TOKENIZE_PATHS["python"] += 1
                    ids.extend(self.vocab.get(piece, unk) for piece in self._bpe(tok))
        return ids

    def _tokenize_native(self, tok: str) -> Optional[List[int]]:
        """The word's ids from the native loop, or None (no library, or a
        symbol outside the vocabulary: the Python loop maps it to unk)."""
        if self._native is None:
            self._native = False
            try:
                from stablediffusion_tpu_torch.tokenizer.bpe_native import NativeBPE, available

                if available():
                    self._native = NativeBPE(self.vocab, self._merges)
            except Exception:  # a merge whose result is not in the vocab
                self._native = False
        if self._native is False:
            return None
        try:
            syms = [self.vocab[c] for c in tok[:-1]]
            syms.append(self.vocab[tok[-1] + "</w>"])
        except KeyError:
            return None
        return self._native.encode_word(syms)

    def __call__(
        self,
        texts: Sequence[str] | str,
        max_length: Optional[int] = None,
        padding: str = "max_length",
        truncation: bool = True,
    ) -> np.ndarray:
        """Batch encode to int32 [B, max_length]: pad to max and truncate."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        rows = []
        for t in texts:
            ids = self.tokenize(t)
            if truncation and len(ids) > max_length - 2:
                ids = ids[: max_length - 2]
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            if padding == "max_length" and len(row) < max_length:
                row = row + [self.pad_token_id] * (max_length - len(row))
            rows.append(row)
        return np.asarray(rows, dtype=np.int32)
