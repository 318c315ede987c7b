"""SentencePiece-unigram tokenizer, pure Python: SD3's T5 text path.

The port's own copy of ``stablediffusion_tpu/tokenizer/sentencepiece_unigram.py``,
which imports nothing of JAX (numpy and the standard library only); the code
below is that module's, unchanged, so the two give the same ids on the same
files, and its save format with it (ROADMAP §3 lists the save format's open
faults under "Not queued").

Three layers, after the documented sentencepiece pipeline for T5's
`nmt_nfkc` normalizer spec:

  1. normalize: NFKC + NMT rules (controls stripped/spaced, zero-widths
     removed, unicode spaces -> " "), collapse repeated spaces, strip
     (remove_extra_whitespaces=True);
  2. pre-tokenize: add_dummy_prefix + escape_whitespaces — prepend one
     space and replace " " with "▁" (U+2581, the metaspace marker);
  3. segment: unigram-LM Viterbi over the (piece, log-prob score) vocab —
     max-total-score path, unknown characters at unk_score = min_score - 10
     with consecutive unknowns fused into ONE <unk> (sentencepiece / HF
     tokenizers `fuse_unk` behavior).

T5 conventions on top: pad=0 "<pad>", eos=1 "</s>", unk=2 "<unk>";
`extra_ids` sentinel tokens <extra_id_N> occupy the LAST ids in REVERSE
order (<extra_id_0> = vocab_size - 1); `</s>` appended to every encoding;
fixed-length padding to `max_length` (the SD3 pipeline contract).

Loads either serialization found in a diffusers checkpoint's tokenizer_3/:
  * `spiece.model` — the sentencepiece ModelProto, parsed with a minimal
    protobuf wire-format reader (no protobuf dependency);
  * `tokenizer.json` — the HF tokenizers Unigram JSON.
"""

from __future__ import annotations

import json
import os
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

METASPACE = "▁"  # ▁

# NMT normalization (sentencepiece builder "nmt" rules, approximated):
# these code points become a plain space ...
_NMT_TO_SPACE = {
    0x0009, 0x000A, 0x000C, 0x000D, 0x1680, 0x2028, 0x2029, 0x202F,
    0x205F, 0x3000, 0x00A0,
} | set(range(0x2000, 0x200B))
# ... and these are removed outright (controls, zero-widths, BOM, soft
# hyphen)
_NMT_REMOVE = (
    set(range(0x0000, 0x0009))
    | {0x000B}
    | set(range(0x000E, 0x0020))
    | {0x007F, 0x00AD, 0xFEFF, 0xFFFE}
    | set(range(0x200B, 0x2010))
    | set(range(0x0080, 0x00A0))
)


def nmt_nfkc_normalize(text: str) -> str:
    """T5's `nmt_nfkc` + remove_extra_whitespaces, without the precompiled
    charsmap: NMT char rules, NFKC, space collapse + strip."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp in _NMT_REMOVE:
            continue
        out.append(" " if cp in _NMT_TO_SPACE else ch)
    text = unicodedata.normalize("NFKC", "".join(out))
    # NFKC can surface more spaces (e.g. U+2000..200A fold to U+0020)
    text = " ".join(text.split())
    return text


def _parse_varint(buf: bytes, i: int) -> Tuple[int, int]:
    val = shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _skip_field(buf: bytes, i: int, wire: int) -> int:
    if wire == 0:  # varint
        _, i = _parse_varint(buf, i)
    elif wire == 1:  # 64-bit
        i += 8
    elif wire == 2:  # length-delimited
        n, i = _parse_varint(buf, i)
        i += n
    elif wire == 5:  # 32-bit
        i += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire}")
    return i


def parse_spiece_model(data: bytes) -> List[Tuple[str, float, int]]:
    """Minimal ModelProto reader -> [(piece, score, type)] in id order.

    ModelProto field 1 = repeated SentencePiece{piece=1:string,
    score=2:float, type=3:enum}; every other field is skipped by wire type.
    Piece types: 1 NORMAL, 2 UNKNOWN, 3 CONTROL, 4 USER_DEFINED, 5 UNUSED,
    6 BYTE."""
    pieces: List[Tuple[str, float, int]] = []
    i, n = 0, len(data)
    while i < n:
        tag, i = _parse_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            ln, i = _parse_varint(data, i)
            sub, end = data[i : i + ln], i + ln
            i = end
            piece, score, ptype = "", 0.0, 1
            j = 0
            while j < ln:
                t2, j = _parse_varint(sub, j)
                f2, w2 = t2 >> 3, t2 & 7
                if f2 == 1 and w2 == 2:
                    sl, j = _parse_varint(sub, j)
                    piece = sub[j : j + sl].decode("utf-8")
                    j += sl
                elif f2 == 2 and w2 == 5:
                    (score,) = struct.unpack("<f", sub[j : j + 4])
                    j += 4
                elif f2 == 3 and w2 == 0:
                    ptype, j = _parse_varint(sub, j)
                else:
                    j = _skip_field(sub, j, w2)
            pieces.append((piece, float(score), ptype))
        else:
            i = _skip_field(data, i, wire)
    return pieces


class SentencePieceUnigramTokenizer:
    """Unigram-LM tokenizer with the T5 encoding contract.

    `__call__(texts, max_length)` returns fixed-shape int32 ids (padded /
    truncated, eos-terminated) — drop-in for io/loader.T5TokenizerAdapter."""

    def __init__(
        self,
        vocab: Sequence[Tuple[str, float]],
        unk_id: int = 2,
        eos_id: int = 1,
        pad_id: int = 0,
        extra_ids: int = 100,
        control_ids: Optional[Sequence[int]] = None,
    ):
        self.pieces = [p for p, _ in vocab]
        self.scores = [float(s) for _, s in vocab]
        self.unk_id, self.eos_id, self.pad_id = unk_id, eos_id, pad_id
        self.extra_ids = extra_ids
        # sentinel tokens occupy the LAST ids in reverse (<extra_id_0> is
        # the highest id) — the documented T5 convention
        base = len(self.pieces)
        self.special_to_id: Dict[str, int] = {
            f"<extra_id_{k}>": base + extra_ids - 1 - k
            for k in range(extra_ids)
        }
        control = set(control_ids or (pad_id, eos_id))
        # kept for save_pretrained: control pieces must survive a
        # save/reload round-trip (advisor round-4 finding — they used to be
        # recovered only by the literal names '</s>'/'<pad>')
        self.control_ids = tuple(sorted(control))
        self.piece_to_id = {}
        for i, p in enumerate(self.pieces):
            # control pieces (<pad>, </s>) never match raw text; unknown
            # placeholder likewise
            if i in control or i == unk_id:
                continue
            self.piece_to_id.setdefault(p, i)
        self.vocab_size = base + extra_ids
        self._max_piece_len = max(
            (len(p) for p in self.piece_to_id), default=1
        )
        min_score = min(self.scores) if self.scores else 0.0
        self.unk_score = min_score - 10.0

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_spiece_model(cls, path: str, extra_ids: int = 100):
        with open(path, "rb") as f:
            pieces = parse_spiece_model(f.read())
        unk_id = next((i for i, p in enumerate(pieces) if p[2] == 2), 2)
        controls = [i for i, p in enumerate(pieces) if p[2] == 3]
        eos_id = next(
            (i for i in controls if pieces[i][0] == "</s>"),
            controls[-1] if controls else 1,
        )
        pad_id = next(
            (i for i in controls if pieces[i][0] == "<pad>"),
            controls[0] if controls else 0,
        )
        return cls(
            [(p, s) for p, s, _ in pieces],
            unk_id=unk_id, eos_id=eos_id, pad_id=pad_id,
            extra_ids=extra_ids, control_ids=controls,
        )

    @classmethod
    def from_tokenizer_json(cls, path: str):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        assert model.get("type") == "Unigram", model.get("type")
        vocab = [(p, float(s)) for p, s in model["vocab"]]
        unk_id = int(model.get("unk_id", 2))
        # T5 tokenizer.json lists the 100 sentinels as added_tokens at the
        # tail.  Depending on the writer they may ALSO appear inside
        # model.vocab (transformers' T5Converter appends them) — only
        # sentinels NOT already in the vocab extend the id space, otherwise
        # base = len(vocab) would double-count them and map <extra_id_0>
        # past the embedding table.
        added = [
            t
            for t in spec.get("added_tokens", [])
            if t.get("content", "").startswith("<extra_id_")
        ]
        in_vocab = {p for p, _ in vocab}
        n_sentinels_in_vocab = sum(
            1 for t in added if t["content"] in in_vocab
        )
        if n_sentinels_in_vocab:
            # strip them from the unigram vocab; they re-enter through the
            # sentinel map at the SAME tail ids (reverse order), keeping
            # token ids identical to transformers.  That only holds when
            # the sentinels sit at the EXACT vocab tail — stripping
            # mid-vocab entries would silently shift every later piece's id
            # against the embedding table, so reject such layouts loudly.
            sentinel_pos = [
                i for i, (p, _) in enumerate(vocab)
                if p.startswith("<extra_id_")
            ]
            tail = set(range(len(vocab) - len(sentinel_pos), len(vocab)))
            if set(sentinel_pos) != tail or len(sentinel_pos) != (
                n_sentinels_in_vocab
            ):
                raise ValueError(
                    "tokenizer.json layout not supported: <extra_id_*> "
                    "pieces must be absent from model.vocab or form its "
                    f"exact tail (found at positions {sentinel_pos[:5]}... "
                    f"of {len(vocab)})"
                )
            vocab = vocab[: len(vocab) - len(sentinel_pos)]
        # an explicitly-present added_tokens list is authoritative, even
        # when EMPTY: a tokenizer saved with extra_ids=0 must not reload
        # with 100 sentinels (the old `len(added) or 100` silently shifted
        # vocab_size by 100 — advisor round-4 finding)
        extra_ids = len(added) if "added_tokens" in spec else 100
        # exact round-trip metadata written by save_pretrained (ignored by
        # third-party HF `tokenizers` loads); fall back to the
        # transformers-compatible name-based recovery without it
        meta = spec.get("sdtpu", {})
        eos_id = meta.get("eos_id")
        if eos_id is None:
            eos_id = next(
                (i for i, (p, _) in enumerate(vocab) if p == "</s>"), 1
            )
        pad_id = meta.get("pad_id")
        if pad_id is None:
            pad_id = next(
                (i for i, (p, _) in enumerate(vocab) if p == "<pad>"), 0
            )
        return cls(
            vocab, unk_id=unk_id, eos_id=eos_id, pad_id=pad_id,
            extra_ids=extra_ids,
            control_ids=tuple(meta.get("control_ids", (pad_id, eos_id))),
        )

    @classmethod
    def from_pretrained(cls, path: str):
        spm = os.path.join(path, "spiece.model")
        if os.path.exists(spm):
            return cls.from_spiece_model(spm)
        tj = os.path.join(path, "tokenizer.json")
        if os.path.exists(tj):
            return cls.from_tokenizer_json(tj)
        raise FileNotFoundError(
            f"no spiece.model or tokenizer.json under {path}"
        )

    def save_pretrained(self, path: str) -> None:
        """Write ``tokenizer.json`` in the HF Unigram layout that
        ``from_tokenizer_json`` reads back (pieces+scores, ``unk_id``,
        sentinels as tail ``added_tokens``) — the inverse needed so
        ``save_sd3_model`` can emit a complete self-loading folder.

        Round-trip contract: an ``sdtpu`` metadata block records
        eos/pad/control ids EXACTLY, so ``from_tokenizer_json`` restores
        them for any vocabulary (including extra_ids=0 and non-standard
        control-piece names).  Third-party HF ``tokenizers`` loads ignore
        that block and recover eos/pad by piece NAME (``</s>``/``<pad>``) —
        a warning is emitted when that interchange path would differ.

        The normalizer/pre_tokenizer/decoder sections carry a standard
        NFKC + whitespace-collapse + Metaspace stack so third-party loads
        tokenize ~like this class does (real T5 tokenizer.json uses a
        Precompiled NMT-NFKC charsmap instead; the NMT char-removal rules
        are the only divergence — see ``nmt_nfkc_normalize``)."""
        import warnings

        os.makedirs(path, exist_ok=True)
        nonstandard = (
            (0 <= self.eos_id < len(self.pieces)
             and self.pieces[self.eos_id] != "</s>")
            or (0 <= self.pad_id < len(self.pieces)
                and self.pieces[self.pad_id] != "<pad>")
            or set(self.control_ids) - {self.pad_id, self.eos_id}
        )
        if nonstandard:
            warnings.warn(
                "save_pretrained: control pieces are not the standard "
                "'</s>'/'<pad>' pair; the folder round-trips exactly via "
                "from_tokenizer_json (sdtpu metadata) but third-party HF "
                "tokenizers loads would recover different eos/pad ids",
                stacklevel=2,
            )
        spec = {
            "version": "1.0",
            "normalizer": {
                "type": "Sequence",
                "normalizers": [
                    {"type": "NFKC"},
                    {"type": "Replace",
                     "pattern": {"Regex": " {2,}"}, "content": " "},
                    {"type": "Strip", "strip_left": True,
                     "strip_right": True},
                ],
            },
            "pre_tokenizer": {
                "type": "Metaspace",
                "replacement": METASPACE,
                "prepend_scheme": "always",
                "split": False,
            },
            "decoder": {
                "type": "Metaspace",
                "replacement": METASPACE,
                "prepend_scheme": "always",
                "split": False,
            },
            "model": {
                "type": "Unigram",
                "vocab": [
                    [p, s] for p, s in zip(self.pieces, self.scores)
                ],
                "unk_id": self.unk_id,
            },
            "added_tokens": [
                {"id": i, "content": tok, "special": True}
                for tok, i in sorted(
                    self.special_to_id.items(), key=lambda kv: kv[1]
                )
            ],
            "sdtpu": {
                "eos_id": self.eos_id,
                "pad_id": self.pad_id,
                "control_ids": list(self.control_ids),
            },
        }
        with open(
            os.path.join(path, "tokenizer.json"), "w", encoding="utf-8"
        ) as f:
            json.dump(spec, f, ensure_ascii=False)

    # -- segmentation --------------------------------------------------------
    def _viterbi(self, text: str) -> List[int]:
        """Max-total-score segmentation; unknown chars score unk_score and
        consecutive unknowns fuse into one unk token."""
        n = len(text)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        for end in range(1, n + 1):
            lo = max(0, end - self._max_piece_len)
            for start in range(lo, end):
                if best[start] == NEG:
                    continue
                pid = self.piece_to_id.get(text[start:end])
                if pid is None:
                    continue
                s = best[start] + self.scores[pid]
                if s > best[end]:
                    best[end], back[end] = s, (start, pid)
            # sentencepiece's lattice adds the single-char unknown node
            # whenever the character itself has no piece — as a CANDIDATE,
            # not only when nothing else ends here (mixed known/unknown
            # scripts otherwise segment differently from transformers).
            if text[end - 1:end] not in self.piece_to_id:
                start = end - 1
                if best[start] > NEG:
                    s = best[start] + self.unk_score
                    if s > best[end]:
                        best[end], back[end] = s, (start, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            ids.append(pid)
            pos = start
        ids.reverse()
        # fuse consecutive unknowns (sentencepiece / tokenizers fuse_unk)
        fused: List[int] = []
        for t in ids:
            if t == self.unk_id and fused and fused[-1] == self.unk_id:
                continue
            fused.append(t)
        return fused

    def tokenize_ids(self, text: str) -> List[int]:
        text = nmt_nfkc_normalize(text)
        # split out sentinel special tokens before metaspace escaping
        segments: List[Union[str, int]] = [text]
        for tok, tid in self.special_to_id.items():
            if tok not in text:
                continue
            new: List[Union[str, int]] = []
            for seg in segments:
                if not isinstance(seg, str):
                    new.append(seg)
                    continue
                parts = seg.split(tok)
                for k, part in enumerate(parts):
                    if k:
                        new.append(tid)
                    if part:
                        new.append(part)
            segments = new
        ids: List[int] = []
        for seg in segments:
            if isinstance(seg, int):
                ids.append(seg)
                continue
            piece_text = METASPACE + seg.strip().replace(" ", METASPACE)
            if piece_text != METASPACE:
                ids.extend(self._viterbi(piece_text))
        return ids

    def tokenize(self, text: str) -> List[str]:
        return [self.id_to_piece(i) for i in self.tokenize_ids(text)]

    def id_to_piece(self, i: int) -> str:
        if i < len(self.pieces):
            return self.pieces[i]
        return f"<extra_id_{self.vocab_size - 1 - i}>"

    def encode(self, text: str, add_eos: bool = True) -> List[int]:
        ids = self.tokenize_ids(text)
        return ids + [self.eos_id] if add_eos else ids

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i in (self.pad_id, self.eos_id):
                continue
            out.append(self.id_to_piece(i))
        return "".join(out).replace(METASPACE, " ").strip()

    # -- the SD3 pipeline contract (fixed-length int32 batch) ----------------
    def __call__(self, texts, max_length: int = 256) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        rows = []
        for t in texts:
            ids = self.encode(t)[:max_length]
            # truncation must keep the eos terminator (transformers parity)
            if len(ids) == max_length and ids[-1] != self.eos_id:
                ids[-1] = self.eos_id
            rows.append(ids + [self.pad_id] * (max_length - len(ids)))
        return np.asarray(rows, np.int32)
