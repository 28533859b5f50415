"""Tokenizers for the GPT-2/PersonaChat path.

Pure-Python copy of ``commefficient_tpu/data/tokenizer.py`` (the port
imports nothing of the JAX package): ``GPT2BPETokenizer`` (GPT-2's
byte-level BPE from ``vocab.json`` + ``merges.txt`` on disk),
``ByteTokenizer`` (byte values as ids, the offline fallback),
``fabricate_bpe_vocab`` (a full-size GPT-2-layout vocabulary written
offline) and ``load_tokenizer``. Same ids for the same text, same
files for the same seed.

Both tokenizers expose the reference's special-token protocol:
SPECIAL_TOKENS = <bos>, <eos>, <speaker1>, <speaker2>, <pad>.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List

SPECIAL_TOKENS = ["<bos>", "<eos>", "<speaker1>", "<speaker2>", "<pad>"]


def _read_special(save_dir: str) -> Dict[str, int]:
    path = os.path.join(save_dir, "special_tokens.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {k: int(v) for k, v in json.load(f).items()}


def _write_special(save_dir: str, special: Dict[str, int]) -> None:
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "special_tokens.json"), "w") as f:
        json.dump(special, f)


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class GPT2BPETokenizer:
    """Byte-level BPE (GPT-2). Load with
    ``GPT2BPETokenizer(dir_with_vocab_json_and_merges_txt)``."""

    def __init__(self, vocab_dir: str):
        with open(os.path.join(vocab_dir, "vocab.json")) as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(vocab_dir, "merges.txt"),
                  encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges
                  if m and not m.startswith("#version")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.cache: Dict[str, str] = {}
        self.special: Dict[str, int] = _read_special(vocab_dir)

    def __len__(self):
        return len(self.encoder) + len(self.special)

    def add_special_tokens(self, tokens: List[str]) -> int:
        """Returns number added (reference add_special_tokens_,
        gpt2_train.py:101-112)."""
        added = 0
        for t in tokens:
            if t not in self.special and t not in self.encoder:
                self.special[t] = len(self.encoder) + len(self.special)
                added += 1
        return added

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            tokens = [tokens]
        out = []
        for t in tokens:
            if t in self.special:
                out.append(self.special[t])
            else:
                out.append(self.encoder.get(t, 0))
        return out

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = _get_pairs(word) if len(word) > 1 else set()
        while pairs:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, 1e10))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _split_words(self, text: str) -> List[str]:
        """GPT-2's regex split, approximated without the `regex`
        module: contractions, letter runs, digit runs, symbol runs,
        with leading-space attachment."""
        import re
        pat = (r"'s|'t|'re|'ve|'m|'ll|'d"
               r"| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+")
        return re.findall(pat, text)

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in self._split_words(text):
            word = "".join(self.byte_encoder[b]
                           for b in word.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(word).split(" ")
                       if t in self.encoder)
        return ids

    def decode(self, ids) -> str:
        toks = []
        inv_special = {v: k for k, v in self.special.items()}
        for i in ids:
            i = int(i)
            if i in inv_special:
                toks.append(inv_special[i])
            else:
                toks.append(self.decoder.get(i, ""))
        text = "".join(toks)
        return bytearray(
            self.byte_decoder.get(ch, 32) for ch in text
        ).decode("utf-8", errors="replace")

    def save_pretrained(self, save_dir: str):
        """Write vocab.json / merges.txt / special_tokens.json so the
        saved run directory is self-contained (the reference saves its
        tokenizer to the logdir, gpt2_train.py:278-283)."""
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "vocab.json"), "w") as f:
            json.dump(self.encoder, f)
        merges = sorted(self.bpe_ranks, key=self.bpe_ranks.get)
        with open(os.path.join(save_dir, "merges.txt"), "w",
                  encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            # trailing newline: HF loaders split("\n")[1:-1] and would
            # otherwise drop the last merge
            f.write("\n".join(" ".join(m) for m in merges) + "\n")
        _write_special(save_dir, self.special)


def fabricate_bpe_vocab(save_dir: str, vocab_size: int = 50257,
                        num_words: int = 8000, seed: int = 0):
    """Write a full-size GPT-2-layout ``vocab.json``/``merges.txt``
    whose *geometry* matches the real GPT-2 vocabulary (default
    50257 entries — the reference fine-tunes this exact shape,
    gpt2_train.py:262-285) without needing the real files (offline
    use). Returns the list of ``num_words`` synthetic words,
    each of which encodes to exactly ONE token through
    :class:`GPT2BPETokenizer`, both bare and with a leading space.

    Construction: words are two consonant-vowel syllables
    ("bade", "kilu", ...). Merges are layered so greedy BPE resolves
    deterministically: char-pair -> syllable, syllable-pair -> word,
    "Ġ"+word -> spaced word. Ids are shuffled so the reachable tokens
    spread across the whole [0, vocab_size) range (embedding/softmax
    rows are exercised across the full table, not a dense prefix).
    Remaining ids are filler entries, unreachable by the merge rules —
    the real vocabulary likewise has ids rare text never produces.
    """
    rng = __import__("random").Random(seed)
    consonants = "bcdfghjklmnprstvwz"
    vowels = "aeiou"
    syllables = [c + v for c in consonants for v in vowels]  # 90
    if num_words > len(syllables) ** 2:
        raise ValueError("num_words exceeds 2-syllable combinations")
    pairs = [(a, b) for a in syllables for b in syllables]
    rng.shuffle(pairs)
    words = [a + b for a, b in pairs[:num_words]]

    byte_tokens = list(_bytes_to_unicode().values())  # 256
    tokens = list(byte_tokens) + list(syllables)
    merges = [(s[0], s[1]) for s in syllables]
    for a, b in pairs[:num_words]:
        merges.append((a, b))
        tokens.append(a + b)
    for w in words:
        merges.append(("Ġ", w))
        tokens.append("Ġ" + w)
    n_filler = vocab_size - len(tokens)
    if n_filler < 0:
        raise ValueError(f"vocab_size {vocab_size} < {len(tokens)} "
                         "constructed tokens")
    tokens.extend(f"<unused{i}>" for i in range(n_filler))

    ids = list(range(vocab_size))
    rng.shuffle(ids)
    encoder = {t: i for t, i in zip(tokens, ids)}

    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "vocab.json"), "w") as f:
        json.dump(encoder, f)
    with open(os.path.join(save_dir, "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.write("\n".join(" ".join(m) for m in merges) + "\n")
    return words


class ByteTokenizer:
    """Offline fallback with the same interface: ids = byte values."""

    def __init__(self):
        self.special: Dict[str, int] = {}

    def __len__(self):
        return 256 + len(self.special)

    def add_special_tokens(self, tokens: List[str]) -> int:
        added = 0
        for t in tokens:
            if t not in self.special:
                self.special[t] = 256 + len(self.special)
                added += 1
        return added

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            tokens = [tokens]
        return [self.special.get(t, ord(t[0]) % 256) for t in tokens]

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self.special.items()}
        out = []
        buf = []
        for i in ids:
            i = int(i)
            if i in inv:
                if buf:
                    out.append(bytes(buf).decode("utf-8", "replace"))
                    buf = []
                out.append(inv[i])
            elif i < 256:
                buf.append(i)
        if buf:
            out.append(bytes(buf).decode("utf-8", "replace"))
        return "".join(out)

    def save_pretrained(self, save_dir: str):
        _write_special(save_dir, self.special)


def load_tokenizer(model_checkpoint: str):
    """GPT-2 BPE if vocab files exist at the checkpoint path, else the
    byte fallback (restoring saved special-token ids if present)."""
    if (os.path.isdir(model_checkpoint)
            and os.path.exists(os.path.join(model_checkpoint,
                                            "vocab.json"))):
        return GPT2BPETokenizer(model_checkpoint)
    tok = ByteTokenizer()
    if os.path.isdir(model_checkpoint):
        tok.special = _read_special(model_checkpoint)
    return tok
