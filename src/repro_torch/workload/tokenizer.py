"""Deterministic hashed word tokenizer (the LMaaS substrate's tokenizer).

Vocabulary-free: words map to ids via a stable hash into the model's vocab
range (specials reserved).  Round-trips are not needed by the serving stack
— only stable ids and exact token counts.

Word hashes are memoized: serving admission encodes every prompt on the
hot path, and LMaaS traffic re-uses a small working set of instruction /
input words (templates, retries), so a blake2b per word per admission was
measurable against a sub-10ms prefill wave (DESIGN.md §12)."""
from __future__ import annotations

import functools
import hashlib
from typing import List

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
N_SPECIAL = 3


@functools.lru_cache(maxsize=1 << 18)
def _word_id(word: str, vocab_size: int) -> int:
    h = hashlib.blake2b(word.encode(), digest_size=4).digest()
    return N_SPECIAL + int.from_bytes(h, "little") % (vocab_size - N_SPECIAL)


def encode(text: str, vocab_size: int = 32000, bos: bool = True) -> List[int]:
    ids = [BOS_ID] if bos else []
    ids += [_word_id(w, vocab_size) for w in text.split()]
    return ids


def token_count(text: str, bos: bool = True) -> int:
    return len(text.split()) + (1 if bos else 0)
