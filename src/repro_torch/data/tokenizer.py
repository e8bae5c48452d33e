"""Port of ``repro.data.tokenizer``: the character-level SMILES tokenizer.

Used by the sequence-model examples (a SMILES LM as a property-predictor
backbone) and by the data pipeline.  The model-zoo configs keep their
source-paper vocab sizes for the dry-run; this tokenizer covers the actual
chem corpus and maps into the low end of any such vocab.
"""

from __future__ import annotations

import numpy as np

_FIXED = ["<pad>", "<bos>", "<eos>", "<unk>"]
_CHARS = list("CNO=#().%0123456789")


class SmilesTokenizer:
    PAD, BOS, EOS, UNK = 0, 1, 2, 3

    def __init__(self):
        self.vocab = _FIXED + _CHARS
        self.index = {t: i for i, t in enumerate(self.vocab)}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, smiles: str, *, max_len: int | None = None, add_special: bool = True) -> np.ndarray:
        ids = [self.index.get(c, self.UNK) for c in smiles]
        if add_special:
            ids = [self.BOS] + ids + [self.EOS]
        if max_len is not None:
            ids = ids[:max_len]
            ids = ids + [self.PAD] * (max_len - len(ids))
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: np.ndarray) -> str:
        out = []
        for i in np.asarray(ids).tolist():
            if i == self.EOS:
                break
            if i in (self.PAD, self.BOS):
                continue
            out.append(self.vocab[i] if 0 <= i < len(self.vocab) else "?")
        return "".join(out)
