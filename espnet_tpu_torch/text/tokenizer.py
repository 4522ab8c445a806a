"""Char tokenizer and token-id conversion (counterpart of
espnet_tpu/text/tokenizer.py, char tokens only)."""

from __future__ import annotations

from typing import Iterable, List


class CharTokenizer:
    """Space becomes ``<space>``; non-linguistic symbols stay whole."""

    def __init__(self, non_linguistic_symbols: Iterable[str] = (),
                 space_symbol: str = "<space>",
                 remove_non_linguistic_symbols: bool = False):
        self.space_symbol = space_symbol
        self.non_linguistic_symbols = set(non_linguistic_symbols)
        self.remove_non_linguistic_symbols = remove_non_linguistic_symbols

    def text2tokens(self, line: str) -> List[str]:
        tokens = []
        while line:
            for w in self.non_linguistic_symbols:
                if line.startswith(w):
                    if not self.remove_non_linguistic_symbols:
                        tokens.append(w)
                    line = line[len(w):]
                    break
            else:
                tokens.append(self.space_symbol if line[0] == " "
                              else line[0])
                line = line[1:]
        return tokens

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return "".join(" " if t == self.space_symbol else t for t in tokens)


def build_tokenizer(token_type: str, non_linguistic_symbols=()):
    if token_type != "char":
        raise NotImplementedError(
            f"token_type {token_type!r}: the port has char tokens only")
    return CharTokenizer(non_linguistic_symbols or ())


class TokenIDConverter:
    """Token list <-> ids; out-of-list tokens map to ``<unk>``."""

    def __init__(self, token_list: List[str], unk_symbol: str = "<unk>"):
        self.token_list = list(token_list)
        self.token2id = {t: i for i, t in enumerate(self.token_list)}
        if len(self.token2id) != len(self.token_list):
            raise RuntimeError("duplicated tokens in token_list")
        self.unk_symbol = unk_symbol

    def ids2tokens(self, ids) -> List[str]:
        return [self.token_list[int(i)] for i in ids]

    def tokens2ids(self, tokens: Iterable[str]) -> List[int]:
        unk = self.token2id.get(self.unk_symbol)
        out = []
        for t in tokens:
            if t in self.token2id:
                out.append(self.token2id[t])
            elif unk is not None:
                out.append(unk)
            else:
                raise RuntimeError(
                    f"OOV token {t!r} and no {self.unk_symbol}")
        return out
