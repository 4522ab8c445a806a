"""Per-utterance preprocessing (counterpart of
espnet_tpu/data/preprocessor.py:CommonPreprocessor) as the ASR task uses
it: text -> token ids with the char tokenizer. BPE and text cleaners are
not ported and raise; nor are the JAX package's host-side augmentations
(noise, RIR, speed perturbation, effect bank), which its ASR task does
not turn on either."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from espnet_tpu_torch.text.tokenizer import TokenIDConverter, build_tokenizer


class CommonPreprocessor:
    def __init__(self,
                 token_type: str,
                 token_list,
                 bpemodel: Optional[str] = None,
                 text_cleaner=None,
                 unk_symbol: str = "<unk>",
                 non_linguistic_symbols: Iterable[str] = (),
                 text_name: str = "text"):
        if bpemodel is not None or text_cleaner is not None:
            raise NotImplementedError("bpemodel and text cleaners are not "
                                      "ported")
        self.text_name = text_name
        self.tokenizer = build_tokenizer(token_type, non_linguistic_symbols)
        self.token_id_converter = TokenIDConverter(token_list, unk_symbol)

    def __call__(self, uid: str, data: Dict) -> Dict[str, np.ndarray]:
        data = dict(data)
        text = data.get(self.text_name)
        if isinstance(text, str):
            ids = self.token_id_converter.tokens2ids(
                self.tokenizer.text2tokens(text))
            data[self.text_name] = np.asarray(ids, dtype=np.int32)
        return data
