"""Tokenization SPI.

Analog of the reference's text/tokenization/ (TokenizerFactory SPI,
DefaultTokenizerFactory, NGramTokenizerFactory, CommonPreprocessor —
deeplearning4j-nlp/.../text/tokenization/tokenizerfactory/). Language
plugins ride the same SPI: CJKTokenizerFactory below (dictionary-free
char-class runs + bigrams) and the Japanese lattice segmenter in
nlp/japanese.py (the deeplearning4j-nlp-japanese slot); see README "CJK
tokenization" for the scope rationale.
"""

from __future__ import annotations

import re
from typing import List, Optional

# single source of the CJK/word character classes: the run tokenizer and
# the Japanese lattice's per-char classifier must never drift apart
CJK_CHAR_RANGES = (
    ("han", "㐀-䶿一-鿿豈-﫿"),
    ("hiragana", "぀-ゟ"),
    ("katakana", "゠-ヿㇰ-ㇿ"),
    ("hangul", "가-힯ᄀ-ᇿ"),
    ("word", "A-Za-z0-9_"),
)


class TokenPreProcess:
    """Per-token normalization hook (reference: TokenPreProcess)."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits-preserving (reference:
    text/tokenization/tokenizer/preprocessor/CommonPreprocessor.java)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token).lower()


class Tokenizer:
    def __init__(self, tokens: List[str]):
        self._tokens = tokens

    def get_tokens(self) -> List[str]:
        return list(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)

    def __iter__(self):
        return iter(self._tokens)


class TokenizerFactory:
    """SPI: create(text) -> Tokenizer (reference: TokenizerFactory)."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess) -> "TokenizerFactory":
        self._pre = pre
        return self

    def _apply_pre(self, tokens: List[str]) -> List[str]:
        if self._pre is None:
            return tokens
        out = [self._pre.pre_process(t) for t in tokens]
        return [t for t in out if t]

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenization (reference: DefaultTokenizerFactory wraps
    Java's StreamTokenizer; whitespace split is the effective behavior)."""

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(self._apply_pre(text.split()))


class NGramTokenizerFactory(TokenizerFactory):
    """Emit all n-grams for n in [min_n, max_n] joined by spaces
    (reference: NGramTokenizerFactory)."""

    def __init__(self, min_n: int = 1, max_n: int = 1):
        super().__init__()
        self.min_n = int(min_n)
        self.max_n = int(max_n)

    def create(self, text: str) -> Tokenizer:
        base = self._apply_pre(text.split())
        out: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(base) - n + 1):
                out.append(" ".join(base[i : i + n]))
        return Tokenizer(out)


class CJKTokenizerFactory(TokenizerFactory):
    """Language plugin for unsegmented CJK text (reference:
    deeplearning4j-nlp-japanese bundles a Kuromoji fork, -korean a KOMORAN
    wrapper — 81 main files of bundled morphological analyzers; this
    framework ships a dictionary-free analyzer on the same SPI instead,
    and a full morphological analyzer plugs into the identical slot).

    Segmentation: text is split into runs by character class (han,
    hiragana, katakana, hangul, latin/digit words); han and hangul runs
    are additionally emitted as overlapping bigrams (the Lucene
    CJKAnalyzer strategy — robust retrieval/embedding units without a
    lexicon), kana runs and latin words as whole tokens.

    ``bigrams=False`` keeps whole runs (closer to word2vec preprocessing
    for pre-segmented corpora)."""

    _CLASSES = tuple(
        (name, re.compile(f"[{body}]+"))
        for name, body in CJK_CHAR_RANGES
    )

    def __init__(self, bigrams: bool = True):
        super().__init__()
        self.bigrams = bool(bigrams)

    def create(self, text: str) -> Tokenizer:
        spans: List[tuple] = []  # (start, kind, run)
        for kind, pat in self._CLASSES:
            for m in pat.finditer(text):
                spans.append((m.start(), kind, m.group()))
        spans.sort()
        out: List[str] = []
        for _, kind, run in spans:
            if (self.bigrams and kind in ("han", "hangul")
                    and len(run) > 1):
                out.extend(run[i:i + 2] for i in range(len(run) - 1))
            else:
                out.append(run)
        return Tokenizer(self._apply_pre(out))


class SentenceIterator:
    """Stream of sentences/documents (reference: text/sentenceiterator/).
    Any iterable of strings works; this wrapper adds reset()."""

    def __init__(self, sentences):
        self._sentences = list(sentences)

    def __iter__(self):
        return iter(self._sentences)

    def reset(self):
        pass


class LabelAwareSentenceIterator(SentenceIterator):
    """Sentences with document labels, for ParagraphVectors (reference:
    text/documentiterator/LabelAwareIterator)."""

    def __init__(self, sentences, labels):
        super().__init__(sentences)
        self.labels = list(labels)
        if len(self.labels) != len(self._sentences):
            raise ValueError("labels and sentences must align")

    def labeled(self):
        return zip(self._sentences, self.labels)
