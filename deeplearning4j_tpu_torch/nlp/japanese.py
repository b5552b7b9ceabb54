"""Minimal Japanese morphological segmenter — lattice + Viterbi.

Reference: deeplearning4j-nlp-japanese bundles a full Kuromoji fork (76
files: mmap'd dictionaries, trained connection-cost matrices, POS
tagging). This framework's scope is EMBEDDING-QUALITY segmentation — the
tokens feed word2vec/GloVe/TF-IDF, not a tagger — so it implements the
same *mechanism* (a segmentation lattice over a lexicon, cheapest path
by Viterbi, character-class unknown-word handling) at a bundled-lexicon
scale, pluggable through the identical TokenizerFactory SPI as
CJKTokenizerFactory (which remains the dictionary-free fallback for
arbitrary CJK text). See README "CJK tokenization" for the scope
rationale.

Model (a deliberately simplified Kuromoji/MeCab):
- lattice nodes = dictionary matches starting at each position (longest
  lexicon entry is `max_len` chars) + one unknown-word node per
  same-character-class run prefix
- node cost = per-entry lexicon cost (frequent particles/affixes cheap,
  content words mid, unknown runs expensive per char) — no connection
  matrix (that is the trained-model part of Kuromoji; unigram costs
  already recover dictionary words and particle boundaries)
- cheapest full segmentation by Viterbi over positions.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from deeplearning4j_tpu_torch.nlp.tokenization import (
    CJK_CHAR_RANGES,
    Tokenizer,
    TokenizerFactory,
)

# -- bundled mini-lexicon -----------------------------------------------------
# cost per entry: particles/copula bits ~1, verb/adjective inflections ~2,
# content words ~3 (beats unknown-run cost of 6/char so known words win,
# while unknown runs still beat absurd over-segmentation).

_PARTICLES = ["は", "が", "を", "に", "で", "と", "も", "の", "へ", "や",
              "から", "まで", "より", "ね", "よ", "か", "な", "わ", "ぞ",
              "こそ", "しか", "だけ", "ほど", "など", "って", "ば"]
_COPULA = ["です", "でした", "だ", "だった", "である", "ます", "ました",
           "ません", "ましょう", "たい", "ない", "なかった", "れる",
           "られる", "せる", "させる", "て", "た", "ている", "ていた",
           "う", "よう"]
_WORDS = [
    # pronouns / people
    "私", "僕", "君", "彼", "彼女", "あなた", "誰", "人", "皆", "友達",
    "先生", "学生", "子供", "家族", "男", "女",
    # time / place
    "今日", "明日", "昨日", "今", "時間", "年", "月", "日", "週", "朝",
    "夜", "午前", "午後", "東京", "日本", "京都", "大阪", "世界", "国",
    "家", "学校", "会社", "駅", "店", "道", "町", "部屋",
    # common nouns
    "猫", "犬", "水", "火", "山", "川", "海", "空", "雨", "雪", "花",
    "木", "本", "車", "電車", "電話", "映画", "音楽", "写真", "料理",
    "食べ物", "飲み物", "言葉", "名前", "仕事", "勉強", "問題", "質問",
    "答え", "お金", "気持ち", "心", "手", "目", "耳", "口", "足", "頭",
    # verbs (stems + common forms)
    "行き", "行く", "行った", "来る", "来た", "来ます", "見る", "見た",
    "見え", "食べ", "食べる", "食べた", "飲む", "飲んだ", "する", "した",
    "します", "言う", "言った", "思う", "思った", "書く", "書いた",
    "読む", "読んだ", "読んで", "飲んで", "聞く", "聞いた", "話す",
    "話した", "分かる",
    "分かった", "知る", "知って", "作る", "作った", "使う", "使った",
    "買う", "買った", "働く", "歩く", "走る", "泳ぐ", "遊ぶ", "住む",
    "住んで", "待つ", "持つ", "持って", "帰る", "帰った", "出る",
    "入る", "会う", "会った", "始まる", "終わる", "ある", "あった",
    "いる", "いた", "なる", "なった", "できる", "できた",
    # adjectives / adverbs
    "大きい", "小さい", "新しい", "古い", "高い", "安い", "良い", "悪い",
    "早い", "遅い", "近い", "遠い", "暑い", "寒い", "楽しい", "嬉しい",
    "悲しい", "難しい", "簡単", "綺麗", "静か", "元気", "大切", "大変",
    "好き", "嫌い", "上手", "下手",
    "とても", "少し", "たくさん", "もう", "まだ", "いつも", "時々",
    "一緒", "全部", "本当", "多分",
    # numbers / counters
    "一", "二", "三", "四", "五", "六", "七", "八", "九", "十", "百",
    "千", "万", "円", "時", "分", "歳", "個", "人",
]


def _default_lexicon() -> Dict[str, float]:
    lex: Dict[str, float] = {}
    for w in _WORDS:
        lex[w] = 3.0
    for w in _COPULA:
        lex[w] = 2.0
    for w in _PARTICLES:
        lex[w] = 1.0
    return lex


_CLASS_PATTERNS: List[Tuple[str, re.Pattern]] = [
    (name, re.compile(f"[{body}]")) for name, body in CJK_CHAR_RANGES
]


def _char_class(ch: str) -> str:
    for name, pat in _CLASS_PATTERNS:
        if pat.match(ch):
            return name
    return "other"


def segment(text: str, lexicon: Dict[str, float] = None,
            unknown_cost: float = 6.0) -> List[str]:
    """Cheapest segmentation of `text` (whitespace and punctuation are
    hard boundaries; each non-space span runs its own lattice)."""
    lex = lexicon if lexicon is not None else _DEFAULT_LEX
    max_len = max((len(w) for w in lex), default=1)
    out: List[str] = []
    for span in re.split(r"[\s、。,．.!?！？「」()（）]+", text):
        if span:
            out.extend(_segment_span(span, lex, max_len, unknown_cost))
    return out


def _segment_span(s: str, lex, max_len: int,
                  unknown_cost: float) -> List[str]:
    n = len(s)
    INF = float("inf")
    best = [INF] * (n + 1)
    back: List[Tuple[int, str]] = [(-1, "")] * (n + 1)
    best[0] = 0.0
    for i in range(n):
        if best[i] == INF:
            continue
        # dictionary edges
        for L in range(1, min(max_len, n - i) + 1):
            w = s[i:i + L]
            c = lex.get(w)
            if c is not None and best[i] + c < best[i + L]:
                best[i + L] = best[i] + c
                back[i + L] = (i, w)
        # unknown edges: every PREFIX of the same-class run from i. The
        # per-char cost decreases with length, so whole runs win (katakana
        # loanwords, unknown kanji compounds, latin words stay intact)
        # UNLESS splitting exposes a cheaper dictionary edge — which is
        # exactly how a particle after an out-of-lexicon word (of any
        # script) gets its boundary back
        cls = _char_class(s[i])
        j = i + 1
        while j < n and _char_class(s[j]) == cls:
            j += 1
        for L in range(1, j - i + 1):
            c = unknown_cost * (1.0 + 0.3 * (L - 1))
            if best[i] + c < best[i + L]:
                best[i + L] = best[i] + c
                back[i + L] = (i, s[i:i + L])
    toks: List[str] = []
    i = n
    while i > 0:
        prev, w = back[i]
        toks.append(w)
        i = prev
    toks.reverse()
    return toks


_DEFAULT_LEX = _default_lexicon()


class JapaneseTokenizerFactory(TokenizerFactory):
    """Lattice/Viterbi Japanese tokenizer on the TokenizerFactory SPI
    (the deeplearning4j-nlp-japanese slot). `lexicon` extends/overrides
    the bundled mini-lexicon ({word: cost}); unknown text falls back to
    character-class runs, so any input segments."""

    def __init__(self, lexicon: Dict[str, float] = None,
                 unknown_cost: float = 6.0):
        super().__init__()
        self.lexicon = dict(_DEFAULT_LEX)
        if lexicon:
            self.lexicon.update(lexicon)
        self.unknown_cost = float(unknown_cost)

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(self._apply_pre(
            segment(text, self.lexicon, self.unknown_cost)))
