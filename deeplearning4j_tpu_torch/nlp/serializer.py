"""WordVectorSerializer — embeddings interop.

Analog of the reference's models/embeddings/loader/WordVectorSerializer
.java (2,820 LoC): the Google word2vec binary and text formats (the
industry interchange formats, reference loadGoogleModel :112-154), plus a
full-model zip that round-trips vocab counts and the HS/negative output
tables so training can resume. The files are the JAX package's, byte
for byte in layout: a file written by either package loads in the other.
Readers put the model's tables on `device` (None: "cuda").
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable, as_table
from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors,
    VectorsConfiguration,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class WordVectorSerializer:
    # -- Google text format --------------------------------------------------

    @staticmethod
    def write_word_vectors(model: SequenceVectors, path: str):
        """word2vec text format: one `word v1 v2 ...` line per word."""
        vecs = model.lookup.vectors()
        with open(path, "w", encoding="utf-8") as f:
            for i, word in enumerate(model.vocab.words()):
                vals = " ".join(f"{x:.6f}" for x in vecs[i])
                f.write(f"{word} {vals}\n")

    @staticmethod
    def read_word_vectors(path: str, device=None) -> SequenceVectors:
        words, rows = [], []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                rows.append(np.asarray([float(x) for x in parts[1:]], np.float32))
        return WordVectorSerializer._from_vectors(words, np.stack(rows), device)

    # -- Google binary format ------------------------------------------------

    @staticmethod
    def write_google_binary(model: SequenceVectors, path: str):
        """Google word2vec .bin: header `V D\\n`, then per word
        `word<space>` + D little-endian f32 (reference: loadGoogleModel
        reads exactly this layout)."""
        vecs = model.lookup.vectors()
        V, D = vecs.shape
        with open(path, "wb") as f:
            f.write(f"{V} {D}\n".encode("utf-8"))
            for i, word in enumerate(model.vocab.words()):
                f.write(word.encode("utf-8") + b" ")
                f.write(vecs[i].astype("<f4").tobytes())
                f.write(b"\n")

    @staticmethod
    def read_google_binary(path: str, device=None) -> SequenceVectors:
        with open(path, "rb") as f:
            header = f.readline().decode("utf-8").strip().split()
            V, D = int(header[0]), int(header[1])
            words, rows = [], []
            for _ in range(V):
                chars = bytearray()
                while True:
                    ch = f.read(1)
                    if ch == b" " or ch == b"":
                        break
                    if ch != b"\n":
                        chars.extend(ch)
                words.append(chars.decode("utf-8"))
                rows.append(
                    np.frombuffer(f.read(4 * D), dtype="<f4").copy()
                )
                # optional trailing newline
                pos = f.tell()
                nxt = f.read(1)
                if nxt != b"\n":
                    f.seek(pos)
        return WordVectorSerializer._from_vectors(words, np.stack(rows), device)

    # -- full-model zip ------------------------------------------------------

    @staticmethod
    def write_full_model(model: SequenceVectors, path: str):
        """Zip: config.json + vocab.json + tables.npz (syn0/syn1/syn1neg)
        — the resume-training form (reference: writeFullModel)."""
        conf = model.conf
        vocab_entries = [
            {"word": w.word, "count": w.count}
            for w in model.vocab.vocab_words()
        ]
        arrays = {"syn0": model.lookup.vectors()}
        if model.lookup.syn1 is not None:
            arrays["syn1"] = model.lookup.syn1.cpu().numpy()
        if model.lookup.syn1neg is not None:
            arrays["syn1neg"] = model.lookup.syn1neg.cpu().numpy()
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("config.json", json.dumps(dataclass_dict(conf)))
            zf.writestr("vocab.json", json.dumps(vocab_entries))
            zf.writestr("tables.npz", buf.getvalue())

    @staticmethod
    def read_full_model(path: str, device=None) -> SequenceVectors:
        with zipfile.ZipFile(path, "r") as zf:
            conf = VectorsConfiguration(**json.loads(zf.read("config.json")))
            vocab_entries = json.loads(zf.read("vocab.json"))
            with np.load(io.BytesIO(zf.read("tables.npz"))) as npz:
                arrays = {k: npz[k] for k in npz.files}
        vocab = VocabCache()
        for e in vocab_entries:
            vocab.add(e["word"], e["count"])
        model = SequenceVectors(conf, vocab=vocab, device=device)
        model.build_vocab()
        model.lookup.syn0 = as_table(arrays["syn0"], model.device)
        if "syn1" in arrays and model.lookup.syn1 is not None:
            model.lookup.syn1 = as_table(arrays["syn1"], model.device)
        if "syn1neg" in arrays and model.lookup.syn1neg is not None:
            model.lookup.syn1neg = as_table(arrays["syn1neg"], model.device)
        return model

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _from_vectors(words, vectors: np.ndarray, device=None) -> SequenceVectors:
        """Vectors-only model (inference/query use — reference:
        loadStaticModel)."""
        vocab = VocabCache()
        for w in words:
            vocab.add(w, 1)
        conf = VectorsConfiguration(
            layer_size=int(vectors.shape[1]), min_word_frequency=1,
            use_hierarchic_softmax=False, negative=0,
        )
        model = SequenceVectors(conf, vocab=vocab, device=device)
        model.lookup = InMemoryLookupTable(
            vocab, conf.layer_size, use_hs=False, negative=0, device=model.device,
        )
        model.lookup.set_vectors(vectors)
        return model


def dataclass_dict(conf: VectorsConfiguration) -> dict:
    import dataclasses

    return dataclasses.asdict(conf)
