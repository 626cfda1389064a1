"""GloVe word vectorizer + POS one-hots for the t2m pipeline (reference
`utils/word_vectorizer.py:5-79`; the port's own copy of
`conductor_tpu/t2m/word_vectorizer.py`, host numpy).  Gated on the GloVe
files existing: the assets (glove `*_data.npy` / `*_words.pkl` /
`*_idx.pkl`) ship with the HumanML3D datasets, not with the framework."""

from __future__ import annotations

import os
import pickle

import numpy as np

POS_ENUMERATOR = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4,
    "AUX": 5, "PRON": 6, "ADJ": 7, "ADV": 8,
    "Loc_VIP": 9, "Body_VIP": 10, "Obj_VIP": 11, "Act_VIP": 12,
    "Desc_VIP": 13, "OTHER": 14,
}

_VIP = {
    "Loc_VIP": (
        "left", "right", "clockwise", "counterclockwise", "anticlockwise",
        "forward", "back", "backward", "up", "down", "straight", "curve",
    ),
    "Body_VIP": (
        "arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg",
        "waist", "eye", "knee", "shoulder", "thigh",
    ),
    "Obj_VIP": (
        "stair", "dumbbell", "chair", "window", "floor", "car", "ball",
        "handrail", "baseball", "basketball",
    ),
    "Act_VIP": (
        "walk", "run", "swing", "pick", "bring", "kick", "put", "squat",
        "throw", "hop", "dance", "jump", "turn", "stumble", "stop", "sit",
        "lift", "lower", "raise", "wash", "stand", "kneel", "stroll", "rub",
        "bend", "balance", "flap", "jog", "shuffle", "lean", "rotate",
        "spin", "spread", "climb",
    ),
    "Desc_VIP": (
        "slowly", "carefully", "fast", "careful", "slow", "quickly",
        "happy", "angry", "sad", "happily", "angrily", "sadly",
    ),
}


def pos_one_hot(pos: str) -> np.ndarray:
    vec = np.zeros(len(POS_ENUMERATOR), dtype=np.float32)
    vec[POS_ENUMERATOR.get(pos, POS_ENUMERATOR["OTHER"])] = 1.0
    return vec


class WordVectorizer:
    """'word/POS' -> (glove vector, POS one-hot), with the VIP word-class
    overrides the t2m evaluators expect."""

    def __init__(self, meta_root: str, prefix: str):
        data = os.path.join(meta_root, f"{prefix}_data.npy")
        words_p = os.path.join(meta_root, f"{prefix}_words.pkl")
        idx_p = os.path.join(meta_root, f"{prefix}_idx.pkl")
        if not all(os.path.exists(p) for p in (data, words_p, idx_p)):
            raise FileNotFoundError(
                f"GloVe assets missing under {meta_root!r} (prefix {prefix!r}); "
                "they ship with the HumanML3D/KIT datasets"
            )
        vectors = np.load(data)
        with open(words_p, "rb") as f:
            words = pickle.load(f)
        with open(idx_p, "rb") as f:
            word2idx = pickle.load(f)
        self.word2vec = {w: vectors[word2idx[w]] for w in words}

    def __len__(self) -> int:
        return len(self.word2vec)

    def __getitem__(self, item: str) -> tuple[np.ndarray, np.ndarray]:
        word, pos = item.split("/")
        if word in self.word2vec:
            word_vec = self.word2vec[word]
            vip = next((k for k, v in _VIP.items() if word in v), None)
            pos_vec = pos_one_hot(vip if vip is not None else pos)
        else:
            word_vec = self.word2vec["unk"]
            pos_vec = pos_one_hot("OTHER")
        return word_vec, pos_vec
