"""Text2Motion dataset for the legacy t2m/kit path (reference
`datasets/dataset.py:239-392`; the port's own copy of
`conductor_tpu/t2m/dataset.py`, host numpy, so one seed yields the same
items in both packages).

Loads `{motion_dir}/{id}.npy` RIC feature files plus `{text_dir}/{id}.txt`
annotation files (`caption#tokens#f_tag#to_tag` lines with time-cropped
sub-clips), z-normalizes with dataset mean/std, and yields fixed-vocabulary
token windows for the evaluator.  Deterministic: sub-clip naming and window
sampling use a seeded Generator instead of global `random` state.
"""

from __future__ import annotations

import os
import string

import numpy as np

from .word_vectorizer import WordVectorizer


class Text2MotionDataset:
    """Minimal contract of the torch original: `__len__`,
    `__getitem__(i) -> (word_embs, pos_onehots, caption, sent_len, motion,
    m_length, tokens)` in eval mode, or `(caption, motion, m_length)` without
    a vectorizer."""

    def __init__(
        self,
        motion_dir: str,
        text_dir: str,
        split_file: str,
        mean: np.ndarray,
        std: np.ndarray,
        *,
        dataset_name: str = "t2m",
        max_motion_length: int = 196,
        max_text_len: int = 20,
        unit_length: int = 4,
        w_vectorizer: WordVectorizer | None = None,
        times: int = 1,
        seed: int = 0,
    ):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.max_motion_length = max_motion_length
        self.max_text_len = max_text_len
        self.unit_length = unit_length
        self.w_vectorizer = w_vectorizer
        self.times = times
        self.rng = np.random.default_rng(seed)
        min_len = 40 if dataset_name == "t2m" else 24

        with open(split_file) as f:
            id_list = [line.strip() for line in f if line.strip()]

        self.data: dict[str, dict] = {}
        names: list[str] = []
        for name in id_list:
            path = os.path.join(motion_dir, name + ".npy")
            text_path = os.path.join(text_dir, name + ".txt")
            if not (os.path.exists(path) and os.path.exists(text_path)):
                continue
            motion = np.load(path)
            if len(motion) < min_len or len(motion) >= 200:
                continue
            whole_texts = []
            with open(text_path) as f:
                for line in f:
                    parts = line.strip().split("#")
                    if len(parts) < 4:
                        continue
                    caption, token_str, f_tag, to_tag = parts[:4]
                    f_tag = 0.0 if not f_tag or f_tag == "nan" else float(f_tag)
                    to_tag = 0.0 if not to_tag or to_tag == "nan" else float(to_tag)
                    entry = {"caption": caption, "tokens": token_str.split(" ")}
                    if f_tag == 0.0 and to_tag == 0.0:
                        whole_texts.append(entry)
                    else:
                        sub = motion[int(f_tag * 20) : int(to_tag * 20)]
                        if len(sub) < min_len or len(sub) >= 200:
                            continue
                        sub_name = (
                            self.rng.choice(list(string.ascii_uppercase)) + "_" + name
                        )
                        while sub_name in self.data:
                            sub_name = (
                                self.rng.choice(list(string.ascii_uppercase))
                                + "_" + name
                            )
                        self.data[sub_name] = {
                            "motion": sub, "length": len(sub), "text": [entry],
                        }
                        names.append(sub_name)
            if whole_texts:
                self.data[name] = {
                    "motion": motion, "length": len(motion), "text": whole_texts,
                }
                names.append(name)

        self.name_list = sorted(names, key=lambda n: self.data[n]["length"])

    def __len__(self) -> int:
        return len(self.name_list) * self.times

    def inv_transform(self, data: np.ndarray) -> np.ndarray:
        return data * self.std + self.mean

    def __getitem__(self, idx: int):
        item = self.data[self.name_list[idx % len(self.name_list)]]
        motion, m_length = item["motion"], item["length"]
        text = item["text"][self.rng.integers(len(item["text"]))]
        caption = text["caption"]

        # crop to a unit-aligned random window (`dataset.py:340-360`)
        m_length = (m_length // self.unit_length) * self.unit_length
        start = self.rng.integers(0, len(motion) - m_length + 1)
        motion = motion[start : start + m_length]
        motion = (motion - self.mean) / self.std
        if m_length < self.max_motion_length:
            motion = np.concatenate(
                [
                    motion,
                    np.zeros(
                        (self.max_motion_length - m_length, motion.shape[1]),
                        motion.dtype,
                    ),
                ]
            )

        if self.w_vectorizer is None:
            return caption, motion.astype(np.float32), m_length

        tokens = list(text["tokens"])
        if len(tokens) < self.max_text_len:
            tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
            sent_len = len(tokens)
            tokens += ["unk/OTHER"] * (self.max_text_len + 2 - sent_len)
        else:
            tokens = (
                ["sos/OTHER"] + tokens[: self.max_text_len] + ["eos/OTHER"]
            )
            sent_len = len(tokens)
        embs, pos_ohs = zip(*(self.w_vectorizer[t] for t in tokens))
        return (
            np.stack(embs).astype(np.float32),
            np.stack(pos_ohs).astype(np.float32),
            caption,
            sent_len,
            motion.astype(np.float32),
            m_length,
            "_".join(tokens),
        )
