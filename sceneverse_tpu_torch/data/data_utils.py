"""Data utilities (reference data/data_utils.py), vectorized: the port's
own copy of ``sceneverse_tpu/data/data_utils.py``.

Per-token/per-point Python loops in the reference (random_word :76-104,
random_point_cloud :107-121, pairwise box IoU loops in base.py) are rewritten
as numpy array ops driven by an explicit np.random.Generator — deterministic
per item and orders of magnitude faster on the host.
"""

from __future__ import annotations

import csv
import random
import re

import numpy as np

from sceneverse_tpu_torch.data.datasets.constant import VALID_CLASS_IDS_200


# --------------------------------------------------------------- geometry
def convert_pc_to_box(obj_pc):
    """Axis-aligned bbox (center, size) of a point cloud
    (reference data_utils.py:63-73)."""
    mn = obj_pc[:, :3].min(axis=0)
    mx = obj_pc[:, :3].max(axis=0)
    return ((mn + mx) / 2).tolist(), (mx - mn).tolist()


def construct_bbox_corners(center, box_size):
    """8 corners of an axis-aligned box (reference :267-279)."""
    c = np.asarray(center, np.float64)
    s = np.asarray(box_size, np.float64) / 2
    signs = np.array([
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
    ], np.float64)
    return c[None] + signs * s[None]


def box3d_iou(corners1, corners2):
    """Axis-aligned 3D IoU from corner sets (reference :294-316)."""
    mn1, mx1 = corners1.min(axis=0), corners1.max(axis=0)
    mn2, mx2 = corners2.min(axis=0), corners2.max(axis=0)
    lo = np.maximum(mn1, mn2)
    hi = np.minimum(mx1, mx2)
    inter = np.prod(np.maximum(hi - lo, 0))
    vol1 = np.prod(mx1 - mn1)
    vol2 = np.prod(mx2 - mn2)
    return inter / (vol1 + vol2 - inter + 1e-8)


def eval_ref_one_sample(pred_bbox, gt_bbox):
    return box3d_iou(pred_bbox, gt_bbox)


def boxes_iou_matrix(centers1, sizes1, centers2, sizes2):
    """Vectorized all-pairs axis-aligned 3D IoU — replaces the reference's
    O(N*M) Python double loop over construct_bbox_corners+box3d_iou
    (reference base.py:359-366,406-417) with one broadcasted computation.

    Args: centers/sizes (N,3) and (M,3). Returns (N, M) IoU.
    """
    c1, s1 = np.asarray(centers1, np.float64), np.asarray(sizes1, np.float64)
    c2, s2 = np.asarray(centers2, np.float64), np.asarray(sizes2, np.float64)
    mn1, mx1 = c1 - s1 / 2, c1 + s1 / 2
    mn2, mx2 = c2 - s2 / 2, c2 + s2 / 2
    lo = np.maximum(mn1[:, None], mn2[None])
    hi = np.minimum(mx1[:, None], mx2[None])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=-1)
    vol1 = np.prod(mx1 - mn1, axis=-1)
    vol2 = np.prod(mx2 - mn2, axis=-1)
    return inter / (vol1[:, None] + vol2[None] - inter + 1e-8)


def build_rotate_mat(split, rot_aug=True, rand_angle="axis", rng=None):
    """Random z-rotation matrix (reference :163-178): axis-aligned 90-degree
    choices by default; None when no rotation applies."""
    rng = rng or np.random
    if rand_angle == "random":
        theta = rng.rand() * np.pi * 2
    else:
        theta = [0, np.pi / 2, np.pi, np.pi * 3 / 2][rng.randint(4)]
    if theta != 0 and split == "train" and rot_aug:
        return np.array([
            [np.cos(theta), -np.sin(theta), 0],
            [np.sin(theta), np.cos(theta), 0],
            [0, 0, 1],
        ], np.float32)
    return None


def transform_points(points, transform, translate=True):
    """Apply a [3,4]/[4,4] linear map to (..., 3) points (reference :319-344)."""
    const = np.ones_like(points[..., :1]) if translate else np.zeros_like(points[..., :1])
    pts = np.concatenate([points, const], axis=-1)
    return np.einsum("nm,...m->...n", transform, pts)[..., :3]


# ------------------------------------------------------------------ language
VIEW_DEP_WORDS = {
    "front", "behind", "back", "right", "left", "facing", "leftmost",
    "rightmost", "looking", "across",
}


def is_explicitly_view_dependent(tokens):
    """reference :282-291."""
    return any(t in VIEW_DEP_WORDS for t in tokens)


def random_word(tokens, tokens_mask, tokenizer, mask_ratio, rng=None):
    """BERT-style 15% / 80-10-10 token masking, vectorized
    (reference :76-104 per-token loop). Returns (masked_tokens, labels) with
    label -1 on unmasked positions."""
    rng = rng or np.random
    tokens = np.asarray(tokens)
    tokens_mask = np.asarray(tokens_mask)
    prob = rng.rand(*tokens.shape)
    pick = (prob < mask_ratio) & (tokens_mask != 0)
    sub_prob = np.where(pick, prob / max(mask_ratio, 1e-9), 1.0)
    out = tokens.copy()
    out[pick & (sub_prob < 0.8)] = tokenizer.mask_token_id
    rand_ids = rng.randint(0, tokenizer.vocab_size, size=tokens.shape)
    swap = pick & (sub_prob >= 0.8) & (sub_prob < 0.9)
    out[swap] = rand_ids[swap]
    labels = np.where(pick, tokens, -1).astype(np.int64)
    return out, labels


def random_point_cloud(pcd_mask, mask_ratio, rng=None):
    """Random semantic masking of valid objects (reference :107-121),
    vectorized. Returns a bool keep-mask."""
    rng = rng or np.random
    pcd_mask = np.asarray(pcd_mask)
    drop = rng.rand(*pcd_mask.shape) < mask_ratio
    return (pcd_mask != 0) & ~drop


class Vocabulary:
    """Caption-generation vocabulary with token↔id↔BERT-id maps
    (reference data_utils.py:371-403; reference persists via torch.save —
    here a plain .npz keeps the loader torch-free)."""

    def __init__(self, path=None):
        self.vocab = {}
        self.id_to_vocab = {}
        self.id_to_bert = {}
        if path is not None:
            blob = np.load(path, allow_pickle=True)
            self.vocab = blob["vocab"].item()
            self.id_to_vocab = blob["id_to_vocab"].item()
            self.id_to_bert = blob["id_to_bert"].item()

    def add_token(self, token, bert_id):
        if token in self.vocab:
            return
        idx = len(self.vocab)
        self.vocab[token] = idx
        self.id_to_vocab[idx] = token
        self.id_to_bert[idx] = bert_id

    def token_to_id(self, token):
        return self.vocab[token]

    def id_to_token(self, idx):
        return self.id_to_vocab[idx]

    def id_to_bert_id(self, idx):
        return self.id_to_bert[idx]

    def save_vocab(self, path):
        np.savez(path, vocab=np.asarray(self.vocab, dtype=object),
                 id_to_vocab=np.asarray(self.id_to_vocab, dtype=object),
                 id_to_bert=np.asarray(self.id_to_bert, dtype=object))

    def __len__(self):
        return len(self.vocab)


def random_caption_word(tokens, tokens_mask, tokenizer, vocab, mask_ratio, rng=None):
    """Caption-word masking for generation pretraining (reference :406-425):
    [SEP] always masks to the vocab's [EOS] label; other valid non-[CLS]
    tokens mask with ``mask_ratio`` probability, labeled with their vocab id.
    Unmasked / pad / [CLS] positions get label -1."""
    rng = rng or np.random
    tokens = np.asarray(tokens)
    tokens_mask = np.asarray(tokens_mask)
    out = tokens.copy()
    labels = np.full(tokens.shape, -1, dtype=np.int64)
    cls_id = getattr(tokenizer, "cls_token_id", 101)
    sep_id = getattr(tokenizer, "sep_token_id", 102)
    prob = rng.rand(*tokens.shape)
    for i, token in enumerate(tokens):
        if tokens_mask[i] == 0 or token == cls_id:
            continue
        if token == sep_id:
            out[i] = tokenizer.mask_token_id
            labels[i] = vocab.token_to_id("[EOS]")
        elif prob[i] < mask_ratio:
            out[i] = tokenizer.mask_token_id
            labels[i] = vocab.token_to_id(tokenizer.decode([int(token)]))
    return out, labels


def pad_array(arr, length, pad=0, dtype=None):
    """Pad axis 0 to ``length`` (reference pad_tensors :345-353)."""
    arr = np.asarray(arr)
    if dtype is not None:
        arr = arr.astype(dtype)
    if arr.shape[0] == length:
        return arr
    assert arr.shape[0] < length, (arr.shape, length)
    pad_shape = (length - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, pad, dtype=arr.dtype)], axis=0)


def merge_tokens(token1, mask1, token2, mask2, max_len=300, tokenizer=None):
    """Append token2's content into token1's padding (scene-cap + utterance,
    reference :50-60)."""
    assert len(token1) > len(token2), "not appendable"
    assert tokenizer is not None, "should pass in a tokenizer"
    token1 = np.asarray(token1).copy()
    mask1 = np.asarray(mask1).copy()
    token2 = np.asarray(token2)
    mask2 = np.asarray(mask2)
    len1 = int(mask1.sum()) - 1  # drop trailing [SEP]
    len2 = int(mask2.sum()) - 1  # drop leading [CLS]
    insert = min(max_len - len1, len2)
    token1[len1 : len1 + insert] = token2[1 : 1 + insert]
    mask1[len1 : len1 + insert] = mask2[1 : 1 + insert]
    if token1[int(mask1.sum()) - 1] != tokenizer.sep_token_id:
        token1[int(mask1.sum()) - 1] = tokenizer.sep_token_id
    return token1, mask1


def per_scene_pad(lang_list, max_len=64, tokenizer=None, max_seq_len=50):
    """Group language items by scene into chunks of ``max_len``
    (reference :12-47), optionally pre-tokenizing."""
    if tokenizer is not None and lang_list:
        for key in ["utterance", "question", "description"]:
            if key in lang_list[0]:
                texts = [item[key] for item in lang_list]
                ids, masks = tokenizer.batch_encode(texts, max_seq_len)
                lang_list = [
                    {k: ((v, ids[i], masks[i]) if k == key else v)
                     for k, v in item.items()}
                    for i, item in enumerate(lang_list)
                ]
    scene_list = {}
    for item in lang_list:
        scene_list.setdefault(item["scan_id"], []).append(item)
    final = []
    for value in scene_list.values():
        for i in range(0, len(value), max_len):
            if i + max_len < len(value):
                final.append(value[i : i + max_len])
            else:
                final.append(random.choices(value[i:], k=max_len))
    return final


def get_sqa_question_type(question):
    """reference :355-368: 0 what / 1 is / 2 how / 3 can / 4 which / 5 other."""
    q = question.lstrip().lower()
    for i, prefix in enumerate(["what", "is", "how", "can", "which"]):
        if q.startswith(prefix):
            return i
    return 5


class ScanQAAnswer:
    """reference :294-314."""

    def __init__(self, answers=None, unk_token="<unk>", ignore_idx=-100):
        answers = list(answers or [])
        self.unk_token = unk_token
        self.ignore_idx = ignore_idx
        self.vocab = {x: i for i, x in enumerate(answers)}
        self.rev_vocab = {v: k for k, v in self.vocab.items()}

    def itos(self, i):
        return self.unk_token if i == self.ignore_idx else self.rev_vocab[i]

    def stoi(self, v):
        return self.vocab.get(v, self.ignore_idx)

    def __len__(self):
        return len(self.vocab)


class SQA3DAnswer:
    """reference :317-336 ('u' is the unknown token)."""

    def __init__(self, answers=None, unk_token="u"):
        answers = list(answers or [])
        self.vocab = {x: i for i, x in enumerate(answers)}
        self.rev_vocab = {v: k for k, v in self.vocab.items()}
        self.unk_token = unk_token
        self.ignore_idx = self.vocab["u"]

    def itos(self, i):
        return self.unk_token if i == self.ignore_idx else self.rev_vocab[i]

    def stoi(self, v):
        return self.vocab.get(v, self.ignore_idx)

    def __len__(self):
        return len(self.vocab)


class LabelConverter:
    """ScanNet label-space maps from scannetv2-labels.combined.tsv
    (reference :124-161): raw/nyu40/scannet-18/scannet-200 id maps."""

    def __init__(self, file_path):
        self.raw_name_to_id = {}
        self.nyu40id_to_id = {}
        self.nyu40_name_to_id = {}
        self.scannet_name_to_scannet_id = {
            "cabinet": 0, "bed": 1, "chair": 2, "sofa": 3, "table": 4,
            "door": 5, "window": 6, "bookshelf": 7, "picture": 8, "counter": 9,
            "desk": 10, "curtain": 11, "refrigerator": 12, "shower curtain": 13,
            "toilet": 14, "sink": 15, "bathtub": 16, "others": 17,
        }
        self.id_to_scannetid = {}
        self.scannet_raw_id_to_raw_name = {}

        with open(file_path, encoding="utf-8") as fd:
            rows = list(csv.reader(fd, delimiter="\t", quotechar='"'))
        for i in range(1, len(rows)):
            raw_id = i - 1
            scannet_raw_id = int(rows[i][0])
            raw_name = rows[i][1]
            nyu40_id = int(rows[i][4])
            nyu40_name = rows[i][7]
            self.raw_name_to_id[raw_name] = raw_id
            self.scannet_raw_id_to_raw_name[scannet_raw_id] = raw_name
            self.nyu40id_to_id[nyu40_id] = raw_id
            self.nyu40_name_to_id[nyu40_name] = raw_id
            self.id_to_scannetid[raw_id] = self.scannet_name_to_scannet_id.get(
                nyu40_name, self.scannet_name_to_scannet_id["others"]
            )

        self.orgInstID_to_id = {i: i - 1 for i in range(1, 257)}
        self.orgInstID_to_id[0] = -100

        self.scannet_raw_id_to_scannet200_id = {}
        self.scannet200_id_to_scannet_raw_id = {}
        for v, k in enumerate(VALID_CLASS_IDS_200):
            self.scannet_raw_id_to_scannet200_id[k] = v
            self.scannet200_id_to_scannet_raw_id[v] = k


def load_matrix_from_txt(path, shape=(4, 4)):
    with open(path) as f:
        vals = [float(v) for v in f.read().replace("\n", " ").split()]
    return np.asarray(vals).reshape(shape)


_CLEAN_RULES = [
    (r"[ ]+$", ""), (r"^[ ]+", ""), (r" {2,}", " "),
    (r"\.[ ]{2,}", ". "), (r"[^a-zA-Z0-9,'\s\-:]+", ""),
    ("ç", "c"), ("’", "'"),
    (r"\bletf\b", "left"), (r"\blet\b", "left"), (r"\btehre\b", "there"),
    (r"\brigth\b", "right"), (r"\brght\b", "right"), (r"\bbehine\b", "behind"),
    (r"\btv\b", "TV"), (r"\bchai\b", "chair"), (r"\bwasing\b", "washing"),
    (r"\bwaslked\b", "walked"), (r"\boclock\b", "o'clock"),
    (r"\bo'[ ]+clock\b", "o'clock"),
    (r"\b0\b", "zero"), (r"\bnone\b", "zero"), (r"\b1\b", "one"),
    (r"\b2\b", "two"), (r"\b3\b", "three"), (r"\b4\b", "four"),
    (r"\b5\b", "five"), (r"\b6\b", "six"), (r"\b7\b", "seven"),
    (r"\b8\b", "eight"), (r"\b9\b", "nine"), (r"\b10\b", "ten"),
    (r"\b11\b", "eleven"), (r"\b12\b", "twelve"), (r"\b13\b", "thirteen"),
    (r"\b14\b", "fourteen"), (r"\b15\b", "fifteen"), (r"\b16\b", "sixteen"),
    (r"\b17\b", "seventeen"), (r"\b18\b", "eighteen"), (r"\b19\b", "nineteen"),
    (r"\b20\b", "twenty"), (r"\b23\b", "twenty-three"),
    (r"\b([a-zA-Z]+)([0-9])\b", r"\g<1>"),
    (r"\ba\b ([a-zA-Z]+)", r"\g<1>"), (r"\ban\b ([a-zA-Z]+)", r"\g<1>"),
    (r"\bthe\b ([a-zA-Z]+)", r"\g<1>"),
    (r"\bbackwards\b", "backward"),
]


def clean_answer(data: str) -> str:
    """Free-form answer normalizer (reference :428-485)."""
    data = data.lower()
    for pat, repl in _CLEAN_RULES:
        data = re.sub(pat, repl, data)
    return data
