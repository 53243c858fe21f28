"""The GPS pretrain configuration and a seeded GPS batch for the port's
tools (``bench_*_torch.py``): the port's own copy of the JAX package's
``_gps_cfg`` / ``_gps_batch`` (``__graft_entry__.py``). The same arguments
give the same configuration and the same arrays: the numbers drawn from
``np.random.RandomState(seed)`` in the same order.

One difference: integer arrays stay numpy's int64, the index type of the
port's data pipeline; the JAX helper hands them to ``jnp.asarray``, which
keeps int32 while JAX runs without 64-bit types. Their values are equal.
"""

from __future__ import annotations

import numpy as np

from sceneverse_tpu_torch.config import Config


def gps_cfg(hidden=768, layers=4, num_obj=80, num_points=1024, seq_len=50,
            batch=4, vocab=30522, use_scene_cap=True, heads=12) -> Config:
    """``OpenVocab`` at GPS widths: the frozen PointNet++, spatial 'cond'
    vision transformer, BERT towers, ``UnifiedSpatialCrossEncoderV2`` and
    ``OVPretrainHead``. ``num_obj``, ``num_points``, ``seq_len`` and
    ``batch`` shape the batch, not the model, and are not read (as in the
    JAX helper). ``heads`` (12, the JAX helper's fixed count) lets a test
    build widths that 12 does not divide."""
    return Config({
        "num_gpu": 1,
        "task": "Pretrain",
        "data": {"args": {"use_scene_cap": use_scene_cap}},
        "solver": {
            "lr": 5e-4, "grad_norm": 5.0,
            "optim": {"name": "AdamW", "args": {"betas": [0.9, 0.98]}},
            "sched": {"name": "warmup_cosine",
                      "args": {"warmup_steps": 500, "minimum_ratio": 0.1}},
        },
        "model": {
            "name": "OpenVocab",
            "inter": "before",
            "lm_max_predictions": 16,
            "split_scene_cap_tower": True,
            "language": {"name": "BERTLanguageEncoder", "lr": 1e-5,
                         "args": {"hidden_size": hidden,
                                  "num_hidden_layers": layers,
                                  "num_attention_heads": heads}},
            "vision": {"name": "PointOpenVocabEncoder", "lr": 1e-4,
                       "args": {"hidden_size": hidden, "freeze": True,
                                "num_attention_heads": heads,
                                "num_layers": layers,
                                "dim_feedforward": 2048, "spatial_dim": 5,
                                "dim_loc": 6, "attn_type": "spatial",
                                "pairwise_rel_type": "center"}},
            "grounding": {"name": "UnifiedSpatialCrossEncoderV2", "lr": 1e-4,
                          "args": {"hidden_size": hidden,
                                   "num_attention_heads": heads,
                                   "num_layers": layers,
                                   "dim_feedforward": 2048, "dim_loc": 6}},
            "heads": {"head_list": ["pretrain_head"],
                      "pretrain_head": {"name": "OVPretrainHead",
                                        "args": {"hidden_size": hidden,
                                                 "vocab_size": vocab}}},
            "loss_list": ["lm_cls_loss", "TextObjWithinBatch",
                          "TextSceneBetweenBatch"],
            "vis_loss_list": ["lm_cls_loss", "TextObjWithinBatch",
                              "TextSceneBetweenBatch"],
        },
    })


def gps_batch(batch, num_obj, num_points, seq_len, vocab=30522, cap_len=64,
              use_scene_cap=True, seed=0) -> dict:
    """A (batch, num_obj, num_points, 6) GPS batch of numpy arrays: random
    ids, 15% masked-LM labels, standard-normal points and locations, every
    object real, one caption of ``cap_len`` tokens a scene."""
    rng = np.random.RandomState(seed)
    B, O, P, L = batch, num_obj, num_points, seq_len
    out = {
        "txt_ids": rng.randint(0, vocab, (B, L)),
        "txt_masks": np.ones((B, L), np.int64),
        "masked_lm_labels": np.where(rng.rand(B, L) < 0.15,
                                     rng.randint(0, vocab, (B, L)), -1),
        "obj_fts": rng.randn(B, O, P, 6).astype(np.float32),
        "obj_locs": rng.randn(B, O, 6).astype(np.float32),
        "obj_masks": np.ones((B, O), bool),
        "obj_sem_masks": np.ones((B, O), np.int64),
        "obj_labels": rng.randint(0, 607, (B, O)),
        "tgt_object_id": rng.randint(0, O, (B, 1)),
    }
    if use_scene_cap:
        out["scene_txt_ids"] = rng.randint(0, vocab, (B, cap_len))
        out["scene_txt_masks"] = np.ones((B, cap_len), np.int64)
    return out
