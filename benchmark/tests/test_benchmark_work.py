"""The work counters against hand counts of one layer, and the trace
reader's interval arithmetic."""

import numpy as np
import pytest
import torch

from benchmark.harness import gps_work, peaks
from benchmark.harness.trace import Trace


def test_least_s_takes_the_larger_bound():
    assert peaks.least_s(3.35e12, {"bf16": 0.0}) == pytest.approx(1.0)
    assert peaks.least_s(0, {"bf16": 989e12, "3xtf32": 165e12}) == \
        pytest.approx(2.0)


def test_mha_forward_by_hand():
    # two scenes: 2 queries against 3 real keys, and 1 against 1; D = 64,
    # one head: 4 D (2 * 3 + 1 * 1) products; q, o at the 3 queries, k, v
    # at the 4 keys, the pad row and the lse at each query: f32 bytes
    D, H = 64, 1
    q, k = torch.tensor([2.0, 1.0]), torch.tensor([3.0, 1.0])
    t = gps_work.mha_least_s(q, k, D, H, train=False)
    nbytes = 4 * (2 * 3 * D + 2 * 4 * D + 3 + 3)
    want = max(nbytes / peaks.HBM_BYTES_PER_S,
               4 * D * 7 / peaks.FLOPS["3xtf32"])
    assert t == pytest.approx(want)


def test_sa_pairs_by_hand():
    # one object, 4 points: centres at the origin and far away; radius 1
    xyz = torch.tensor([[[0.0, 0, 0], [0.5, 0, 0], [0.9, 0, 0], [5.0, 0, 0]]])
    cen = torch.tensor([[[0.0, 0, 0], [9.0, 9, 9]]])
    pairs, points = gps_work._sa_pairs(xyz, cen, 1.0, ns=2)
    # centre 0 pools its first 2 in-ball points (0, 1); centre 1's ball is
    # empty and pools point 0: 3 pairs over 2 distinct points
    assert (pairs, points) == (3, 2)


def _model(**heads):
    return {"run": {"model": {
        "language": {"args": {"hidden_size": 64, "num_attention_heads": 1,
                              "num_hidden_layers": 1}},
        "vision": {"args": {"dim_feedforward": 128, "num_layers": 1}},
        "grounding": {"args": {"dim_feedforward": 128, "num_layers": 1}},
        "heads": heads, "lm_max_predictions": 4,
        "loss_list": ["lm_cls_loss", "TextObjWithinBatch"]}}}


def test_padding_is_not_counted():
    # one more padded object slot or text slot adds no work where no loss
    # reads it
    from benchmark.harness import traffic

    t = {"batch": 2, "max_objects": 4, "points": 64, "objects": [2, 2],
         "room": [4.0, 4.0, 3.0], "utterance": [5, 5], "utterance_pad": 8,
         "mlm": 0.15, "pool": 1}
    cfg = _model(head_list=["pretrain_head"],
                 pretrain_head={"args": {"vocab_size": 100}})
    b = traffic.draw_pool(t, 1, "cpu")[0]
    w = gps_work.step_work(b, cfg, True, "cpu")
    pad = {k: v for k, v in b.items()}
    pad["txt_masks"] = np.concatenate([b["txt_masks"], 0 * b["txt_masks"]], 1)
    pad["txt_ids"] = np.concatenate([b["txt_ids"], 0 * b["txt_ids"]], 1)
    pad["masked_lm_labels"] = np.concatenate(
        [b["masked_lm_labels"], -1 + 0 * b["masked_lm_labels"]], 1)
    for k in ("obj_masks", "obj_fts", "obj_locs"):
        pad[k] = np.concatenate([b[k], 0 * b[k]], 1)
    w2 = gps_work.step_work(pad, cfg, True, "cpu")
    assert w2["flops"]["3xtf32"] == pytest.approx(w["flops"]["3xtf32"])
    assert w2["mha_s"] == pytest.approx(w["mha_s"])


def test_step_work_grows_with_the_batch():
    from benchmark.harness import traffic

    t = {"batch": 2, "max_objects": 4, "points": 64, "objects": [2, 4],
         "room": [4.0, 4.0, 3.0], "utterance": [5, 8], "utterance_pad": 8,
         "mlm": 0.15, "pool": 1}
    model = _model(head_list=["pretrain_head"],
                   pretrain_head={"args": {"vocab_size": 100}})
    one = gps_work.step_work(traffic.draw_pool(t, 1, "cpu")[0], model, True,
                             "cpu")
    two = gps_work.step_work(traffic.draw_pool(dict(t, batch=4), 1, "cpu")[0],
                             model, True, "cpu")
    assert two["flops"]["3xtf32"] > one["flops"]["3xtf32"] > 0
    assert one["mha_s"] > 0 and one["sa_fwd_s"] > 0
    fwd = gps_work.step_work(traffic.draw_pool(t, 1, "cpu")[0], model, False,
                             "cpu")
    assert fwd["flops"]["3xtf32"] < one["flops"]["3xtf32"]


def test_trace_union_and_gaps(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 30, "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 40, "dur": 10},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
           "ts": 15, "dur": 25}]
    p = tmp_path / "t.json"
    p.write_text(__import__("json").dumps({"traceEvents": ev}))
    tr = Trace(p)
    assert tr.window_s == pytest.approx(50e-6)
    assert tr.union_s(tr.kernels()) == pytest.approx(25e-6)
    assert tr.busy_s() == pytest.approx(30e-6)
    assert tr.idle_gaps() == [["cudaStreamSynchronize", pytest.approx(25e-6)]]
    assert tr.top_ops()[0] == ["a", pytest.approx(20e-6)]
