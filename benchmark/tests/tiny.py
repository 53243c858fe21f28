"""A cell at a size a CPU holds, for the tests: the configuration's widths
and the traffic's shapes cut, everything else as configured."""

from __future__ import annotations


def shrink(cell, hidden=128, heads=2, layers=1, batch=2, objects=(3, 6),
           points=64):
    m = cell.config["run"]["model"]
    for tower in ("language", "vision", "grounding"):
        a = m[tower]["args"]
        a["hidden_size"] = hidden
        a["num_attention_heads"] = heads
        if "num_hidden_layers" in a:
            a["num_hidden_layers"] = layers
        if "num_layers" in a:
            a["num_layers"] = layers
        if "dim_feedforward" in a:
            a["dim_feedforward"] = 2 * hidden
    for h in m["heads"]["head_list"]:
        args = m["heads"][h]["args"]
        for k in ("hidden_size", "input_size"):
            if k in args:
                args[k] = hidden
    t = cell.traffic
    t.update(batch=batch, max_objects=objects[1], objects=list(objects),
             points=points, utterance=[5, 10], utterance_pad=10)
    if t.get("caption"):
        t.update(caption=[8, 16], caption_pad=16)
    d = cell.config["run"]["data"]["args"]
    d.update(max_obj_len=objects[1], num_points=points, max_seq_len=10,
             max_scene_cap_len=16)
    cell.config["run"]["dataloader"]["batchsize"] = batch
