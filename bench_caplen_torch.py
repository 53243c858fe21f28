"""Scene-caption token lengths of a SceneVerse-format tree, through the
port's tokenizer.

The port's counterpart of ``bench_caplen.py``: the production pretrain
config pads the scene caption to ``max_scene_cap_len: 300`` (the tokenized
text is ``scene_cap + " " + utterance``, the reference's
dataset_wrapper.py:48-54), so the device tensor is (B, 300) whatever the
real lengths. This measures the length distribution of a data root: how
much of the 300 is padding.

No SceneVerse release is in the repository, so with no ``--root`` this
measures a fixture the port's ``data/fixture.py`` writes to a temporary
directory (format-faithful, short captions by construction). Host work
only; the line carries the record of the card it ran beside.

    python3 bench_caplen_torch.py [--root DIR] [--max-len 300] [--device cpu]

Prints one JSON line: p50, p90, p95, max, n, truncated_pct, max_len,
source. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def measure(root: str, max_len: int = 300) -> dict:
    import numpy as np

    from sceneverse_tpu_torch.data.tokenizer import get_tokenizer

    tok = get_tokenizer()
    caps_file = os.path.join(root, "annotations/scene_cap.json")
    anno_file = os.path.join(root, "annotations/anno.json")
    with open(caps_file) as f:
        caps = json.load(f)
    utterances = {}
    if os.path.exists(anno_file):
        with open(anno_file) as f:
            for a in json.load(f):
                utterances.setdefault(a["scan_id"], []).append(a["utterance"])
    lengths = []
    for scan_id, entry in caps.items():
        cap_list = entry["captions"] if isinstance(entry, dict) else entry
        for cap in cap_list:
            for utt in utterances.get(scan_id, [""]):
                text = (cap + " " + utt) if utt else cap
                _, mask = tok.encode(text, max_len)
                lengths.append(int(mask.sum()))
    arr = np.asarray(lengths)
    return {
        "metric": "scene_cap_token_length",
        "p50": int(np.percentile(arr, 50)),
        "p90": int(np.percentile(arr, 90)),
        "p95": int(np.percentile(arr, 95)),
        "max": int(arr.max()),
        "n": int(arr.size),
        "truncated_pct": round(float((arr >= max_len).mean() * 100), 2),
        "max_len": max_len,
        "source": root,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=None,
                   help="SceneVerse-format data root (default: the "
                        "synthetic fixture in a temporary directory)")
    p.add_argument("--max-len", type=int, default=300)
    p.add_argument("--device", default=None,
                   help="cpu, or a CUDA device (default: the card)")
    args = p.parse_args(argv)

    from sceneverse_tpu_torch.utils.benchtools import emit, resolve_device

    device = resolve_device(args.device)
    if args.root is not None:
        emit(measure(args.root, args.max_len), device)
        return
    from sceneverse_tpu_torch.data.fixture import write_synthetic_tree

    with tempfile.TemporaryDirectory(prefix="svtorch_caplen_") as tmp:
        write_synthetic_tree(tmp)
        out = measure(tmp, args.max_len)
    emit({**out, "source": "fixture (data/fixture.py defaults)"}, device)


if __name__ == "__main__":
    main()
