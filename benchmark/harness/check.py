"""The arithmetic of ``correct``: the numbers a mode reads from the
program's outputs against the plain reference's, and the judgement of each
against its limit (the cell's ``limits/<cell>.json``).

Training (``train_readings``), over the K steps of each of the set-up's
three dispatches (the first eager, the second captured and replayed, the
third a replay on new rows):
  * ``loss``: the largest relative gap of a step's loss (the total and each
    configured loss);
  * ``grad``: over the optimised leaves, the largest gap between the
    program's and the reference's norm of AdamW's first moment (the
    gradients as the optimizer got them), against the reference's norm of
    that leaf or of the median leaf, whichever is larger;
  * ``change``: the same for the parameters' change, leaving out the leaves
    whose reference first moment is under a thousandth of the median
    leaf's (their change is AdamW's reply to round-off); ``change_median``:
    the median leaf's gap, the number compared, as the largest swings with
    the noise of one small leaf (PERF.md gives both readings).

Evaluation (``eval_readings``), over every dispatch of set-up and window:
  * ``logit_rms``: per batch, the root mean square of the gap between the
    program's answer output (the og3d logits) and the reference's forward
    over the real entries, relative to the root mean square of the
    reference's; the largest over the batches (the worst single entry
    swings with the frozen PointNet++'s bf16 roundings at a tie, PERF.md);
  * ``answers``: the largest difference, in scenes, between a sum the
    program's evaluator returned and the same sum worked out by the
    reference's metric from the program's own answer output (exact).
"""

from __future__ import annotations

import math
import statistics

import torch


def _gap(a, b, scale):
    g = abs(a - b) / max(scale, 1e-30)
    return g if math.isfinite(g) else math.inf


def _gaps(prog: dict, ref: dict, keep=None) -> dict:
    names = [n for n in ref if keep is None or keep(n)]
    med = statistics.median(ref[n] for n in names)
    return {n: _gap(prog[n], ref[n], max(ref[n], med)) for n in names}


def _worst(gaps: dict):
    at = max(gaps, key=gaps.get)
    return gaps[at], at


@torch.no_grad()
def train_state(named: dict, init: dict, moments: dict) -> dict:
    """Per optimised leaf the norm of AdamW's first moment and of the
    change from ``init`` (host tensors), in float64: {"m_norm", "dp_norm"}."""
    m_norm, dp_norm = {}, {}
    for n, p in named.items():
        m = moments.get(n)
        m_norm[n] = (float(torch.linalg.vector_norm(m.double()))
                     if m is not None else 0.0)
        dp_norm[n] = float(torch.linalg.vector_norm(
            p.double() - init[n].to(p.device).double()))
    return {"m_norm": m_norm, "dp_norm": dp_norm}


def train_readings(prog: dict, ref: dict) -> dict:
    """{number: (value, where)} of a training snapshot ({"losses": [row],
    "m_norm", "dp_norm"}) against the reference's."""
    if len(prog["losses"]) != len(ref["losses"]):
        return {n: (math.inf, "steps logged") for n in
                ("loss", "grad", "change", "change_median")}
    loss, at = 0.0, None
    for k, (p, r) in enumerate(zip(prog["losses"], ref["losses"])):
        for n in r:
            gap = _gap(p.get(n, math.nan), r[n], abs(r[n]))
            if at is None or gap > loss:
                loss, at = gap, f"step {k} {n}"
    m_ref = ref["m_norm"]
    med = statistics.median(m_ref.values())
    grad = _gaps(prog["m_norm"], m_ref)
    change = _gaps(prog["dp_norm"], ref["dp_norm"],
                   keep=lambda n: m_ref[n] >= 1e-3 * med)
    return {"loss": (loss, at), "grad": _worst(grad), "change": _worst(change),
            "change_median": (statistics.median(change.values()),
                              "median leaf")}


def eval_readings(prog: list, ref: dict, sums_of, valid_of) -> dict:
    """{number: (value, where)} of the program's dispatches [(pool indices,
    answer output (K, ...), {metric: (value, count)})] against the
    reference's {pool index: (batch, answer output)}; ``sums_of(answer,
    batch)`` is the reference's metric of the answers, ``valid_of(batch)``
    the real entries."""
    logit, answers = (0.0, "none"), (0.0, "none")
    for d, (idx, out, sums) in enumerate(prog):
        want = {}
        for j, i in enumerate(idx):
            batch, r = ref[i]
            p = out[j].to(r.device) if j < len(out) else None
            where = f"dispatch {d} batch {i}"
            if p is None or p.shape != r.shape:
                logit = max(logit, (math.inf, where + " shape"))
                continue
            m = valid_of(batch)
            gap = (p[m].double() - r[m].double()).pow(2).mean().sqrt()
            scale = r[m].double().pow(2).mean().sqrt()
            logit = max(logit, (_gap(float(gap), 0.0, float(scale)), where))
            for n, (v, c) in sums_of(p, batch).items():
                a = want.setdefault(n, [0, 0])
                a[0], a[1] = a[0] + v, a[1] + c
        for n, (v, c) in want.items():
            got = sums.get(n)
            diff = (math.inf if got is None else
                    max(abs(got[0] - v), abs(got[1] - c)))
            answers = max(answers, (diff, f"dispatch {d} {n}"))
    return {"logit_rms": logit, "answers": answers}


def judge(got: dict, limits: dict):
    """(correct, {number: {"value", "limit", "where"}})."""
    out, ok = {}, True
    for name, limit in limits.items():
        value, where = got[name]
        ok = ok and value <= limit
        out[name] = {"value": value, "limit": limit, "where": where}
    return ok, out
