"""Faults planted in the program under a run (``run.run(fault=...)``, or
by name, ``--fault benchmark.tests.faults:<name>``, for the ranks of a
cell of several chips): each breaks the timed path underneath, and the
check has to come out not correct."""


def frozen_state(trainer):
    """A step that returns its state unchanged."""
    trainer.optimizer.step = lambda: False


def _halve(batch):
    n = batch["txt_ids"].shape[0]
    return {k: v[:n // 2] if hasattr(v, "shape") and len(v.shape) and
            v.shape[0] == n else v for k, v in batch.items()}


def half_batch(trainer):
    """Half of every batch left out, the mean taken over the rest."""
    inner = trainer.train_forward_backward

    def step(batch, metrics_fn=None):
        return inner(_halve(batch), metrics_fn)

    trainer.train_forward_backward = step


def half_eval_batch(trainer):
    """Half of every evaluation batch left out of the forward and sums."""
    inner = trainer.eval_metrics_k

    def dispatch(data_dicts, metrics_fn):
        return inner([_halve(d) for d in data_dicts], metrics_fn)

    trainer.eval_metrics_k = dispatch


def altered_answer(trainer):
    """One answer altered where it is produced: the first scene's og3d
    prediction moved to another object."""
    inner = trainer.forward

    def forward(batch):
        out = dict(inner(batch))
        lg = out["og3d_logits"].clone()
        lg[0, (lg[0].argmax() + 1) % lg.shape[1]] = 1e4
        out["og3d_logits"] = lg
        return out

    trainer.forward = forward


def altered_sum(trainer):
    """One answer's count altered where the evaluator sums it."""
    ev = trainer._val_evaluator()
    ev = ev[0] if isinstance(ev, list) else ev
    inner = ev.batch_metrics

    def batch_metrics(d, include_count=False):
        out = dict(inner(d, include_count=include_count))
        v, c = out["og_acc"]
        out["og_acc"] = (v + 1, c)
        return out

    ev.batch_metrics = batch_metrics


def no_exchange(trainer):
    """The exchange between chips left out: no sum over the ranks."""
    from sceneverse_tpu_torch.parallel import mesh

    mesh.all_reduce_flat = lambda *a, **kw: None
    mesh.all_reduce_sum = lambda x, axis="dp": x


FAULTS = {"train": [frozen_state, half_batch],
          "eval": [half_eval_batch, altered_answer, altered_sum]}
