"""The plain reference of ``gps_pretrain``: the GPS model of
``reference/gps.py`` with the pretrain head and its three losses, clip and
AdamW; no evaluation forward (its cells train)."""

from benchmark.reference import gps


def weights(config, seed, device):
    return gps.make_weights(gps.param_spec(config["run"]["model"]), seed,
                            device)


def optimised(config):
    run = config["run"]
    return list(gps.optimised(gps.param_spec(run["model"]), run))


def train(W, batches, config, seed, device, tf32=False, world=1):
    """(per-step losses, {leaf: AdamW first moment}) of one step a batch."""
    rows, opt = gps.train_steps(W, batches, config["run"], seed, device,
                                tf32=tf32, world=world)
    return rows, opt.m
