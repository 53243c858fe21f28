"""The work of one ``scanrefer_ft`` step or evaluation forward: the GPS counter
(``harness/gps_work.py``) over this configuration's model."""

from benchmark.harness.gps_work import step_work


def work(batch, config, train, device):
    return step_work(batch, config, train, device)
