"""Data pipeline of the port. Importing populates the DATASET and
DATASETWRAPPER registries (the synthetic dataset, the 14 scan families and
the wrappers)."""

from sceneverse_tpu_torch.data.build import (  # noqa: F401
    DATASET_REGISTRY,
    build_dataloader,
    get_dataset,
)
from sceneverse_tpu_torch.data.datasets import synthetic as _synthetic  # noqa: F401
from sceneverse_tpu_torch.data.datasets import families as _families  # noqa: F401
from sceneverse_tpu_torch.data.datasets import dataset_wrapper as _wrappers  # noqa: F401
