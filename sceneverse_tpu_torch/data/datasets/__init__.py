"""Datasets of the port; importing a module registers its datasets in
``DATASET_REGISTRY`` (``dataset_wrapper`` its wrappers in
``DATASETWRAPPER_REGISTRY``). ``sceneverse_tpu_torch.data`` imports them
all."""
