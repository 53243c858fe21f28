"""Dataset families of the port; importing a module registers its
datasets in ``DATASET_REGISTRY``."""
