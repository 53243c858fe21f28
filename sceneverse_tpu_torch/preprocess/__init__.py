"""Offline scene preprocessing, the port's own copy of
``sceneverse_tpu/preprocess``: raw dataset releases -> the
scan_data/{pcd_with_global_alignment,instance_id_to_label} layout the data
layer consumes. What scales with the vertex count (nearest-vertex search,
face and box labelling, the final transform and point cap) runs as torch ops
on the processor's device; file parsing, the alignment search over boxes and
the scene graph stay on the host."""

from sceneverse_tpu_torch.preprocess.build import PROCESSOR_REGISTRY, ProcessorBase  # noqa: F401
