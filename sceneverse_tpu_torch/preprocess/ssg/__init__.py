"""Scene-graph generation (SSG), the port's own copy of
``sceneverse_tpu/preprocess/ssg`` — reference preprocess/ssg: builds a
per-scene object graph (support / embedded / hanging / proximity / aligned / middle
relations) from processed scans and emits relationships.json + objects.json,
which feed the ssg_ref_* / ssg_caption_* language files consumed by the data
layer (reference data/datasets/base.py:183-198)."""

from sceneverse_tpu_torch.preprocess.ssg.ssg_main import build_scene_graph, generate_ssg  # noqa: F401
