"""Module library; importing it populates the four module registries."""

from sceneverse_tpu_torch.modules import build  # noqa: F401
from sceneverse_tpu_torch.modules.grounding import unified_encoder  # noqa: F401
from sceneverse_tpu_torch.modules.heads import (  # noqa: F401
    grounding_head, pretrain_head, qa_head)
from sceneverse_tpu_torch.modules.language import bert, clip  # noqa: F401
from sceneverse_tpu_torch.modules.vision import (  # noqa: F401
    obj_cls_encoder, pcd_openvocab_encoder)
