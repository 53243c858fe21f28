"""Task models; importing populates MODEL_REGISTRY."""

from sceneverse_tpu_torch.model.build import (  # noqa: F401
    MODEL_REGISTRY,
    BaseModel,
    build_model,
)
from sceneverse_tpu_torch.model.openvocab import (  # noqa: F401
    OpenVocab,
    OpenVocabPerScene,
)
from sceneverse_tpu_torch.model.objcls import ObjCls  # noqa: F401
