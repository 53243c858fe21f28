from sceneverse_tpu_torch.evaluator import (  # noqa: F401
    objcls_eval, pretrain_eval, referit3d_eval, scanqa_eval, scanrefer_eval,
    sqa3d_eval)
from sceneverse_tpu_torch.evaluator.build import build_eval  # noqa: F401
