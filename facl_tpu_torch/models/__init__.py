from facl_tpu_torch.models.layers import (BatchNorm, EmbedHead, PointMLP,
                                          l2_normalize)
from facl_tpu_torch.models.pointnet import (PointNetPlus, resolve_model,
                                            resolve_model_config)
from facl_tpu_torch.models.moco import MoCoState, init_moco_state
from facl_tpu_torch.models.probe import LinearProbe
from facl_tpu_torch.models.sa_stage import SetAbstractionStage
from facl_tpu_torch.models.slowfast import PointNetSlowFast

__all__ = ["BatchNorm", "EmbedHead", "LinearProbe", "MoCoState", "PointMLP",
           "PointNetPlus", "PointNetSlowFast", "SetAbstractionStage",
           "init_moco_state", "l2_normalize", "resolve_model",
           "resolve_model_config"]
