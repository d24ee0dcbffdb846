from facl_tpu_torch.losses.infonce import (circle_infonce, cross_entropy,
                                           global_local_infonce,
                                           pair_infonce)
from facl_tpu_torch.losses.sinkhorn import (shoot_infs, sinkhorn, swav_loss,
                                            swav_queue_init)
from facl_tpu_torch.losses.cld import cld_loss, cld_pair_loss, kmeans

__all__ = ["circle_infonce", "cross_entropy", "global_local_infonce",
           "pair_infonce", "shoot_infs", "sinkhorn", "swav_loss",
           "swav_queue_init", "cld_loss", "cld_pair_loss", "kmeans"]
