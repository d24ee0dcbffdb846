from facl_tpu_torch.eval.probe import (LinearProbeTrainer, combine_streams,
                                       topk_accuracy)

__all__ = ["LinearProbeTrainer", "combine_streams", "topk_accuracy"]
