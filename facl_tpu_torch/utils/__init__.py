from facl_tpu_torch.utils.logging import AverageMeter, setup_logging
from facl_tpu_torch.utils.profiling import StepTimer, trace

__all__ = ["AverageMeter", "setup_logging", "StepTimer", "trace"]
