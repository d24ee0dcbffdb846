from facl_tpu_torch.data.ntu import (TRAIN_CAMERAS, TRAIN_IDS_60,
                                     TRAIN_IDS_120, TRAIN_SETUPS, VideoInfo,
                                     parse_name, split_videos,
                                     validation_split)
from facl_tpu_torch.data.crops import (ClipSources, make_crops,
                                       make_crops_batch, make_simclr_crops,
                                       random_augment)
from facl_tpu_torch.data.dataset import CropLoader, NTUPointDataset
from facl_tpu_torch.data.pku_mmd import PKUMMDFeatures, parse_pku_name
from facl_tpu_torch.data.synthetic import (synthetic_depth_clip,
                                           write_synthetic_dataset)

__all__ = ["TRAIN_CAMERAS", "TRAIN_IDS_60", "TRAIN_IDS_120", "TRAIN_SETUPS",
           "VideoInfo", "parse_name", "split_videos", "validation_split",
           "ClipSources", "make_crops", "make_crops_batch",
           "make_simclr_crops", "random_augment", "CropLoader",
           "NTUPointDataset", "PKUMMDFeatures", "parse_pku_name",
           "synthetic_depth_clip", "write_synthetic_dataset"]
