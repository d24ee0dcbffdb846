"""Offline 3DV generation (counterpart of facl_tpu/datagen): depth clips
-> the raw, key and appearance point sets that pretraining reads."""
from facl_tpu_torch.datagen.depth import backproject, locate_motion, \
    mask_depth
from facl_tpu_torch.datagen.voxelize import (denoise, rank_coefficients,
                                             rank_pool, scatter_occupancy,
                                             voxel_indices)
from facl_tpu_torch.datagen.pointize import (appearance_frame,
                                             apply_normalization,
                                             compact_nonzero,
                                             normalization_stats,
                                             voxels_to_points)
from facl_tpu_torch.datagen.pipeline import (ClipGenerator, generate_clip,
                                             generate_clips,
                                             generate_dataset,
                                             generator_randint,
                                             load_png_frames)

__all__ = ["backproject", "locate_motion", "mask_depth", "denoise",
           "rank_coefficients", "rank_pool", "scatter_occupancy",
           "voxel_indices", "appearance_frame", "apply_normalization",
           "compact_nonzero", "normalization_stats", "voxels_to_points",
           "ClipGenerator", "generate_clip", "generate_clips",
           "generate_dataset", "generator_randint", "load_png_frames"]
