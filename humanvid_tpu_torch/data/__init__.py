"""Camera poses and Plücker rays, video IO, and the training data path:
datasets, the orientation batch sampler and the prefetching loader."""

from .camera import (
    Camera,
    camera_file_to_plucker,
    get_relative_pose,
    intrinsics_vector,
    load_cameras,
    ray_condition,
    static_camera,
)
from .datasets import (
    DatasetConfig,
    HumanDanceCameraImageDataset,
    HumanDanceCameraVideoDataset,
    clip_preprocess_np,
)
from .loader import Loader, collate
from .samplers import OrientationBatchSampler

__all__ = [
    "Camera",
    "camera_file_to_plucker",
    "get_relative_pose",
    "intrinsics_vector",
    "load_cameras",
    "ray_condition",
    "static_camera",
    "DatasetConfig",
    "HumanDanceCameraImageDataset",
    "HumanDanceCameraVideoDataset",
    "clip_preprocess_np",
    "Loader",
    "collate",
    "OrientationBatchSampler",
]
