"""Camera poses and Plücker rays, video IO (the native libav core, else
OpenCV), the training data path (datasets, the orientation batch sampler and
the prefetching loader), and the data-preparation helpers: the skeleton
rasterizer, the meta-info builders and the dataset visualizations."""

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
from .meta_tools import (
    extract_meta,
    load_human_counts,
    merge_meta,
    save_meta,
    segment_meta,
    split_by_orientation,
)
from .native_video import VideoReader, VideoWriter
from .pose_draw import draw_pose
from .samplers import OrientationBatchSampler
from .visualization import CameraPoseVisualizer, pca_visualize, sample_composite, to_image

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
    "extract_meta",
    "load_human_counts",
    "merge_meta",
    "save_meta",
    "segment_meta",
    "split_by_orientation",
    "VideoReader",
    "VideoWriter",
    "draw_pose",
    "CameraPoseVisualizer",
    "pca_visualize",
    "sample_composite",
    "to_image",
]
