"""Pose extraction (DWPose): the data-preparation path's networks.

- ``yolox``: the YOLOX-L person detector, its letterbox, NMS and box filter
- ``rtmpose``: the DWPose wholebody SimCC network, its crop and decode
- ``detector``: ``DWposeDetector`` (detect -> pose -> OpenPose dict and
  canvas) and ``load_detector`` (``.pth`` or ``.onnx`` weights)
- ``onnx_reader``: ONNX initializers without the onnx package
- ``smplx``: UE synthetic SMPL-X 2D keypoints -> the same canvases
"""

from .detector import DWposeDetector, load_detector, to_draw_format, wholebody_to_openpose

__all__ = [
    "DWposeDetector",
    "load_detector",
    "to_draw_format",
    "wholebody_to_openpose",
]
