from .pose2img import Pose2ImageOutput, Pose2ImagePipeline
from .pose2vid import Pose2VideoOutput, Pose2VideoPipeline
from .system import CamAnimate, CamAnimateConfig, tiny_config

__all__ = ["CamAnimate", "CamAnimateConfig", "Pose2ImageOutput", "Pose2ImagePipeline",
           "Pose2VideoOutput", "Pose2VideoPipeline", "tiny_config"]
