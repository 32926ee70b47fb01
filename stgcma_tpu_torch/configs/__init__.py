from .model_configs import (AVQAHeadConfig, AVSHeadConfig, ClipConfig, SwinConfig, clip_b16,
                            clip_l14, clip_tiny_test, swin_base, swin_large, swin_tiny_test)

__all__ = ["AVQAHeadConfig", "AVSHeadConfig", "ClipConfig", "SwinConfig", "clip_b16", "clip_l14",
           "clip_tiny_test", "swin_base", "swin_large", "swin_tiny_test"]
