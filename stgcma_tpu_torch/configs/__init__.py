from .model_configs import (AVSHeadConfig, ClipConfig, SwinConfig, clip_b16, clip_l14,
                            clip_tiny_test, swin_base, swin_large, swin_tiny_test)

__all__ = ["AVSHeadConfig", "ClipConfig", "SwinConfig", "clip_b16", "clip_l14",
           "clip_tiny_test", "swin_base", "swin_large", "swin_tiny_test"]
