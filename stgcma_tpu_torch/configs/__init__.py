from .model_configs import ClipConfig, clip_b16, clip_l14, clip_tiny_test

__all__ = ["ClipConfig", "clip_b16", "clip_l14", "clip_tiny_test"]
