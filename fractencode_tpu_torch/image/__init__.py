from .io import load_planes, load_gray, save_plane, save_yuv
from .yuv import rgb_to_yuv420, yuv420_to_rgb

__all__ = [
    "load_planes",
    "load_gray",
    "save_plane",
    "save_yuv",
    "rgb_to_yuv420",
    "yuv420_to_rgb",
]
