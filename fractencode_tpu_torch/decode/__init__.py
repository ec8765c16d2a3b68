from .decoder import decode_plane, decode_batch_stacked, decode_steps_py

__all__ = ["decode_plane", "decode_batch_stacked", "decode_steps_py"]
