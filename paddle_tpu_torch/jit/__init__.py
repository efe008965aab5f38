from .decode_step import ChunkPrefillStep, ServeDecodeStep

__all__ = ["ChunkPrefillStep", "ServeDecodeStep"]
