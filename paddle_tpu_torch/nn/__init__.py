from .clip import ClipGradByGlobalNorm

__all__ = ["ClipGradByGlobalNorm"]
