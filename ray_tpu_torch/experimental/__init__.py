from .channel import Channel

__all__ = ["Channel"]
