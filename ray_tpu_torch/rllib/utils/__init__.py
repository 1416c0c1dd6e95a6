from . import replay_buffers

__all__ = ["replay_buffers"]
