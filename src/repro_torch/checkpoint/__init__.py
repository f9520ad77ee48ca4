"""Pytree and episode checkpoints in ``repro``'s msgpack format, without
msgpack (``io``)."""
from .io import restore_episode, restore_pytree, save_episode, save_pytree

__all__ = ["save_pytree", "restore_pytree", "save_episode", "restore_episode"]
