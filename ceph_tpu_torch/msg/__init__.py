"""Async messenger: the cluster communication backend (reference src/msg/)."""

from .message import Message, register_message
from .messenger import Connection, Messenger

__all__ = ["Message", "register_message", "Messenger", "Connection"]
