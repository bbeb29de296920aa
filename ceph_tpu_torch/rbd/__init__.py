"""RBD: block device images over RADOS (reference src/librbd/)."""

from .journal import ImageReplayer, Journal
from .image import RBD, Image

__all__ = ["RBD", "Image", "Journal", "ImageReplayer"]
