"""CephFS-role POSIX-ish file service over RADOS.

Re-expresses the reference's file service shape (src/mds/ MDS daemon +
src/client/ libcephfs) at reduced scope: an MDS daemon owns the
namespace — directories are objects in a metadata pool whose entries
embed the child inodes (reference CDir dirfrags as omap objects with
inodes embedded in dentries) — while clients do file DATA I/O directly
against the data pool in fixed-size striped blocks (the reference's
file layout), talking to the MDS only for metadata.
"""

from .mds import MDSDaemon
from .client import CephFS, FSError

__all__ = ["MDSDaemon", "CephFS", "FSError"]
