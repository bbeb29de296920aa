"""Authentication: keyring, cephx-role tickets, connection authorizers.

Re-expresses the slice of reference src/auth/ the cluster needs:
shared-secret entities in a keyring (KeyRing.cc), mon-issued session
tickets (CephxProtocol.cc ticket blobs), per-connection authorizers
verified at accept time (AuthAuthorizeHandler), and AES-GCM secure
frame mode (msg/async/crypto_onwire.cc).
"""

from .keyring import Keyring
from .cephx import (AuthError, CephxAuth, decode_ticket, issue_ticket,
                    sign)

__all__ = ["Keyring", "CephxAuth", "AuthError", "issue_ticket",
           "decode_ticket", "sign"]
