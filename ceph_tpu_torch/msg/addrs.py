"""Monitor address plumbing shared by every mon client (OSD daemons,
Objecter, CLIs) — the monmap-list normalization the reference keeps in
MonMap/MonClient (src/mon/MonMap.h)."""

from __future__ import annotations


def normalize_mon_addrs(mon_addr) -> list[tuple[str, int]]:
    """Accept one ("host", port) pair or an iterable of them; return
    the monmap as a list of tuples (rank order preserved)."""
    if (isinstance(mon_addr, (tuple, list)) and len(mon_addr) == 2
            and isinstance(mon_addr[0], str)):
        return [tuple(mon_addr)]
    return [tuple(a) for a in mon_addr]
