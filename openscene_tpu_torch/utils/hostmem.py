"""Host allocator tuning for hosts with slow demand paging.

A copy of ``openscene_tpu/utils/hostmem.py``.  Where first-touch page faults
are slow, glibc's default mmap threshold makes every large NumPy temporary a
fresh cold mapping, so batch assembly waits on page faults rather than
arithmetic.  Raising M_MMAP_THRESHOLD keeps freed large blocks on the heap
(mapped and warm) for reuse, at the price of a higher retained RSS.
"""

from __future__ import annotations

import ctypes

_done = False
_M_MMAP_THRESHOLD = -3  # glibc mallopt parameter id


def warm_malloc(threshold: int = 1 << 30) -> bool:
    """Route large allocations through the heap free-list (warm pages).

    Idempotent; returns True when the mallopt call succeeded (glibc only;
    a no-op elsewhere)."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, threshold))
        _done = ok
        return ok
    except OSError:  # non-glibc platform
        return False
