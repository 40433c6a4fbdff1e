"""Host settings of a benchmark process, made before anything large is
allocated.

``steady_allocator`` fixes glibc's mmap and trim thresholds (mallopt):
with the defaults, the 3 MB host image that a frame reads back is, in
some runs and not others, mapped fresh and faulted in page by page each
frame (~3 ms a frame on the card's host), so the same cell ran in two
states ~25% apart.  With fixed thresholds the host memory is reused.
Nothing else of the work changes.
"""

from __future__ import annotations

import ctypes

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3
MMAP_THRESHOLD = 256 << 20
TRIM_THRESHOLD = 1 << 30


def steady_allocator() -> bool:
    """Set the thresholds; False where the C library has no mallopt."""
    libc = ctypes.CDLL(None)
    if not hasattr(libc, "mallopt"):
        return False
    libc.mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
    libc.mallopt.restype = ctypes.c_int
    return bool(libc.mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD)
                and libc.mallopt(M_TRIM_THRESHOLD, TRIM_THRESHOLD))
