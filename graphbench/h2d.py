"""The partition loads' bytes over the host link, and the link's peak.

A load copies one partition's bundle from page-locked host memory to the
card (``repro_torch.core.store``): a cold ``store.load`` on the current
stream, a ``store.prefetch`` on the store's side stream.  Both spans
carry the bundle's ``nbytes``; a warm or prefetched ``store.load`` copies
nothing.  The profiler names each of these copies ``Memcpy HtoD (Pinned
-> Device)``; the evaluator's own small inputs go from pageable memory
and are left out.

The H100's host link is PCIe 5.0 x16: 32 GT/s on each of 16 lanes, 64
GB/s each way (``PEAK_BYTES_S``).
"""
from __future__ import annotations

from typing import List, Optional

from graphbench.spans import in_window
from graphbench.tracing import union_intervals

PEAK_BYTES_S = 64e9


def is_pinned_h2d(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy htod") and "pinned" in low


def copied_bytes(ctx) -> Optional[int]:
    """Bytes the window's partition loads copied: the ``nbytes`` of its
    cold ``store.load`` and its ``store.prefetch`` spans; None where the
    program records neither."""
    spans = [sp for sp in in_window(ctx, "store.load") if sp.attrs.get("tier") == "cold"]
    spans += in_window(ctx, "store.prefetch")
    got = [sp.attrs["nbytes"] for sp in spans if "nbytes" in sp.attrs]
    return int(sum(got)) if got else None


def copy_intervals(sl: dict) -> List[List[int]]:
    """The union of the slice's pinned host-to-device copies, in profiler
    nanoseconds, clipped to the slice."""
    return union_intervals([ev for ev in sl["events"] if is_pinned_h2d(ev[0])],
                           sl["t0_ns"], sl["t1_ns"])


def bound_s(nbytes: int) -> float:
    """The least time ``nbytes`` take over the link."""
    return nbytes / PEAK_BYTES_S
