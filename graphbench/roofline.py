"""The frontier step's bytes from its work, and the H100's peak.

The step (``repro_torch.kernels.fused_frontier``, one launch an evaluator
loop) expands each selected, active binding along every adjacency entry
of its frontier vertex.  Its work, whatever the layout that holds it:

  per adjacency entry   the entry's six 4-byte fields (destination,
                        edge label, direction, destination label, value
                        and global id), the destination's g2l row and
                        owner (4 bytes each), and its output written once:
                        the new binding row (``q_pad`` int32), its step,
                        destination id and owner (int32 each) and four
                        1-byte flags (ok, done, keep, out)
  per active binding    its row (``q_pad`` int32), step and local index
                        (int32), its selection index (int64) and flag
                        (1 byte), and its next frontier vertex's g2l and
                        owner (4 bytes each)
  per lane and launch   the lane's plan (``s_pad`` steps of eight int32
                        and one float32) and its three int32 scalars

Entries are counted by degree (the vertex's real adjacency entries), not
by the padded ELL width W, so a layout or kernel that skips padding is
measured against the same work.  Each byte is read or written once.  The
kernel does integer compares and no floating-point work to speak of, so
its bound is bytes over the HBM bandwidth.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth at the card's 700 W
# limit.  A card set below 700 W (nvidia-smi power.limit, printed with
# every run) may not reach it.
HBM_BYTES_PER_S = 3.35e12
PEAK_SOURCE = "NVIDIA H100 SXM5 data sheet, 3.35 TB/s HBM3 at 700 W"


def entry_bytes(q_pad: int) -> int:
    return 6 * 4 + 2 * 4 + (4 * q_pad + 3 * 4 + 4)


def binding_bytes(q_pad: int) -> int:
    return 4 * q_pad + 4 + 4 + 8 + 1 + 2 * 4


def lane_bytes(s_pad: int) -> int:
    return s_pad * (8 * 4 + 4) + 3 * 4


def step_bytes(entries: int, bindings: int, lanes: int, q_pad: int,
               s_pad: int) -> int:
    """Bytes of one or more launches that together expanded ``entries``
    adjacency entries from ``bindings`` active bindings over ``lanes``
    lane-launches (a launch of L lanes counts L)."""
    return (int(entries) * entry_bytes(q_pad) + int(bindings) * binding_bytes(q_pad)
            + int(lanes) * lane_bytes(s_pad))


def bound_s(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes``."""
    return float(nbytes) / HBM_BYTES_PER_S
