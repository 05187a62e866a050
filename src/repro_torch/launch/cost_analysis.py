"""Roofline terms of one rank's call on an NVIDIA H100: the port's
counterpart of the JAX package's ``launch/hlo_analysis.py``.

The reference folds its HLO cost streams through a TPU's peaks, with a
collective term for its mesh.  Here the streams come from the ATen ops and
collectives the call runs (``op_cost``), and the peaks are one H100 SXM's,
each FLOP class over its own rate:

  dot_bf16   dense bf16 (and fp16) products on the tensor cores
  dot_f32    float32 products, outside the tensor cores (TF32 off)
  other      elementwise work, reductions and sorts, at the float32 rate

The memory term is the perfect-fusion byte floor at HBM bandwidth.  The
collective term sums, over the mesh axes, the bytes the rank's groups
along that axis carry over the axis's link (``axis_links``): NVLink
where rank 0's group lies inside one node, the network where it spans
nodes.  One card has no collective: ``t_collective`` is 0.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional

from ..obs.profile import H100_HBM_BYTES_PER_S
from .op_cost import Counts, count_call

# Peaks of one H100 SXM (NVIDIA's H100 data sheet): dense bf16 on the
# tensor cores, and float32 outside them.
H100_BF16_FLOPS_PER_S = 989e12
H100_F32_FLOPS_PER_S = 67e12
# device memory, the data sheet's 80 GB (torch reports a total_memory of
# 85,017,493,504 B on "NVIDIA H100 80GB HBM3"; the difference is left to
# the CUDA context and the allocator's rounding)
H100_MEMORY_BYTES = 80e9
# The cluster: H100 SXM nodes of 8 GPUs (a DGX H100).  Inside a node NVLink
# 4 through NVSwitch: the data sheet's 900 GB/s a GPU counts both
# directions, 450e9 B/s each way.  Between nodes one 400 Gb/s NDR
# InfiniBand NIC per GPU, as in a DGX H100 (eight ConnectX-7): 50e9 B/s.
# Ranks lie row-major over the mesh shape, 8 consecutive ranks a node, as
# torch.distributed.run numbers them node by node; so on (16, 16) both
# axes span nodes.
NODE_GPUS = 8
NVLINK_BYTES_PER_S = 450e9
NETWORK_BYTES_PER_S = 50e9
PEAK_FLOPS = {"dot_bf16": H100_BF16_FLOPS_PER_S, "dot_f32": H100_F32_FLOPS_PER_S,
              "other": H100_F32_FLOPS_PER_S}
HBM_BW = H100_HBM_BYTES_PER_S


def axis_links(shape: Dict[str, int], labels: Iterable[str]) -> Dict[str, Dict[str, object]]:
    """{label: {"ranks", "link", "bytes_per_s"}} for each group label
    (mesh axes joined by "+", ``launch.mesh.Mesh.axis_labels``) of a mesh
    of ``shape`` (axis -> size, in mesh order): rank 0's group along those
    axes, NVLink where all its ranks lie in rank 0's node, else the
    network."""
    stride, strides = 1, {}
    for a in reversed(list(shape)):
        strides[a] = stride
        stride *= shape[a]
    out = {}
    for label in labels:
        ranks = [0]
        for a in label.split("+"):
            ranks = [r + i * strides[a] for r in ranks for i in range(shape[a])]
        inside = max(ranks) < NODE_GPUS
        out[label] = {"ranks": len(ranks), "link": "nvlink" if inside else "network",
                      "bytes_per_s": NVLINK_BYTES_PER_S if inside else NETWORK_BYTES_PER_S}
    return out


@dataclasses.dataclass
class RooflineTerms:
    device_flops: float
    device_bytes: float
    device_coll_bytes: float
    flops_by_class: Dict[str, float] = dataclasses.field(default_factory=dict)
    # group label -> bytes, and its link's bytes per second
    coll_bytes_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)
    axis_bytes_per_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        """Each class over its own peak; FLOPs outside the classes at the
        float32 rate."""
        rest = self.device_flops - sum(self.flops_by_class.values())
        return (sum(f / PEAK_FLOPS[k] for k, f in self.flops_by_class.items())
                + rest / H100_F32_FLOPS_PER_S)

    @property
    def t_memory(self) -> float:
        return self.device_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        """Each axis's bytes over its link, summed (the axes' transfers
        do not overlap one another)."""
        return sum(b / self.axis_bytes_per_s[a] for a, b in self.coll_bytes_by_axis.items())

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline lower bound on the call's time (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> Dict[str, float]:
        return {
            "device_flops": self.device_flops,
            "device_bytes": self.device_bytes,
            "device_coll_bytes": self.device_coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_bound_s": self.t_bound,
            "dominant": self.dominant,
        }


def info_from_counts(c: Counts, links: Optional[Dict[str, Dict[str, object]]] = None
                     ) -> Dict[str, object]:
    """The reference's ``info`` keys (those ``benchmarks/roofline.py``
    reads) from one call's counts; ``collective_ops`` are executions per
    kind.  On a mesh (``links``: ``axis_links`` of its group labels) also
    the bytes per group label and kind, and the interconnect."""
    d = c.as_dict()
    info = {
        "flops": d["flops"],
        "flops_by_class": d["flops_by_class"],
        "bytes_accessed": d["bytes"],          # perfect-fusion floor
        "bytes_xla_convention": d["bytes_xla_convention"],
        "collective_bytes": {**d["collective_bytes"], "total": d["collective_bytes_total"]},
        "collective_op_executions": d["collective_op_executions"],
        "collective_ops": d["collective_ops"],
        "aten_ops": d["aten_ops"],
        "argument_size_in_bytes": d["argument_bytes"],
        "output_size_in_bytes": d["output_bytes"],
        "temp_size_in_bytes": d["temp_peak_bytes"],
    }
    if links is not None:
        info["collective_bytes_by_axis"] = d["collective_bytes_by_axis"]
        info["interconnect"] = {"node_gpus": NODE_GPUS, "axes": links}
    elif d["collective_op_executions"]:
        raise ValueError("collectives counted without the mesh's links")
    return info


def analyze_call(fn: Callable, *args, **kwargs) -> Dict[str, object]:
    """The counterpart of ``analyze_compiled``: ``fn(*args, **kwargs)``
    counted op by op (on meta tensors it allocates nothing)."""
    return info_from_counts(count_call(fn, *args, **kwargs))


def roofline_from_info(info: Dict[str, object]) -> RooflineTerms:
    links = info.get("interconnect", {}).get("axes", {})
    by_axis = {a: float(sum(kinds.values()))
               for a, kinds in info.get("collective_bytes_by_axis", {}).items()}
    return RooflineTerms(
        device_flops=float(info.get("flops", 0.0)),
        device_bytes=float(info.get("bytes_accessed", 0.0)),
        device_coll_bytes=float(info["collective_bytes"]["total"]),
        flops_by_class={k: float(v) for k, v in info.get("flops_by_class", {}).items()},
        coll_bytes_by_axis=by_axis,
        axis_bytes_per_s={a: float(links[a]["bytes_per_s"]) for a in by_axis},
    )
