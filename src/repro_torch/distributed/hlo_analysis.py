"""Collective accounting and the three-term roofline (the port of the
reference's ``repro/distributed/hlo_analysis.py``, its dry-run half).

The reference reads its collectives out of the compiled per-device HLO.
The port has no HLO: its collectives are calls of
``distributed/collectives.py``, which records each one as it is issued
when asked (``collectives.recording``: the op, the mesh axis, the
group's size and ranks, and the payload as the reference defines it,
the per-device output).  ``parse_collectives`` turns those records into
the reference's ``Collective`` entries, with its ring factors: 2 (n-1)/n
of the payload on the wire for an all-reduce, (n-1)/n for an
all-gather, a reduce-scatter or an all-to-all, and a group of one rank
moving nothing.  ``crosses_pod`` is the card's counterpart of the
reference's pod boundary: a group whose ranks span more than one
``per_node``-GPU NVLink node (rank // per_node), whose bytes go over the
network instead of NVLink.  ``collective_summary`` is the reference's,
keys and its "ideal" rule included.

Hardware model (one NVIDIA H100 SXM5 80 GB, per GPU), for ``roofline``:

  ``PEAK_FLOPS`` 989e12  dense bf16 tensor-core FLOP/s (NVIDIA H100
                         datasheet, SXM5; 1979 is the 2:4-sparse figure)
  ``HBM_BW``     3.35e12 B/s of HBM3 (the same datasheet)
  ``LINK_BW``    450e9 B/s: one direction of NVLink 4's 900 GB/s a GPU
                 (18 links of 50 GB/s, both directions counted)
  ``DCI_BW``     50e9 B/s: one 400 Gb/s NDR InfiniBand NIC a GPU (the
                 DGX H100's eight ConnectX-7 ports), between nodes

These are the card's published peaks, not a measurement: a bound
computed with them is a model of the step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
DCI_BW = 50e9
PER_NODE = 8


@dataclasses.dataclass
class Collective:
    op: str
    payload_bytes: int     # per-device output payload
    wire_bytes: int        # ring-model bytes on the wire per device
    group_size: int
    crosses_pod: bool      # here: the group spans more than one node


def parse_collectives(records: Iterable, per_node: int = PER_NODE
                      ) -> List[Collective]:
    """The reference's ``Collective`` list of recorded collectives
    (``collectives.Issued``, in the order issued), a group of one rank
    left out, as the reference leaves it out."""
    out: List[Collective] = []
    for r in records:
        n = r.size
        if n <= 1:
            continue
        f = (n - 1) / n
        payload = r.payload_bytes
        wire = int(2 * f * payload) if r.op == "all-reduce" else int(
            f * payload)
        crosses = len({q // per_node for q in r.ranks}) > 1
        out.append(Collective(r.op, payload, wire, n, crosses))
    return out


def collective_summary(colls: List[Collective]) -> Dict:
    by_op: Dict[str, Dict] = {}
    for c in colls:
        d = by_op.setdefault(c.op, {"count": 0, "wire_bytes": 0})
        d["count"] += 1
        d["wire_bytes"] += c.wire_bytes
    total = sum(c.wire_bytes for c in colls)
    dci = sum(c.wire_bytes for c in colls if c.crosses_pod)
    # the reference's rule: an all-reduce above 64 MiB counted at a
    # reduce-scatter's cost (half the wire), the lowering it expects
    ideal = total - sum(c.wire_bytes // 2 for c in colls
                        if c.op == "all-reduce" and c.payload_bytes > 2 ** 26)
    return {"by_op": by_op, "total_wire_bytes": total,
            "ideal_wire_bytes": ideal,
            "dci_wire_bytes": dci, "n_collectives": len(colls)}


def roofline(flops_per_dev: float, hbm_bytes_per_dev: float,
             coll: Dict, model_flops_global: float = 0.0,
             n_chips: int = 256, *, peak: float = PEAK_FLOPS,
             hbm: float = HBM_BW, link: float = LINK_BW,
             dci: float = DCI_BW) -> Dict:
    """Three-term roofline (seconds, per step, per device): the
    reference's formula, with the H100's constants by default."""
    t_compute = flops_per_dev / peak
    t_memory = hbm_bytes_per_dev / hbm
    local = coll["total_wire_bytes"] - coll["dci_wire_bytes"]
    t_coll = local / link + coll["dci_wire_bytes"] / dci
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    t_coll_ideal = ((coll.get("ideal_wire_bytes", local)
                     - coll["dci_wire_bytes"]) / link
                    + coll["dci_wire_bytes"] / dci)
    dom = max(terms, key=terms.get)
    total = max(terms.values())
    out = dict(terms)
    out["collective_ideal_s"] = t_coll_ideal
    out["dominant"] = dom
    out["bound_step_time_s"] = total
    if model_flops_global:
        out["model_flops_global"] = model_flops_global
        out["useful_flops_frac"] = (
            model_flops_global / n_chips) / max(1.0, flops_per_dev)
        out["mfu_bound"] = (model_flops_global / n_chips / total) / peak
    return out
