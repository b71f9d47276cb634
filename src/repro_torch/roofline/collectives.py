"""The collectives of a traced step, priced by the ring model (the
counterpart of `repro.roofline.hlo_parse`, which reads them out of
partitioned HLO text).

The port has no HLO.  `sharding.comm` reports each collective it issues to
the active cost recorders (`cost.CostMode`) with the bytes of its result
and the ranks of its group, so a record is the issuing rank's own.  The
per-op link-traffic model is JAX's (ring algorithms; n the group's size):

  all-reduce         2 * bytes(result) * (n-1)/n   (reduce-scatter + all-gather)
  all-gather         bytes(result) * (n-1)/n
  reduce-scatter     bytes(result) * (n-1)         (input = result * n)
  all-to-all         bytes(result) * (n-1)/n
  collective-permute bytes(result)
  collective-broadcast bytes(result)       (each rank receives it once)

Each op also names the fabric it crosses: ``"nvlink"`` when every rank of
its group lies on one host of `RANKS_PER_HOST` ranks (an H100 host's eight
cards, ranks numbered host by host), else ``"ib"``.
"""

from __future__ import annotations

from collections import defaultdict

RANKS_PER_HOST = 8
FABRICS = ("nvlink", "ib")


def traffic(kind: str, result_bytes: float, n: int) -> float:
    """Link bytes a rank sends for one collective of `kind` over `n` ranks."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return float(result_bytes) * (n - 1)
    return float(result_bytes)  # collective-permute, collective-broadcast


def fabric(ranks) -> str:
    """``"nvlink"`` if `ranks` lie on one host, else ``"ib"``."""
    return "nvlink" if len({r // RANKS_PER_HOST for r in ranks}) <= 1 else "ib"


def parse_collectives(records) -> dict:
    """`records`: (kind, result bytes, group ranks) a collective, in issue
    order -> ``{"per_op", "bytes_by_kind", "link_bytes", "link_by_fabric",
    "count"}``; ``link_bytes`` is the modelled link traffic of the rank.
    Groups of one rank move nothing and are left out, as JAX's are."""
    per_op = []
    bytes_by_kind: dict[str, float] = defaultdict(float)
    by_fabric = dict.fromkeys(FABRICS, 0.0)
    link = 0.0
    for kind, b, ranks in records:
        n = len(ranks)
        if n <= 1:
            continue
        t = traffic(kind, b, n)
        fab = fabric(ranks)
        per_op.append({"kind": kind, "result_bytes": b, "group": n, "fabric": fab,
                       "link_bytes": t})
        bytes_by_kind[kind] += t
        by_fabric[fab] += t
        link += t
    return {"per_op": per_op, "bytes_by_kind": dict(bytes_by_kind), "link_bytes": link,
            "link_by_fabric": by_fabric, "count": len(per_op)}


def top_collectives(parsed: dict, n: int = 10) -> list[dict]:
    return sorted(parsed["per_op"], key=lambda o: -o["link_bytes"])[:n]
