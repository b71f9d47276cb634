"""The roofline over the dry run's records (the counterpart of
`repro.roofline.analyze`), priced for the NVIDIA H100.

Reads ``chiprun_out/dryrun/*.json`` (`launch.dryrun`) and derives, per
(arch x shape x mesh), from the rank's own counts (`cost.CostMode`):

  compute term    = flops_per_rank / PEAK_FLOPS                       [s]
  memory term     = hbm_bytes_per_rank / HBM_BW                       [s]
  collective term = nvlink_bytes / NVLINK_BW + ib_bytes / IB_BW       [s]

plus MODEL_FLOPS = 6 N_active D (train) or 2 N_active D (prefill /
decode), the useful-compute ratio MODEL_FLOPS / (ranks x flops_per_rank),
the estimated MFU = MODEL_FLOPS / (ranks x PEAK x max(terms)), and the
same with the attention-score traffic left out of the memory term
(``est_mfu_flash``), JAX's formulas.  JAX's `analyze_cell` reads an HLO
sidecar; this one reads the record's ``cost``, the traced step's counts.

The card (the `hopper-kernels` guide's table; NVIDIA's H100 SXM data
sheet, dense rates at the 700 W power limit): 989 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s of HBM, NVLink 450 GB/s each way between the eight
cards of a host, and between hosts one 400 Gb/s InfiniBand NDR port a card
(50 GB/s, NVIDIA's DGX H100 data sheet).  A collective whose group lies on
one host of eight ranks (`collectives.fabric`) goes by NVLink, any other
by InfiniBand.
"""

from __future__ import annotations

import glob
import json
import os

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
IB_BW = 400e9 / 8

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "chiprun_out", "dryrun")


def analyze_cell(rec: dict) -> dict:
    """One record -> its roofline row (a skip or error record: its reason)."""
    out = dict(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], status=rec["status"])
    if rec["status"] != "ok":
        out["reason"] = rec.get("reason", rec.get("error", ""))[:200]
        return out
    chips = rec.get("ranks") or (512 if rec["mesh"] == "2x16x16" else 256)
    cost = rec["cost"]
    flops, hbm = cost["flops"], cost["hbm_bytes"]
    fab = cost.get("link_by_fabric", {})
    link = cost["link_bytes"]
    t_comp = flops / PEAK_FLOPS
    t_mem = hbm / HBM_BW
    t_coll = fab.get("nvlink", 0.0) / NVLINK_BW + fab.get("ib", 0.0) / IB_BW
    t_mem_flash = max(hbm - cost.get("score_bytes", 0.0), 0.0) / HBM_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dom = max(terms, key=terms.get)
    n = rec.get("params_active") or rec.get("params_total") or 0.0
    d_tokens = rec.get("tokens_per_step", 0)
    mf = (6.0 if rec["shape"].startswith("train") else 2.0) * n * d_tokens
    total_flops = flops * chips
    step_time = max(terms.values())
    step_flash = max(t_comp, t_mem_flash, t_coll)
    mem = rec.get("memory", {})
    out.update(
        flops_per_dev=flops, hbm_per_dev=hbm, link_per_dev=link, link_by_fabric=fab,
        coll_by_kind=cost.get("coll_by_kind", {}), score_bytes=cost.get("score_bytes", 0.0),
        t_compute=t_comp, t_memory=t_mem, t_memory_flash=t_mem_flash, t_collective=t_coll,
        dominant=dom, model_flops=mf,
        useful_ratio=(mf / total_flops) if total_flops else 0.0,
        est_step_time=step_time,
        est_mfu=(mf / (chips * PEAK_FLOPS * step_time)) if step_time else 0.0,
        # attention-score traffic left out, as a fused attention would keep it
        est_mfu_flash=(mf / (chips * PEAK_FLOPS * step_flash)) if step_flash else 0.0,
        est_tokens_per_s=(d_tokens / step_flash) if step_flash else 0.0,
        mem_gib={k: (v or 0) / 2**30 for k, v in mem.items()},
        params_total=rec.get("params_total"), params_active=rec.get("params_active"),
        tokens_per_step=d_tokens, chips=chips, trace_s=rec.get("seconds_trace"),
    )
    return out


def load_all(art_dir: str | None = None) -> list[dict]:
    art_dir = art_dir or os.path.normpath(ART_DIR)
    rows = []
    for jf in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(jf) as f:
            rows.append(analyze_cell(json.load(f)))
    return rows


def fmt_time(t: float) -> str:
    return f"{t*1e3:.1f}ms" if t < 1 else f"{t:.2f}s"


def table(rows: list[dict], mesh: str = "16x16") -> str:
    """Markdown roofline table for one mesh."""
    hdr = ("| arch | shape | t_comp | t_mem | t_coll | bottleneck | "
           "MODEL_FLOPS/traced | est. MFU | arg GiB/rank | peak GiB/rank |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"{r['status']}: {r.get('reason', '')[:60]} | — | — | — | — |")
            continue
        mem = r.get("mem_gib", {})
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_time(r['t_compute'])} | "
            f"{fmt_time(r['t_memory'])} | {fmt_time(r['t_collective'])} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.3f} | {r['est_mfu']*100:.1f}% | "
            f"{mem.get('argument_bytes', 0):.2f} | {mem.get('peak_bytes', 0):.2f} |")
    return hdr + "\n".join(lines)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default=None)
    ap.add_argument("--json", default=None, help="write summary JSON here")
    args = ap.parse_args()
    rows = load_all(args.art)
    for mesh in ("16x16", "2x16x16"):
        print(f"\n## Roofline — mesh {mesh} (H100: {PEAK_FLOPS:.4g} FLOP/s bf16, "
              f"{HBM_BW:.4g} B/s HBM, NVLink {NVLINK_BW:.4g} / IB {IB_BW:.4g} B/s)\n")
        print(table(rows, mesh))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1, default=float)


if __name__ == "__main__":
    main()
