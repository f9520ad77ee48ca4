"""The dry-run's tables and summary from the per-pair JSON that
``launch.dryrun`` writes — the port of ``repro``'s ``analysis.report``,
printing the same tables from the same rows.

    PYTHONPATH=src python -m repro_torch.analysis.report experiments/dryrun_torch
"""
from __future__ import annotations

import glob
import json
import os
import sys
from collections import defaultdict


def load(dirname: str):
    rows = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def fmt_bytes(b):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def roofline_table(rows, mesh="16x16"):
    out = ["| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | dominant "
           "| MODEL_FLOPs | useful | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        note = ""
        if r["shape"] == "long_500k":
            note = "windowed/SSM decode"
        elif r["shape"].startswith("decode"):
            note = "decode: flops-useful n/a"
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['t_compute']:.4g} | "
            f"{rf['t_memory']:.4g} | {rf['t_collective']:.4g} | "
            f"{rf['dominant']} | {rf['model_flops_global']:.3g} | "
            f"{rf['useful_ratio']:.3f} | {note} |")
    return "\n".join(out)


def dryrun_table(rows):
    out = ["| arch | shape | mesh | compile (s) | args/dev | temp/dev | "
           "flops/dev | coll bytes/dev | top collectives |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        ma = r.get("memory_analysis", {})
        rf = r["roofline"]
        colls = sorted(((k, v) for k, v in r["collectives"].items()
                        if v.get("bytes", 0) > 0),
                       key=lambda kv: -kv[1]["bytes"])[:2]
        cs = "; ".join(f"{k}x{int(v['count'])}={fmt_bytes(v['bytes'])}"
                       for k, v in colls) or "none"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('compile_s', 0):.1f} | "
            f"{fmt_bytes(ma.get('argument_size_in_bytes', 0))} | "
            f"{fmt_bytes(ma.get('temp_size_in_bytes', 0))} | "
            f"{rf['flops_per_device']:.3g} | "
            f"{fmt_bytes(rf['coll_bytes_per_device'])} | {cs} |")
    return "\n".join(out)


def summary(rows):
    n = len(rows)
    meshes = defaultdict(int)
    dominants = defaultdict(int)
    for r in rows:
        meshes[r["mesh"]] += 1
        dominants[r["roofline"]["dominant"]] += 1
    return (f"{n} pair-runs compiled OK "
            f"({dict(meshes)}); dominant terms: {dict(dominants)}")


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    rows = load(d)
    print("## Summary\n")
    print(summary(rows))
    print("\n## §Roofline (single pod, 16x16 = 256 chips)\n")
    print(roofline_table(rows, "16x16"))
    print("\n## §Dry-run detail (both meshes)\n")
    print(dryrun_table(rows))


if __name__ == "__main__":
    main()
