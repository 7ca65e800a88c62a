"""Roofline report generator: the dry-run's JSON cells -> markdown tables
(the port of ``repro/launch/report.py``).

    python -m repro_torch.launch.report [build/dryrun]

The cells are the dry-run's, counted on the meta device by design (no
card is touched). The reference's columns, over one H100: the collective
column reads "—" (one card moves no bytes between cards), and a column
gives each cell's peak of live bytes and whether it fits the card's
memory (else the cards that peak would fill). The cells sized on the
reference's pod and multipod meshes have a table of their own: one
device's parameter, optimizer-state and cache bytes, the bytes placed
whole on every device, whether the static bytes fit one card, its FLOPs
and wire bytes a device (``dryrun.count_mesh_cell``), its collectives by
kind, and its roofline's bound, bottleneck and MFU bound. The collective
term assumes every rank on NVLink's one-direction rate.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.launch.dryrun import MESH, POD_MESHES
from repro_torch.launch.roofline import HBM_BYTES


def load_cells(out_dir: str = "build/dryrun") -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def _fmt_t(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:.2f}s"
    return f"{seconds*1e3:.2f}ms"


def _fits(c: dict) -> str:
    peak = f"{c['peak_live_bytes'] / 1e9:.1f} GB"
    if c["fits"]:
        return f"{peak} (fits)"
    return f"{peak} ({c['cards_by_memory']} cards)"


def roofline_table(cells: list[dict], mesh: str = MESH) -> str:
    rows = ["| arch | shape | status | t_compute | t_memory | t_collective | "
            "bottleneck | useful FLOPs | MFU bound | peak live (fits) |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["mesh"] != mesh or c.get("kv_override"):
            continue
        if c["status"] == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']} | SKIP (full attn @500k) "
                        "| — | — | — | — | — | — | — |")
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | ok | {_fmt_t(r['t_compute_s'])} "
            f"| {_fmt_t(r['t_memory_s'])} | — "
            f"| {r['bottleneck']} | {r['useful_flops_ratio']:.2f} "
            f"| {r['mfu_bound']:.3f} | {_fits(c)} |")
    return "\n".join(rows)


def _gb(nbytes: int) -> str:
    return f"{nbytes / 1e9:.2f}"


def _fit(fits: bool) -> str:
    return "fits" if fits else "does not fit"


def _t_bound(r: dict) -> float:
    return max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])


def _collectives(c: dict) -> str:
    ops = c["collectives"]["ops"]
    return ", ".join(f"{k} {n}" for k, n in sorted(ops.items())) or "none"


def per_device_table(cells: list[dict]) -> str:
    rows = ["| arch | shape | mesh | params GB | opt GB | cache GB | "
            "replicated GB | static GB (fits) | FLOPs/dev | wire GB/dev | "
            "collectives | t_bound | bottleneck | MFU bound |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["mesh"] not in POD_MESHES:
            continue
        kv = f" ({c['kv_override']})" if c.get("kv_override") else ""
        if c["status"] == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']}{kv} | {c['mesh']} | "
                        "SKIP |" + " — |" * 10)
            continue
        pd, r = c["per_device"], c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']}{kv} | {c['mesh']} "
            f"| {_gb(pd['param_bytes'])} | {_gb(pd['opt_bytes'])} "
            f"| {_gb(pd['cache_bytes'])} | {_gb(pd['replicated_bytes'])} "
            f"| {_gb(pd['static_bytes'])} ({_fit(pd['fits'])}) "
            f"| {r['hlo_flops_per_dev']:.3e} "
            f"| {_gb(r['wire_bytes_per_dev'])} | {_collectives(c)} "
            f"| {_fmt_t(_t_bound(r))} "
            f"| {r['bottleneck']} | {r['mfu_bound']:.3f} |")
    return "\n".join(rows)


def dryrun_table(cells: list[dict]) -> str:
    rows = ["| arch | shape | mesh | status | trace | params | "
            "collective ops | ops | peak live (fits) |",
            "|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        kv = f" ({c['kv_override']})" if c.get("kv_override") else ""
        if c["status"] == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']}{kv} | {c['mesh']} | "
                        "SKIP | — | — | — | — | — |")
            continue
        if c["mesh"] in POD_MESHES:
            head = (f"| {c['arch']} | {c['shape']}{kv} | {c['mesh']} | "
                    f"{c['status']} |")
            params = f"{c.get('params', 0) / 1e9:.1f}B"
            peak = c["peak_live_bytes"]
            rows.append(
                f"{head} {c.get('trace_s', 0):.1f}s | {params} | "
                f"{_collectives(c)} | {c['launches']} | {peak / 1e9:.1f} GB "
                f"a device ({_fit(peak <= HBM_BYTES)}) |")
            continue
        rows.append(
            f"| {c['arch']} | {c['shape']}{kv} | {c['mesh']} | {c['status']} "
            f"| {c.get('trace_s', 0):.1f}s | {c.get('params', 0)/1e9:.1f}B "
            f"| — | {c['launches']} | {_fits(c)} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cells = load_cells(*argv[:1])
    print(f"## Roofline (one {MESH.replace('x1', '')})\n")
    print(roofline_table(cells))
    if any(c["mesh"] in POD_MESHES for c in cells):
        print("\n## Per device on the pod meshes\n")
        print(per_device_table(cells))
    print("\n## Dry-run matrix\n")
    print(dryrun_table(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
