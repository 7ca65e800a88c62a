"""Subprocess body of ``test_torch_mesh_count.py``: the reference's serving
cells of smoke configs on a (data, model) mesh of four forced host
devices ((2, 2) or (1, 4)), compiled, each one's per-device dot FLOPs
(its analyzer's walk, dots only) and collectives (``analyze_hlo``)
printed as one JSON line. A cell is ``arch:kind:batch:seq:DxM``, with
``:H`` after it for a variant of H heads. The reference's dry-run sets
``XLA_FLAGS`` from ``REPRO_XLA_FLAGS`` when it is imported, so the
device count is given there.

    REPRO_XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_mesh_hlo_harness.py arch:kind:batch:seq:2x2 ...
"""
import json
import sys

import jax

from repro import configs
from repro.launch import dryrun
from repro.launch import hlo_analysis as ha
from repro.launch import sharding as shd


class DotFlops(ha.HloAnalyzer):
    """The reference's analyzer counting its dots only: a fusion's FLOPs
    are its body's, without the 1-per-element charge."""

    def _instr_flops(self, comp, ins):
        if ins.op == "fusion":
            mc = ha._CALLS_RE.search(ins.rest)
            return self.flops(mc.group(1)) if mc else 0.0
        return super()._instr_flops(comp, ins)


def cell(spec: str) -> dict:
    arch, kind, batch, seq, shape, *heads = spec.split(":")
    cfg = configs.get_smoke_config(arch).replace(kv_pq=False)
    if heads:
        cfg = cfg.replace(n_heads=int(heads[0]))
    dryrun.SHAPES["cell"] = (int(seq), int(batch), kind)
    # the reference's host mesh, its axes Auto (as its sharding helpers
    # constrain them); jax.make_mesh's default is Explicit from 0.7 on
    mesh = jax.make_mesh(tuple(int(n) for n in shape.split("x")),
                         ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = dryrun.cell_rules(cfg, "cell", mesh)
    with shd.use_mesh(mesh, rules):
        fn, args, shardings = dryrun.build_cell(cfg, "cell", mesh, rules)
        text = jax.jit(fn, in_shardings=shardings).lower(
            *args).compile().as_text()
    dots = DotFlops(text)
    costs = ha.analyze_hlo(text)
    return {"cell": spec,
            "dot_flops": dots.flops(dots.entry),
            "ops": costs.collective_ops, "bytes": costs.collective_bytes,
            "wire": costs.wire_bytes}


def main() -> int:
    if len(jax.devices()) != 4:
        print("want 4 forced devices (REPRO_XLA_FLAGS="
              "--xla_force_host_platform_device_count=4)", file=sys.stderr)
        return 2
    for spec in sys.argv[1:]:
        print(json.dumps(cell(spec)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
