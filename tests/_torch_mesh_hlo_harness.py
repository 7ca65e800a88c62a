"""Subprocess body of ``test_torch_mesh_count.py``: the reference's serving
cells of smoke configs on a (data, model) mesh of four forced host
devices ((2, 2) or (1, 4)), compiled, each one's per-device dot FLOPs
(its analyzer's walk, dots only) and collectives (``analyze_hlo``)
printed as one JSON line. A cell is ``arch:kind:batch:seq:DxM``, with
``:H`` after it for a variant of H heads and ``:H:dtype`` for one in
another dtype than the smoke config's. The reference's dry-run sets
``XLA_FLAGS`` from ``REPRO_XLA_FLAGS`` when it is imported, so the
device count is given there.

The CPU backend widens bf16 arithmetic and collectives to f32 after the
SPMD partitioner has placed them, so each cell's collectives are also
given at the element types the partitioner gave them (``partitioned``:
the module after its ``spmd-partitioning`` pass, dumped to a temporary
directory, matched to the compiled collectives by channel id), with the
all-reduces tallied by result type (executions, loop trips included).

    REPRO_XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_mesh_hlo_harness.py arch:kind:batch:seq:2x2 ...
"""
import json
import os
import pathlib
import re
import shutil
import sys
import tempfile

DUMP = tempfile.mkdtemp(prefix="hlo_dump_")
os.environ["REPRO_XLA_FLAGS"] = (
    os.environ.get("REPRO_XLA_FLAGS", "") + f" --xla_dump_to={DUMP}"
    " --xla_dump_hlo_pass_re=^spmd-partitioning$")

import jax  # noqa: E402  (after the flags above)

from repro import configs  # noqa: E402
from repro.launch import dryrun  # noqa: E402
from repro.launch import hlo_analysis as ha  # noqa: E402
from repro.launch import sharding as shd  # noqa: E402

_TYPED = re.compile(r"^(\s*(?:ROOT )?%[\w.\-]+ = )([a-z]\w*)(\[[^\]]*\]\S* "
                    r"(?:all-reduce|all-gather|reduce-scatter|all-to-all|"
                    r"collective-permute)\(.*channel_id=(\d+).*)$")


class DotFlops(ha.HloAnalyzer):
    """The reference's analyzer counting its dots only: a fusion's FLOPs
    are its body's, without the 1-per-element charge."""

    def _instr_flops(self, comp, ins):
        if ins.op == "fusion":
            mc = ha._CALLS_RE.search(ins.rest)
            return self.flops(mc.group(1)) if mc else 0.0
        return super()._instr_flops(comp, ins)


class ByType(ha.HloAnalyzer):
    """The analyzer's collectives, its all-reduces also tallied by result
    type (executions, loop trips included)."""

    def __init__(self, text: str):
        super().__init__(text)
        self.all_reduces = {}

    def collectives(self, comp_name=None, mult=1.0, acc=None):
        comp = self.comps.get(comp_name or self.entry)
        for ins in comp.instrs if comp else ():
            if ins.op == "all-reduce":
                t = re.sub(r"\{[^}]*\}", "", ins.type_str)
                self.all_reduces[t] = self.all_reduces.get(t, 0) + mult
        return super().collectives(comp_name, mult, acc)


def partitioned(text: str, before: set) -> dict:
    """The compiled ``text``'s collectives at the element types of the
    module after SPMD partitioning (the dump not in ``before``)."""
    new = sorted(p for p in pathlib.Path(DUMP).iterdir()
                 if p.name not in before
                 and "after_spmd-partitioning" in p.name)
    types = {}
    for line in new[-1].read_text().splitlines():
        m = _TYPED.match(line)
        if m:
            types[m.group(4)] = m.group(2)
    lines = []
    for line in text.splitlines():
        m = _TYPED.match(line)
        if m and m.group(4) in types:
            line = m.group(1) + types[m.group(4)] + m.group(3)
        lines.append(line)
    walk = ByType("\n".join(lines))
    c = walk.collectives()
    return {"ops": c.collective_ops, "bytes": c.collective_bytes,
            "wire": c.wire_bytes, "all_reduces": walk.all_reduces}


def cell(spec: str) -> dict:
    arch, kind, batch, seq, shape, *variant = spec.split(":")
    cfg = configs.get_smoke_config(arch).replace(kv_pq=False)
    if variant:
        cfg = cfg.replace(n_heads=int(variant[0]))
    if len(variant) > 1:
        cfg = cfg.replace(dtype=variant[1])
    dryrun.SHAPES["cell"] = (int(seq), int(batch), kind)
    # the reference's host mesh, its axes Auto (as its sharding helpers
    # constrain them); jax.make_mesh's default is Explicit from 0.7 on
    mesh = jax.make_mesh(tuple(int(n) for n in shape.split("x")),
                         ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = dryrun.cell_rules(cfg, "cell", mesh)
    before = {p.name for p in pathlib.Path(DUMP).iterdir()}
    with shd.use_mesh(mesh, rules):
        fn, args, shardings = dryrun.build_cell(cfg, "cell", mesh, rules)
        text = jax.jit(fn, in_shardings=shardings).lower(
            *args).compile().as_text()
    dots = DotFlops(text)
    costs = ha.analyze_hlo(text)
    return {"cell": spec,
            "dot_flops": dots.flops(dots.entry),
            "ops": costs.collective_ops, "bytes": costs.collective_bytes,
            "wire": costs.wire_bytes,
            "partitioned": partitioned(text, before)}


def main() -> int:
    if len(jax.devices()) != 4:
        print("want 4 forced devices (REPRO_XLA_FLAGS="
              "--xla_force_host_platform_device_count=4)", file=sys.stderr)
        return 2
    try:
        for spec in sys.argv[1:]:
            print(json.dumps(cell(spec)))
    finally:
        shutil.rmtree(DUMP, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
