"""List the collectives of a depth-``units`` probe of one cell, largest first,
with their shapes, groups and origin (the port of
``repro.launch.inspect_colls``).

Usage: PYTHONPATH=src python -m repro_torch.launch.inspect_colls ARCH SHAPE [--units 1]
           [--top 25] [--multi-pod] [--seq-shard]

The probe is the dry run's (``launch.dryrun.probe``: the config cut
to ``units`` depth units, one microbatch), traced as rank 0 of the fake
world. Each row is one call as ``core.distributed.CollectiveCounter(record=
True)`` records it: the bytes the rank hands the collective, the op, the
input's shape and dtype, the group's size, and the origin, the innermost
frame of the port that made the call (the port's stand-in for HLO's
``op_name``).
"""
from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import (
    cfg_with_depth_units,
    fake_world,
    make_mesh,
    trace_cell,
    world_of,
)
from repro_torch.models import get_config


def probe_collectives(arch: str, shape: str, units: int = 1, multi_pod: bool = False,
                      seq_shard: bool = False, mesh_shape=None, cfg=None):
    """The per-call records of the probe's collectives, in call order."""
    cfg = cfg_with_depth_units(cfg if cfg is not None else get_config(arch), units)
    with fake_world(world_of(multi_pod, mesh_shape)):
        mesh = make_mesh(multi_pod, mesh_shape)
        tracer = trace_cell(arch, shape, mesh, cfg_override=cfg, force_single_microbatch=True,
                            seq_shard=seq_shard)[0]
        return tracer.collectives


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    args = ap.parse_args(argv)

    rows = probe_collectives(args.arch, args.shape, args.units, args.multi_pod, args.seq_shard)
    rows = sorted(rows, key=lambda r: -r["input_bytes"])
    total = sum(r["input_bytes"] for r in rows)
    print(f"{len(rows)} collectives, total input bytes {total / 1e9:.2f} GB")
    for r in rows[: args.top]:
        ty = f"{r['dtype']}{r['shape']}"
        print(f"{r['input_bytes'] / 1e9:9.3f}GB {r['op']:24s} n={r['group_size']:<4d} "
              f"{ty[:60]:62s} {r['origin']}")


if __name__ == "__main__":
    main()
