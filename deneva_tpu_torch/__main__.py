"""Run a named cell of the port and print its ``[summary]`` line.

    python -m deneva_tpu_torch --cell headline --device cuda --ticks 300
    python -m deneva_tpu_torch --cell tpcc --device cuda --compiled
    python -m deneva_tpu_torch --cell tpcc_timestamp --device cuda --compiled
    python -m deneva_tpu_torch --cell headline_mvcc --device cuda --compiled
    python -m deneva_tpu_torch --cell pps_calvin --device cuda --compiled
    python -m deneva_tpu_torch --cell tpcc_occ --device cuda --compiled
    python -m deneva_tpu_torch --cell headline_sharded4 --device cuda --compiled

Runs 20 warm-up ticks, then ``--ticks`` timed ticks, and prints the
``[summary]`` line, commits per tick, and the tick time: from CUDA events
on a GPU, from the host clock on the CPU.  ``--compiled`` runs both as
``Engine.run_compiled`` does: on a GPU as replays of CUDA graphs of the
tick, on the CPU with no host read in the tick but for OCC's fixed-point
flag.  A cell of more than one node runs on the sharded engine
(``parallel/sharded.py``), all its nodes on the one device.
"""

from __future__ import annotations

import argparse

from deneva_tpu_torch import cells
from deneva_tpu_torch.engine.scheduler import timed_run

#: ticks run before the timed window
WARMUP_TICKS = 20


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m deneva_tpu_torch")
    ap.add_argument("--cell", choices=sorted(cells.CELLS), default="entry")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--compiled", action="store_true",
                    help="run the ticks as Engine.run_compiled does")
    args = ap.parse_args(argv)

    eng = cells.engine(cells.config(args.cell), device=args.device)
    run = eng.run_compiled if args.compiled else eng.run
    state = run(WARMUP_TICKS)
    before = eng.summary(state)["txn_cnt"]
    state, per_tick = timed_run(eng, args.ticks, state,
                                compiled=args.compiled)
    commits = eng.summary(state)["txn_cnt"] - before
    clock = "cuda events" if eng.device.type == "cuda" else "host clock"
    print(eng.summary_line(state))
    print(f"cell={args.cell} device={eng.device} ticks={args.ticks} "
          f"compiled={args.compiled} "
          f"commits_per_tick={commits / max(args.ticks, 1)} "
          f"tick_ms={per_tick * 1e3} ({clock})")


if __name__ == "__main__":
    main()
