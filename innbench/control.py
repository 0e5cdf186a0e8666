"""The readings that a cell's limits are set from, on the card, in one process.

    python3 innbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3] [--out chiprun_out/control.json]

For each of ``--seeds``: a run of the cell with a short window at its own
load, and the comparison of its sampled outputs with the fp32 reference
(the lower readings: the program as the configuration states it).  For each
of ``--control-seeds``: the same inputs and sample taken through the
reference computed one precision below the configuration's bf16 (fp8, e4m3
with a scale per tensor) in the program's place (the upper readings: a
comparison that must fail it).  Both are read as the run reads them: the
gap to the fp32 reference over that of the bf16-rounded reference.  Prints one JSON line per seed and writes
them all to ``--out``.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import sys
import time

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from innbench import harness, traffic as T

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(ROOT, args.workload)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    with torch.no_grad():
        for seed in seeds:
            t = time.perf_counter()
            line = harness.Run(cell, seed, args.seconds, False, log=log).run()
            emit({"kind": "program", "seed": seed, "correct": line["correct"],
                  "attempted": line["attempted"], "failed": line["failed"],
                  "checks": {k: v["value"] for k, v in line["checks"].items()},
                  "seconds": time.perf_counter() - t})
        for seed in cseeds:
            t = time.perf_counter()
            run = harness.Run(cell, seed, args.seconds, False, log=log)
            try:
                if cell.traffic["kind"] == "frames":
                    inputs = T.make_frames(cell.traffic, seed, run.device)
                    k = cell.traffic["sample"]
                    win = harness.Window(samples=[(i, None) for i in range(k)])
                else:
                    inputs = T.write_dir(cell.traffic, seed, osp.join(run.work, "in"), run.device)
                    win = harness.Window(passes=1)
                run.checkpoint()
                items = run.sample_items(win, inputs, read_outputs=False)
                pairs = [(rgb, mode) for rgb, _, mode, _ in items]
                want = run.reference_outputs(pairs)
                scale = run.reference_outputs(pairs, precision="bf16")
                low = run.reference_outputs(pairs, precision="fp8")
            finally:
                shutil.rmtree(run.work, ignore_errors=True)
            per = [run.compare(g, w, s) for g, w, s in zip(low, want, scale)]
            emit({"kind": "control_fp8", "seed": seed,
                  "checks": {n: max(p[n] for p in per) for n in cell.limits},
                  "rmse_u8": max(p["rmse_u8"] for p in per),
                  "seconds": time.perf_counter() - t})
            del inputs
    if args.out:
        os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows,
                       "card": harness.smi("name,power.limit")}, f, indent=1)
    prog = [r["checks"] for r in rows if r["kind"] == "program"]
    ctrl = [r["checks"] for r in rows if r["kind"] == "control_fp8"]
    for name in cell.limits:
        lo = max((c[name] for c in prog), default=None)
        hi = min((c[name] for c in ctrl), default=None)
        log(f"[readings] {name}: lower (program, max over {len(prog)}) {lo}; "
            f"upper (control, min over {len(ctrl)}) {hi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
