"""The benchmark of innfer_tpu_torch on one NVIDIA GPU.

    python3 innbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell named in ``BENCHMARK.json`` on the card: makes its inputs
and weights from the seed, loads and warms up (``setup_s``), measures for
``--seconds``, compares a sample of what the window produced with the plain
reference, and prints one JSON line last on standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` the
per-layer metrics and ``breakdown``, and ``checks`` last: each number
compared with its limit, also the last lines on standard error).  Exits 1
with no result where there is no card or too few, where a file is missing,
or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import os.path as osp  # noqa: E402
import sys  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout (the program builds
    # its own CUDA libraries into innfer_tpu_torch/build/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = osp.join(ROOT, "innbench_cache", sub)
    sys.path.insert(0, ROOT)

    def fail(msg: str) -> int:
        print(f"innbench: {msg}", file=sys.stderr, flush=True)
        return 1

    import torch

    from innbench import harness

    try:
        cell = harness.load_cell(ROOT, args.workload)
    except (harness.CellError, OSError, KeyError, IndexError, ValueError) as e:
        return fail(f"cannot load the cell {args.workload!r}: {e!r}")
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.workload["chips"]:
        return fail(f"{cell.name} needs {cell.workload['chips']} cards, "
                    f"{torch.cuda.device_count()} visible")
    try:
        import innfer_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program is not in this checkout: {e}")
    t_imported = time.perf_counter()
    harness.init_card()
    t_cuda = time.perf_counter()
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    log(f"[run] {cell.name} seed {args.seed} seconds {args.seconds} trace {args.trace}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; {harness.smi('name,power.limit')}")
    log(f"[start] imports {t_imported - T_START:.3f} s, CUDA context {t_cuda - t_imported:.3f} s")
    with torch.no_grad():
        line = harness.Run(cell, args.seed, args.seconds, bool(args.trace), t0=T_START,
                           log=log).run()
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"the run loaded {bad}: the benchmark measures the port alone")
    log(f"correct {line['correct']}")
    for name, c in line["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    # Python's bytecode is cached inside the checkout like the kernels: the
    # first run compiles the imported modules' sources (torch's too, where
    # the installation holds none and the environment forbids writing it),
    # later runs load the bytecode
    sys.dont_write_bytecode = False
    sys.pycache_prefix = osp.join(ROOT, "innbench_cache", "pyc")
    sys.exit(main())
