"""One run of one cell of the port's benchmark:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for `--seconds`, judges what the window produced
against the plain reference, and prints the result as the last line of
standard output (`harness.report`). Needs as many CUDA cards as the cell
asks for; without them it exits 3 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# torch's own kernel cache (NVRTC-built elementwise kernels) stays in the checkout
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                      os.path.join(HERE, "_cache", "torch_kernels"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    entry = harness.cell_entry(harness.benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr, flush=True)
        return harness.NO_DEVICE_EXIT
    run = harness.Run(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), STARTED)
    result, checks = harness.execute(run)
    found = harness.loaded_forbidden()
    if found:
        print(f"modules of {found} were loaded in this process", file=sys.stderr,
              flush=True)
        return 1
    harness.report(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
