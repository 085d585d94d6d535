"""Command line of the port.

    python -m chandy_lamport_tpu_torch storm [flags]   the storm bench
                                                       (bench.py)
    python -m chandy_lamport_tpu_torch test [--device cpu]
                                                       the 7 reference goldens
                                                       (DenseSim, megatick 8)
"""

import argparse
import sys

import torch

from chandy_lamport_tpu_torch.api import run_reference_tests
from chandy_lamport_tpu_torch.bench import main as storm_main
from chandy_lamport_tpu_torch.parallel.batch import resolve_device


def golden_test(argv) -> int:
    """Run the 7 goldens, print PASS/FAIL per case, the count and the
    device that ran them; exit 1 on any mismatch (the JAX package's
    ``test --backend jax``)."""
    p = argparse.ArgumentParser(prog="python -m chandy_lamport_tpu_torch "
                                     "test")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    results = run_reference_tests(device)
    for name, _, why in results:
        print(f"PASS {name}" if why is None else f"FAIL {name}: {why}")
    failures = sum(why is not None for _, _, why in results)
    print(f"{len(results) - failures}/{len(results)} passed")
    print("device: " + (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else device.type))
    return 1 if failures else 0


COMMANDS = {"storm": storm_main, "test": golden_test}

if __name__ == "__main__":
    args = sys.argv[1:]
    if not args or args[0] not in COMMANDS:
        sys.exit("usage: python -m chandy_lamport_tpu_torch {storm,test} "
                 "[flags] (see <command> --help)")
    sys.exit(COMMANDS[args[0]](args[1:]))
