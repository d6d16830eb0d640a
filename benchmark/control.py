"""The readings that the limits of `correct` are set from, at a cell's own
size, many seeds in one process.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13
    python3 -m benchmark.control --workload <cell> --seeds 11,12 --program

For each seed it prints one JSON line with the numbers that the cell's
check compares (benchmark/check.py).  With --program they are the
program's: the cell's driver runs with a window of --seconds (default 2)
and checks what it produced, as a run of the benchmark does.  Without it
they are read off what stands in the program's place, against the
reference in float32 (the driver module's control_readings):

  control   the reference itself with every convolution's and matrix
            product's operands rounded through float8 e4m3 (per-tensor
            scale), the step below the configuration's bfloat16;
  half      (train cells) the reference on the first half of each batch's
            images, the mean taken over them: half of the batch left out.

A parameter state left unchanged reads 1 by the train cells' change measure
and needs no run.  The benchmark's own runs never run this; the limits in
benchmark/limits/ lie between the program's readings and these.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import harness


def readings(conf, traffic, seed, device):
    return harness.driver(traffic["mode"]).control_readings(
        conf, traffic, seed, device)


def program_readings(conf, traffic, seed, device, seconds: float):
    from benchmark.run import Ctx
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    ctx = Ctx(conf, traffic, 1, seed, seconds, 0, device)
    out = harness.driver(traffic["mode"]).run(ctx)
    # the reference turned TF32 off; the next seed's program runs as a
    # fresh process would
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags
    return {"program": out["numbers"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--program", action="store_true")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = harness.cell(args.workload)
    if not torch.cuda.is_available():
        print("the readings are taken on a card", file=sys.stderr)
        return 2
    conf = harness.config(cell["config"])
    traffic = harness.traffic(cell["traffic"])
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = (program_readings(conf, traffic, seed, dev, args.seconds)
               if args.program else readings(conf, traffic, seed, dev))
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
