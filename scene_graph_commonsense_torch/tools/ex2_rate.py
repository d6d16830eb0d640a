"""Measures the card's sustained rate of ex2.approx.ftz.f32, the
exponential of the bf16 attention kernel (csrc/attention.cu), whose count
sets that kernel's bound and floor:

    python -m scene_graph_commonsense_torch.tools.ex2_rate

Builds tools/ex2_rate.cu with the kernels' nvcc flags into _build/tools/,
launches 8 blocks of 256 threads per SM, 16 independent ex2 chains a thread,
and takes the CUDA-event mean over 3 launches after 2 warm-ups.  Prints one
JSON line (exponentials per second, and per clock per SM at the card's
maximum SM clock), then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from scene_graph_commonsense_torch import bench
from scene_graph_commonsense_torch.ops import _build

SRC = Path(__file__).resolve().parent / "ex2_rate.cu"
CHAINS, THREADS, ITERS = 16, 256, 4096


def build():
    lib = _build.BUILD_DIR / "tools" / "libex2_rate.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(SRC)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).sgc_ex2_rate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ex2_rate needs an NVIDIA GPU")
    fn = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 8 * sms
    out = torch.empty(blocks * THREADS, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _build.check_launch("ex2 rate",
                            fn(out.data_ptr(), blocks, ITERS, stream))
    for _ in range(2):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        run()
    end.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / 3 * 1e-3
    rate = blocks * THREADS * CHAINS * ITERS / seconds
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    print(json.dumps({"ex2_per_s": rate, "max_sm_clock_mhz": max_mhz,
                      "ex2_per_clock_per_sm_at_max_clock":
                      rate / sms / (max_mhz * 1e6)}), flush=True)
    print(bench.card_name(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
