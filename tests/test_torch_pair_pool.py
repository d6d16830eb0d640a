"""The port's fused pair assembly (ops/pair_pool.py) against the JAX Pallas
kernel run in interpret mode and against its XLA reference.

Adds and maxes are the same float operations in both, so float32 must match
exactly; bfloat16 too (each sum is rounded once to bf16 before the max in
both).  The CUDA kernel itself is held against the plain version by
tests/test_torch_pair_pool_cuda.py, which runs only where there is a card."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scene_graph_commonsense_tpu.ops.pallas.pair_pool import (
    fused_pair_pool, pair_pool_reference, rearrange_pool_groups)
from scene_graph_commonsense_torch.ops import pair_pool as tpp


def _inputs(rng, m=6, s=8, c=16, p=11):
    a = rng.standard_normal((m, s, s, c)).astype(np.float32)
    b = rng.standard_normal((m, s, s, c)).astype(np.float32)
    si = rng.integers(0, m, p).astype(np.int32)
    oj = rng.integers(0, m, p).astype(np.int32)
    return a, b, si, oj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_pair_pool_plain_matches_pallas(rng, dtype):
    a, b, si, oj = _inputs(rng)
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    want_kernel = fused_pair_pool(rearrange_pool_groups(ja),
                                  rearrange_pool_groups(jb),
                                  jnp.asarray(si), jnp.asarray(oj),
                                  interpret=True)
    want_ref = pair_pool_reference(ja, jb, jnp.asarray(si), jnp.asarray(oj))
    tdt = getattr(torch, dtype)
    got = tpp.pair_pool(torch.from_numpy(a).to(tdt),
                        torch.from_numpy(b).to(tdt),
                        torch.from_numpy(si), torch.from_numpy(oj))
    assert got.dtype == tdt and got.shape == (len(si), 4, 4, a.shape[-1])
    got = got.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want_kernel, np.float32))
    np.testing.assert_array_equal(got, np.asarray(want_ref, np.float32))


def test_torch_pair_pool_cpu_call_launches_nothing(rng):
    a, b, si, oj = (torch.from_numpy(x) for x in _inputs(rng))
    before = tpp.launches
    tpp.pair_pool(a, b, si, oj)
    assert tpp.launches == before


@pytest.mark.parametrize("case", ["dtype", "odd_s", "channels", "strided",
                                  "index_dtype", "shape"])
def test_torch_pair_pool_kernel_checks_inputs(rng, case):
    good = [torch.from_numpy(x) for x in _inputs(rng)]
    tpp.check_kernel_inputs(*good)
    a, b, si, oj = good
    if case == "dtype":
        a, b = a.double(), b.double()
    elif case == "odd_s":
        a, b = a[:, :7, :7].contiguous(), b[:, :7, :7].contiguous()
    elif case == "channels":
        a, b = a[..., :6].contiguous(), b[..., :6].contiguous()
    elif case == "strided":
        a = a.permute(0, 2, 1, 3)
    elif case == "index_dtype":
        si = si.long()
    else:
        b = b[:3]
    with pytest.raises((TypeError, ValueError)):
        tpp.check_kernel_inputs(a, b, si, oj)
    # a CPU tensor is never handed to the kernel
    with pytest.raises(ValueError):
        tpp.pair_pool_kernel(*good)


def test_torch_pair_pool_imports_without_nvcc(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)          # no nvcc, no compiler
    code = ("import scene_graph_commonsense_torch.ops.pair_pool as p, "
            "scene_graph_commonsense_torch.ops._build as b; "
            "assert p.launches == 0 and not b._loaded; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=os.getcwd(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
