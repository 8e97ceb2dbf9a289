"""Print how far the port's optical-flow comb is from the JAX package's, on
the CPU -- the measured figures behind the flow-mode budgets of
tests/test_torch_optflow.py and tests/test_torch_comb.py.

    JAX_PLATFORMS=cpu python tests/torch_flow_report.py

Not a test (pytest does not collect it); it reuses the tests' inputs:
the textured pair of test_torch_optflow.py, and the noise-varied bars and
the textured frames of test_torch_comb.py, each dim-3 flow comb run across
two windows.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (CPU platform, x64 as in the tests)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_comb as TCB  # noqa: E402
import test_torch_optflow as TOF  # noqa: E402
from ld_decode_tpu.comb import optflow as JO  # noqa: E402
from ld_decode_tpu_torch.comb import optflow as TO  # noqa: E402
from test_comb import tbc_frames  # noqa: E402


def flow_pair():
    a, b = TOF.pair.__wrapped__()
    flow0 = np.random.default_rng(4).normal(0, 0.5, a.shape + (2,)).astype(
        np.float32)
    with jax.enable_x64(False):
        want = np.asarray(JO._farneback_jit(
            jnp.asarray(b), jnp.asarray(a), jnp.asarray(flow0), 0.5, 2, 60,
            3, 7, 1.5, True))
    got = TO.farneback(torch.from_numpy(b)[None], torch.from_numpy(a)[None],
                       torch.from_numpy(flow0)[None], 0.5, 2, 60, 3, 7, 1.5,
                       True)[0].numpy()
    d = np.abs(got - want)
    print(f'textured pair, whole flow: |d| p99 {np.percentile(d, 99):.3e} '
          f'max {d.max():.3e} px')


def comb(name, frames):
    windows = [frames[:4], frames[4:]]
    _, want, _ = TCB._run_jax(TCB.JC.CombConfig(dim=3), windows)
    _, got, _ = TCB._run_port(TCB.TC.CombConfig(dim=3), windows)
    for k, (g, w) in enumerate(zip(got, want)):
        d = TCB._lsb(g, w)
        print(f'{name}, emission {k}: |d| > 2 LSB on {(d > 2).mean():.5f} '
              f'of values, p99.9 {np.percentile(d, 99.9):.0f} max '
              f'{d.max()} LSB')


if __name__ == '__main__':
    torch.set_num_threads(4)
    flow_pair()
    base = tbc_frames.__wrapped__()
    comb('noise-varied bars', TCB.frames6.__wrapped__(base))
    comb('textured', TCB.textured.__wrapped__(base))
